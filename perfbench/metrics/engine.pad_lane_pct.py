"""engine.pad_lane_pct: padding lanes over lanes dispatched to the
device in the window, in percent."""


def read(run):
    total = run.delta("dispatched_lanes")
    return 100.0 * run.delta("pad_lanes") / total if total else None
