"""device.idle_pct: share of the traced window in which no kernel, copy
or fill ran on the device, in percent (``torch.profiler``)."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
