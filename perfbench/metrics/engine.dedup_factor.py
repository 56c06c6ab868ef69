"""engine.dedup_factor: probe lanes the queries asked for over the unique
lanes left after the engine's cross-query dedup, in the window."""


def read(run):
    unique = run.delta("unique_lanes")
    return run.delta("real_lanes") / unique if unique else None
