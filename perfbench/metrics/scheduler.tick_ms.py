"""scheduler.tick_ms: mean wall time of one ``QueryScheduler.tick`` in the
window (the harness's span around each call)."""


def read(run):
    if not run.tick_s:
        return None
    return 1e3 * sum(run.tick_s) / len(run.tick_s)
