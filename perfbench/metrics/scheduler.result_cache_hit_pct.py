"""scheduler.result_cache_hit_pct: the scheduler's result cache, hits over
lookups in the window, in percent (the program's counters)."""


def read(run):
    hits = run.delta("result_cache_hits")
    total = hits + run.delta("result_cache_misses")
    return 100.0 * hits / total if total else None
