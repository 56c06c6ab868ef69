"""query.ticks_per_query: scheduler ticks between a query's submit and its
completion (its serial rounds), averaged over the window's queries; a
result-cache hit completes in none."""


def read(run):
    if not run.window:
        return None
    return sum(d.ticks for d in run.window) / len(run.window)
