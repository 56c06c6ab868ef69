"""query.pages_skipped_pct: ranked queries' block-max pages skipped over
pages considered in the window, in percent (the program's counters)."""


def read(run):
    skipped = run.delta("pages_skipped")
    total = skipped + run.delta("pages_scored")
    return 100.0 * skipped / total if total else None
