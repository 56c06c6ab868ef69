"""kernels.launches_per_query: launches of the program's kernels
(``repro_torch.kernels.LAUNCHES``) in the window, per query completed."""


def read(run):
    n = run.launches()
    return n / len(run.window) if run.window and n else None
