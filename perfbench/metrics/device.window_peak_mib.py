"""device.window_peak_mib: ``torch.cuda.max_memory_allocated`` over the
window, the peak reset at its start, in MiB."""


def read(run):
    return run.window_peak_bytes / 2**20 if run.window_peak_bytes else None
