"""kernels.device_ms_per_query: device time of the program's own CUDA
kernels (their ``__global__`` names in ``src/repro_torch/csrc``) in the
traced span, per query completed in it."""


def read(run):
    if run.trace is None or not run.traced or run.trace["kernel_s"] <= 0:
        return None
    return 1e3 * run.trace["kernel_s"] / len(run.traced)
