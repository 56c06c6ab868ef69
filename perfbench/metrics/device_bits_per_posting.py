"""device_bits_per_posting: the device memory the served index holds once
warm (``torch.cuda.memory_allocated`` after the warm-up less before the
server was made), in bits per posting of the corpus."""


def read(run):
    if run.index_bytes <= 0:
        return None
    return 8.0 * run.index_bytes / run.postings
