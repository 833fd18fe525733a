"""Peak device memory allocated during the window (the resident index plus
the working set), from ``torch.cuda.max_memory_allocated`` reset at the
window's start, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
