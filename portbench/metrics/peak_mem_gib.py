"""GiB of device memory the window held at its peak
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    return run.peak_window_bytes / 2**30
