"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
after a reset at its start), in 1e9 bytes."""

from harness import readers


def read(rec):
    return readers.peak_gb(rec, "train")
