"""Host milliseconds inside the DataLoader's ``next()`` a batch, over the
window (fetch, collate and padding on the host); training cells only."""

from harness import readers


def read(rec):
    return readers.loader_ms(rec)
