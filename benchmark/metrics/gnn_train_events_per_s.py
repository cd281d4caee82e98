"""As ``train_events_per_s``, for the GNN's training cell, whose host share
makes its runs spread more (``queso_energy.train``)."""

from harness import readers


def read(rec):
    return readers.events_per_s(rec, "train")
