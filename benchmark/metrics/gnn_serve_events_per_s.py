"""As ``serve_events_per_s``, for the GNN's reprocessing cell, which the
host paces (``queso_energy.serve``)."""

from harness import readers


def read(rec):
    return readers.events_per_s(rec, "serve")
