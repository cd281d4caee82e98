"""As ``serve_p95_ms``, for ``queso_energy.serve``."""

from harness import readers


def read(rec):
    return readers.p95_ms(rec, "serve")
