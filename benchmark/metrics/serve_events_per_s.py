"""Events answered on the host a second over the window, host clock
(``icemix_b_d32.serve``)."""

from harness import readers


def read(rec):
    return readers.events_per_s(rec, "serve")
