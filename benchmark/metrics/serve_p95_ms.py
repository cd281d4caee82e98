"""The 95th percentile, over every request of the window, of the
milliseconds from sending a request to holding its answers on the host
(``icemix_b_d32.serve``)."""

from harness import readers


def read(rec):
    return readers.p95_ms(rec, "serve")
