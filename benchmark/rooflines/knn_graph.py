"""Row 1, the kNN graph: about 10 fp32 operations a valid pair of pulses
(12 with a time column), the coordinates, mask and neighbour lists read
or written once for the valid rows (``chip_smoke.py``'s ``knn_bound``,
:1332)."""

from harness.roofline import knn_flops, least, valid_rows


def least_seconds(call, peaks) -> float:
    B, L, D = call.shapes[0]
    k = call.scalar(2, 1.0)
    n = valid_rows(call)
    nbytes = float(n.sum()) * (D * 4 + 1 + k * (4 + 1))
    return least([(knn_flops(n, D), peaks["fp32"])], nbytes, peaks)
