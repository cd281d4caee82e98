"""Row 4, the EdgeConv forward with the next kNN in the same kernel: row
2's work, and row 1's on the output's coordinate columns."""

from harness.roofline import edges, knn_flops, least, matmul_rate, valid_rows


def least_seconds(call, peaks) -> float:
    h1, h2 = call.shapes[5]
    k = call.shapes[2][-1]
    n = valid_rows(call)
    dims = call.scalar(11, 3.0) - call.scalar(10, 0.0)
    el = call.element_size(0)
    flops = 2.0 * h1 * h2 * edges(call)
    nbytes = (float(n.sum()) * (2 * h1 * el + 2 * k * 5 + h2 * 4 + 1)
              + h1 * h2 * el)
    return least([(flops, matmul_rate(call, peaks)),
                  (knn_flops(n, dims), peaks["fp32"])], nbytes, peaks)
