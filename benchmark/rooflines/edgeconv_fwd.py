"""Row 2, the fused EdgeConv forward: the message's second layer, ``2 h1
h2`` operations a valid edge, at the inputs' matmul rate; the valid rows
of a, b, the edges and the output read or written once, and w2."""

from harness.roofline import edges, least, matmul_rate, valid_rows


def least_seconds(call, peaks) -> float:
    h1, h2 = call.shapes[4]
    k = call.shapes[2][-1]
    n = float(valid_rows(call).sum())
    el = call.element_size(0)
    flops = 2.0 * h1 * h2 * edges(call)
    nbytes = n * (2 * h1 * el + k * 5 + h2 * 4) + h1 * h2 * el
    return least([(flops, matmul_rate(call, peaks))], nbytes, peaks)
