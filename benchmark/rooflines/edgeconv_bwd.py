"""Row 3, the fused EdgeConv backward: a valid edge's second layer again,
its input gradient through w2 and its share of w2's gradient, ``6 h1 h2``
operations, at the inputs' matmul rate; a, b, g and the edges read and
da, db, dw2 written once for the valid rows."""

from harness.roofline import edges, least, matmul_rate, valid_rows


def least_seconds(call, peaks) -> float:
    h1, h2 = call.shapes[4]
    k = call.shapes[2][-1]
    n = float(valid_rows(call).sum())
    el = call.element_size(0)
    flops = 6.0 * h1 * h2 * edges(call)
    nbytes = n * (2 * h1 * el + k * 5 + h2 * 4 + 2 * h1 * 4) + 2 * h1 * h2 * 4
    return least([(flops, matmul_rate(call, peaks))], nbytes, peaks)
