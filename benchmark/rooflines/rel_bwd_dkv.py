"""Row 6c, the relative-bias backward's dk, dv kernel: ``12 hd``
operations a (head, valid query, valid key) and ``hd`` sinusoids a pair,
the products at the fastest rate the kernel may form them, as for row
6b.  Bytes: q, k, v, do, qt, doe, dk, dv and the rows' scalars once."""

from harness.roofline import least, valid_rows


def least_seconds(call, peaks) -> float:
    B, H, L, hd = call.shapes[0]
    n = valid_rows(call)
    pairs = float((n * n).sum())
    el = call.element_size(0)
    fast = peaks["tf32x3"] if el == 4 else peaks["bf16"]
    nbytes = float(n.sum()) * (H * hd * (6 * el + 2 * 4) + H * 4 * 4 + 25)
    return least([(12.0 * hd * H * pairs, fast), (hd * pairs, peaks["fp32"])],
                 nbytes, peaks)
