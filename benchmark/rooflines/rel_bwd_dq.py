"""Row 6b, the relative-bias backward's dq kernel: ``12 hd`` operations a
(head, valid query, valid key) (``chip_smoke.py``'s ``rel_bound``,
:3016) and ``hd`` sinusoids a pair, the products at the fastest rate the
kernel may form them (a third of the TF32 peak in fp32, the bf16 peak in
bf16), so the time is a lower bound.  Bytes: q, k, v, do, qt, doe, dq,
dqt and the rows' scalars once, for the valid rows."""

from harness.roofline import least, valid_rows


def least_seconds(call, peaks) -> float:
    B, H, L, hd = call.shapes[0]
    n = valid_rows(call)
    pairs = float((n * n).sum())
    el = call.element_size(0)
    fast = peaks["tf32x3"] if el == 4 else peaks["bf16"]
    nbytes = float(n.sum()) * (H * hd * (5 * el + 3 * 4) + H * 4 * 4 + 25)
    return least([(12.0 * hd * H * pairs, fast), (hd * pairs, peaks["fp32"])],
                 nbytes, peaks)
