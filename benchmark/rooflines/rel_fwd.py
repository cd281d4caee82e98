"""Row 6a, the relative-bias attention forward (``chip_smoke.py``'s
``rel_bound``, :3016): a (head, valid query, valid key) takes ``q . k``,
``qt . emb``, ``a . emb`` and ``a . v``, ``2 hd`` operations each, and a
pair ``hd`` sines and cosines.  In fp32 the kernel forms the first three
as three TF32 products on the tensor cores (its header), counted at a
third of the TF32 peak; ``a . v`` and the sinusoids at the fp32 peak.  In
bf16 ``q . k`` and ``a . v`` run at the bf16 peak.  Bytes: q, k, v, o,
qt, oe, qb, lse, x0 and the mask once, for the valid rows."""

from harness.roofline import least, valid_rows


def least_seconds(call, peaks) -> float:
    B, H, L, hd = call.shapes[0]
    n = valid_rows(call)
    pairs = float((n * n).sum())
    el = call.element_size(0)
    if el == 4:
        terms = [(3 * 2 * hd * H * pairs, peaks["tf32x3"]),
                 (2 * hd * H * pairs + hd * pairs, peaks["fp32"])]
    else:
        terms = [(2 * 2 * hd * H * pairs, peaks["bf16"]),
                 (2 * 2 * hd * H * pairs, peaks["tf32x3"]),
                 (hd * pairs, peaks["fp32"])]
    nbytes = float(n.sum()) * (H * hd * (4 * el + 2 * 4) + H * 2 * 4 + 25)
    return least(terms, nbytes, peaks)
