"""Row 5b, the flash backward's dq kernel: the logits again, ``do v^T``
and ``ds k``, ``6 hd`` operations a (head, valid query, valid key); q, k,
v, do read and dq written once, with lse and delta (``chip_smoke.py``,
:2862)."""

from harness.roofline import attention_terms, least, matmul_rate


def least_seconds(call, peaks) -> float:
    flops, nbytes = attention_terms(call, 6.0, 5)
    return least([(flops, matmul_rate(call, peaks))], nbytes, peaks)
