"""Row 5c, the flash backward's dk, dv kernel: the logits, ``do v^T``,
``a^T do`` and ``ds^T q``, ``8 hd`` operations a (head, valid query,
valid key); q, k, v, do read and dk, dv written once (``chip_smoke.py``,
:2866)."""

from harness.roofline import attention_terms, least, matmul_rate


def least_seconds(call, peaks) -> float:
    flops, nbytes = attention_terms(call, 8.0, 6)
    return least([(flops, matmul_rate(call, peaks))], nbytes, peaks)
