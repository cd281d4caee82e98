"""Row 5a, the flash attention forward: ``q k^T`` and ``a v``, ``4 hd``
operations a (head, valid query, valid key), at the inputs' matmul rate;
q, k, v and the output read or written once with the fp32 lse, for the
valid rows (``chip_smoke.py``'s flash ``bound``, :2850)."""

from harness.roofline import attention_terms, least, matmul_rate


def least_seconds(call, peaks) -> float:
    flops, nbytes = attention_terms(call, 4.0, 4)
    return least([(flops, matmul_rate(call, peaks))], nbytes, peaks)
