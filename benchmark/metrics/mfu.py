"""Percent of the card's peak for the configuration's dtype (fp32 67 TFLOP/s,
bf16 989 on an H100 SXM): the model's matrix-product FLOPs of the calls
at each event's valid length (``counts/<family>.py``; a training step a
forward and a backward of twice its products) over the seconds they
took, in the untraced part of a traced window."""

from harness import readers


def read(rec):
    return readers.mfu_pct(rec)
