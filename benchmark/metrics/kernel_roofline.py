"""Percent: over every call of an operator of the port
(``graphnet_tpu_torch::<op>``) in the traced stretch, the least seconds
its work needs (``rooflines/<op>.py``, from its recorded shapes and the
valid pulses of its batch) summed, over the device seconds of the
activities the same calls launched; nothing where no call ran."""

from harness import readers


def read(rec):
    return readers.roofline_pct(rec)
