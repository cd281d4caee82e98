"""Percent of the traced stretch in which no activity (kernel, copy or set,
on any stream) ran on the device: one minus the union of the activities'
intervals over the stretch."""

from harness import readers


def read(rec):
    return readers.idle_pct(rec)
