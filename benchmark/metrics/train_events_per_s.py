"""Events stepped a second over the window, host clock: every event of every
batch handed to ``Trainer.train_step``, over the seconds from a
synchronised start to a synchronised end after the last step
(``icemix_b_d32.train``)."""

from harness import readers


def read(rec):
    return readers.events_per_s(rec, "train")
