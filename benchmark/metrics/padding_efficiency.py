"""Percent of the padded pulse slots that hold a pulse, over every call of
the window, read from the batches the program built: a training cell's
from each batch's mask as the DataLoader hands it to
``Trainer.train_step``, a reprocessing cell's from each batch's mask as
``DeploymentModule`` hands it to its model (a forward pre-hook)."""

from harness import readers


def read(rec):
    return readers.padding_pct(rec)
