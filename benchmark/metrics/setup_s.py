"""Set-up seconds, host clock: from the start of the process (imports
included) to the opening of the window: the card's context, kernels built
or loaded, events made, the model built and its weights made, the
trainer's checked steps and the warm-up of every shape the window uses."""


def read(rec):
    return rec.setup_s
