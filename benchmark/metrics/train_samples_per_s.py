"""train_samples_per_s: the trained samples of the window's whole epochs over
the time from the window's start to the fenced end of its last epoch (each
epoch's evaluation inside it)."""

from benchmark import readers


def read(run):
    return readers.per_second(run, train=True)
