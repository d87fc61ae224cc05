"""extract_samples_per_s: the samples of the window's whole feature passes
over the window's time."""

from benchmark import readers


def read(run):
    return readers.per_second(run, train=False)
