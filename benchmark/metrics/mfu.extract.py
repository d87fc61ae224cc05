"""mfu.extract: the forward FLOPs of the window's unprofiled passes over their
time, as a share of the card's bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run, train=False)
