"""mfu.train: the analytic FLOPs of the window's unprofiled epochs (trained
samples at 3x the forward's matmuls, evaluated ones at 1x) over their time,
as a share of the card's bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run, train=True)
