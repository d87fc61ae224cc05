"""device_idle_pct.train.vit: ``device_idle_pct.train`` (read the same way) in the ViT
training cell, a metric of its own so that the rate it moves has a bound
of its own (the device-bound ViT epoch spreads far less than AST's)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run, train=True)
