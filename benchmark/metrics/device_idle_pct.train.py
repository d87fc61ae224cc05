"""device_idle_pct.train: the profiled epoch's share of its span in which no
kernel, copy or set runs on the device (the union of their intervals)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run, train=True)
