"""device_idle_pct.extract: the profiled pass's share of its span in which no
kernel, copy or set runs on the device."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run, train=False)
