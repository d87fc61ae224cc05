"""flash_roofline.train: the least time of the profiled epoch's attention
work over the device time of the kernels named here (K1 flash_fwd, K2
flash_dkv, K3 flash_dq), as a share."""

from benchmark import readers

KERNELS = ("fwd", "dkv", "dq")


def read(run):
    return readers.flash_roofline(run, KERNELS)
