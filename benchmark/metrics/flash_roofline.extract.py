"""flash_roofline.extract: the least time of the profiled pass's forward
attention work over the device time of the kernel named here (K1
flash_fwd), as a share."""

from benchmark import readers

KERNELS = ("flash_fwd",)


def read(run):
    return readers.roofline(run, KERNELS)
