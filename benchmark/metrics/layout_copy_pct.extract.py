"""layout_copy_pct.extract: the device ms of the profiled pass's
``attention.layout`` spans (the copies between the (B, T, H, D) layout and
the flash kernels' head-major one around K1; CUDA events at each span's
entry and exit) over the pass's busy time, the union of its kernels,
copies and sets, as a share."""

from benchmark import port_spans


def read(run):
    return port_spans.share_of_busy_pct(run, port_spans.LAYOUT)
