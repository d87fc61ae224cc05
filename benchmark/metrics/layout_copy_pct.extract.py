"""layout_copy_pct.extract: ``layout_copy_pct.train`` (read the same way) in
the profiled feature pass: the forward's layout copies around K1 over the
pass's busy time, as a share."""

from benchmark import port_spans


def read(run):
    return port_spans.share_of_busy_pct(run, port_spans.LAYOUT)
