"""moe_pct.train: the device ms of the profiled epoch's ``moe.route``,
``moe.experts`` and ``moe.combine`` spans over that of its ``lfm2.forward``
spans, as a share: the expert layers' part of the model's forward. Spans
open in eager passes only (a replayed step runs no Python), so in a
training epoch whose steps replay CUDA graphs this is the share in the
evaluation's forward passes. None where the port times no such spans."""

from benchmark import port_spans

MOE = ("moe.route", "moe.experts", "moe.combine")
FORWARD = "lfm2.forward"


def read(run):
    forward = sum(port_spans.device_ms(run, FORWARD))
    if forward <= 0:
        return None
    return 100.0 * sum(sum(port_spans.device_ms(run, name)) for name in MOE) / forward
