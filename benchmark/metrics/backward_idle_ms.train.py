"""backward_idle_ms.train: the profiled epoch's device-idle ms a training
step inside the port's ``trainer.backward`` spans (``zero_grad``, the
backward, the gradient sum), read as ``forward_idle_ms.train`` is. Read in
the profiled unit, whose host the profiler slows about 1.7x: compare it
only between traced runs."""

from benchmark import port_spans


def read(run):
    return port_spans.idle_ms_per_step(run, "trainer.backward")
