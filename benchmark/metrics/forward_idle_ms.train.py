"""forward_idle_ms.train: the profiled epoch's device-idle ms a training step
inside the port's ``trainer.forward`` spans (the forward, the loss and its
penalty): its idle gaps intersected with those spans on the annotating
thread, over its ``trainer.train_step`` count. Read in the profiled unit,
whose host the profiler slows about 1.7x: compare it only between traced
runs."""

from benchmark import port_spans


def read(run):
    return port_spans.idle_ms_per_step(run, "trainer.forward")
