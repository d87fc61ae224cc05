"""host_ms_per_step.train: the median host-clock ms from the call into
``Trainer.train_step`` to its return, with no fence (the host's enqueue time
a step), over the unprofiled epochs."""

from benchmark import readers


def read(run):
    return readers.median(readers.span_ms(run, "train_step"))
