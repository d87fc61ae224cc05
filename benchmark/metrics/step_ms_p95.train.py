"""step_ms_p95.train: the 95th percentile of the CUDA-event span of one
``Trainer.train_step`` (events recorded before and after each call, read
after the window), over the unprofiled epochs."""

from benchmark import readers


def read(run):
    return readers.p95(readers.event_ms(run, "train_step"))
