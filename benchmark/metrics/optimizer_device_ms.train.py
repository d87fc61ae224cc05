"""optimizer_device_ms.train: the median device ms of the profiled epoch's
``trainer.optimizer`` spans, from the CUDA event the port records on the
current stream at the span's entry to the one at its exit (any wait of the
stream inside the span counts)."""

from benchmark import port_spans


def read(run):
    return port_spans.median_device_ms(run, port_spans.OPTIMIZER)
