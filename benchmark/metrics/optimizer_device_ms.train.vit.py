"""optimizer_device_ms.train.vit: ``optimizer_device_ms.train`` (read the same
way) in the ViT training cell, a metric of its own so that it moves the
ViT cell's rate."""

from benchmark import port_spans


def read(run):
    return port_spans.median_device_ms(run, port_spans.OPTIMIZER)
