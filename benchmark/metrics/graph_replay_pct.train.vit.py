"""graph_replay_pct.train.vit: ``graph_replay_pct.train`` (read the same way)
in the ViT training cell, a metric of its own so that it moves the ViT
cell's rate."""

from benchmark import port_spans

GRAPH_REPLAY = "trainer.graph_replay"  # the span around a replay (train/loop.py)


def read(run):
    counts = port_spans.reading(run)["host"]
    steps = counts[port_spans.TRAIN_STEP]
    return 100.0 * counts[GRAPH_REPLAY] / steps if steps else None
