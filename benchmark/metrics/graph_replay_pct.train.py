"""graph_replay_pct.train: the share of the profiled epoch's training steps
that ran as a replayed CUDA graph: 100 x its ``trainer.graph_replay`` spans
over its ``trainer.train_step`` spans, both counted on the annotating
thread. 0 for a trainer whose steps all run eagerly (one without graphs);
None where the unit has no step spans."""

from benchmark import port_spans

GRAPH_REPLAY = "trainer.graph_replay"  # the span around a replay (train/loop.py)


def read(run):
    counts = port_spans.reading(run)["host"]
    steps = counts[port_spans.TRAIN_STEP]
    return 100.0 * counts[GRAPH_REPLAY] / steps if steps else None
