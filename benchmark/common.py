"""What the traffic drivers share: the seam to the program (the port's model
and trainer, built from a configuration file), the inputs made on the device
from the seed, and the recorder of spans around the calls into the program.

The benchmark hands the program only what it makes here: weights (through
``load_state_dict``), a subject's rows and labels, and batch orders. The
reference gets the same, made again from the same seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import time
from typing import Dict, Iterator, List, Tuple

import torch

# the random streams drawn from one seed
WEIGHTS, DATA, ORDER = 1, 2, 3


def sub_seed(seed: int, stream: int, index: int = 0) -> int:
    """A generator seed for one stream (weights, data, batch order) of a
    run's ``seed``, as a whole number below 2**63."""
    return (seed * 1_000_003 + stream * 10_007 + index) % 2**63


def make_weights(family, model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters of a configuration's ``model`` block in float32 on
    ``device``, drawn in one call from ``seed`` in the order of the
    ``family``'s ``param_shapes``: kernels N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.1), biases, shifts and embeddings N(0, 0.02)."""
    shapes = family.param_shapes(model)
    total = sum(math.prod(s) for s, _, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind, fan_in) in shapes.items():
        z = flat[at: at + math.prod(shape)].view(shape)
        at += z.numel()
        if kind == "kernel":
            out[name] = z / math.sqrt(fan_in)
        elif kind == "scale":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.02 * z
    return out


def make_subject(config: dict, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """One subject's (train x, train y, test x, test y) on ``device``: float32
    rows N(0, 1), uint8 rows uniform over 0..255 or int64 token ids uniform
    over 0..vocab-1, labels uniform over the classes, all drawn from
    ``seed``."""
    sub = config["subject"]
    n = sub["train"] + sub["test"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    shape = (n, *sub["input"])
    if sub["dtype"] == "uint8":
        x = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    elif sub["dtype"] == "int64":
        x = torch.randint(0, sub["vocab"], shape, generator=gen, device=device, dtype=torch.int64)
    elif sub["dtype"] == "float32":
        x = torch.randn(shape, generator=gen, device=device)
    else:
        raise ValueError(f"no generator for rows of {sub['dtype']}")
    y = torch.randint(0, sub["classes"], (n,), generator=gen, device=device)
    k = sub["train"]
    return x[:k], y[:k], x[k:], y[k:]


def batch_order(seed: int, epoch: int, n: int) -> torch.Tensor:
    """Epoch ``epoch``'s permutation of ``n`` train rows (on the CPU)."""
    gen = torch.Generator().manual_seed(sub_seed(seed, ORDER, epoch))
    return torch.randperm(n, generator=gen)


def batches(n: int, size: int) -> List[Tuple[int, int]]:
    """(start, end) of each batch of ``n`` rows at ``size``, the last partial."""
    return [(i, min(i + size, n)) for i in range(0, n, size)]


def one_of_each(n: int, size: int) -> int:
    """The fewest leading rows of ``n`` whose batches at ``size`` take each
    size that the batches of all ``n`` take: one full batch and the partial
    one."""
    return min(n, size + n % size)


def build_trainer(config: dict, device):
    """The program under test: the port's model of the configuration's
    preset, at the configuration's widths, in a ``Trainer`` with the
    protocol's batches, decay and lr. The preset keeps the program's own
    choices (compute types, attention)."""
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset(config["preset"])
    widths = {k: v for k, v in config["model"].items() if k != "family"}
    proto = config["protocol"]
    ft = dataclasses.replace(preset.finetune, batch_size=proto["batch_size"],
                             eval_batch_size=proto["eval_batch_size"],
                             weight_decay=proto["weight_decay"])
    return Trainer(build_model(preset, **widths), ft, device=device)


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Spans (host clock) and, on the card, CUDA events around the calls the
    drivers make into the program. Off (the default) it records nothing."""

    def __init__(self, enabled: bool = False, device="cpu"):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.unit = -1
        self.spans: List[Tuple[str, int, float, float]] = []
        self._events: list = []

    @contextlib.contextmanager
    def call(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        if self.cuda:
            ev[1].record()
            self._events.append((name, self.unit, *ev))
        self.spans.append((name, self.unit, t0, t1))

    def event_ms(self) -> List[Tuple[str, int, float]]:
        """(name, unit, ms between the events) of every call; read after the
        window, once the stream has passed them."""
        return [(n, u, a.elapsed_time(b)) for n, u, a, b in self._events]


def flops_of(family, model: dict, train_samples: int, eval_samples: int) -> float:
    """Analytic FLOPs of ``train_samples`` trained and ``eval_samples``
    passed forward through a configuration's ``model`` (its ``family``'s
    count)."""
    return (train_samples * family.train_flops(model)
            + eval_samples * family.forward_flops(model))


def relative_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def leaf_norm_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between two norms: |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf. A NaN reads as an
    infinite gap."""
    median = statistics.median(ref.values())
    gaps = {n: relative_gap(prog[n], ref[n], max(ref[n], median)) for n in ref}
    return {n: g if math.isfinite(g) else math.inf for n, g in gaps.items()}
