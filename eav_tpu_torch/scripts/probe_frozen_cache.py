"""What the frozen phase of the ViT fine-tune costs, piece by piece, the
counterpart of the JAX package's ``scripts/probe_frozen_cache.py``:

    python -m eav_tpu_torch.scripts.probe_frozen_cache [--device cuda]

At the ``vit_finetune`` preset's widths (ViT-base, bf16, uint8 frames
preprocessed on the card) on 7,000 train and 3,000 test synthetic 224 x 224
uint8 frames (seed 0), each time fenced by ``torch.cuda.synchronize()``:

- ``h2d_uint8``: the frames' copy to the card (1.51 GB, 1.40 GiB);
- ``features_<n>``: ``Trainer.extract_features`` over the 7,000 train
  frames, cold then warm, and over the 3,000 test frames: the pooled
  backbone features the frozen phase trains the head on;
- ``frozen_cached_<e>ep``: ``Trainer.fit`` of a frozen phase of ``e``
  epochs (the preset's first phase, its lr) with the frozen-feature cache:
  the two extractions, then each epoch's head steps and evaluation on the
  features;
- ``frozen_backbone_<e>ep``: the same fit with
  ``cache_frozen_features=False``: every step and evaluation through the
  frozen backbone (the cost the cache saves).

The two fits run in turns, cached, backbone, backbone, cached: the
process's first fit also pays the training path's first-use costs (its
first backward and optimizer step), which the turns show apart. Every fit
starts from the same seed; the per-epoch losses of each kind are printed,
and equal to float roundoff (the cache is the same math:
``_frozen_cache_ok``).
The JAX script times its XLA phase programs (``_build_phase`` chunks of two
epochs); PyTorch runs eagerly, so the port times the same work through its
``Trainer``. Not ported: the compile cache and the backend assert.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def _timed(tag: str, fn, device, card: str, lines: list):
    """``fn()`` timed on the host clock, fenced -> its result; appends and
    prints the reading."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    lines.append({"probe": tag, "seconds": round(time.perf_counter() - t0, 3), "device": card})
    print(json.dumps(lines[-1]), flush=True)
    return out


def probe(device="cuda", n_tr: int = 7000, n_te: int = 3000, size: int = 224, epochs: int = 2,
          **model_kw) -> list:
    """The readings above -> the printed lines; the last holds both fits'
    per-epoch losses. ``n_tr``, ``n_te``, ``size`` and ``model_kw`` (over the
    preset's model kwargs) cut it for the tests."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.scripts.bench import device_line
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    device = resolve_device(device)
    card = device_line(device)
    preset = get_preset("vit_finetune")
    frozen = dataclasses.replace(preset.finetune.phases[0], epochs=epochs)
    cfg = dataclasses.replace(preset.finetune, phases=(frozen,))
    rng = np.random.default_rng(0)
    tr_f = rng.integers(0, 256, size=(n_tr, size, size, 3), dtype=np.uint8)
    te_f = rng.integers(0, 256, size=(n_te, size, size, 3), dtype=np.uint8)
    tr_y, te_y = np.arange(n_tr) % 5, np.arange(n_te) % 5
    lines: list = []
    gib = (tr_f.nbytes + te_f.nbytes) / 2**30
    tr_d, te_d = _timed(f"h2d_uint8_{gib:.2f}GiB", lambda: (
        torch.from_numpy(tr_f).to(device), torch.from_numpy(te_f).to(device)), device, card, lines)
    trainer = Trainer(build_model(preset, **model_kw), cfg, device=device)
    trainer.model.reset_parameters(torch.Generator().manual_seed(0))
    _timed(f"features_{n_tr}_cold", lambda: trainer.extract_features(tr_d), device, card, lines)
    _timed(f"features_{n_tr}_warm", lambda: trainer.extract_features(tr_d), device, card, lines)
    _timed(f"features_{n_te}", lambda: trainer.extract_features(te_d), device, card, lines)
    losses = {}
    for tag, cached in (("cached", True), ("backbone", False), ("backbone", False),
                        ("cached", True)):
        trainer.cfg = dataclasses.replace(cfg, cache_frozen_features=cached)
        r = _timed(f"frozen_{tag}_{epochs}ep",
                   lambda: trainer.fit((tr_d, tr_y, te_d, te_y), seed=1), device, card, lines)
        losses[tag] = [float(v) for v in r.history["loss"]]
    lines.append({"frozen_losses": losses, "device": card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return probe(args.device)


if __name__ == "__main__":
    main()
