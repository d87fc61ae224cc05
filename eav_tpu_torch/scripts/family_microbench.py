"""The non-flagship model families' train steps on the card, the counterpart
of the JAX package's ``scripts/family_microbench.py``:

    python -m eav_tpu_torch.scripts.family_microbench [conformer|scnn|resnet|all] \\
        [--device cuda]

The production step (``Trainer.train_step``, unfrozen, train mode, the
preset's last phase's lr and optimizer) of each family at its preset's
protocol shape, on normals from seed 0:

- ``conformer_eeg``: batch 32 of (30, 500) EEG trials (280 train rows);
- ``scnn_audio``: batch 64 of 180-d features (200 train rows);
- ``resnet_vision``: batch 32 of 224 x 224 x 3 frames, float32 (the preset)
  and with bf16 compute.

One JSON line a step: host-clock and CUDA-event ms (medians of ``--steps``
fenced steps), samples/s, the step's FLOP counted by
``torch.utils.flop_counter`` (the matrix products and convolutions of its
forward and backward), TFLOP/s and the share of the card's peak for the
step's type (``bench.CARD_PEAKS``: 989 TFLOP/s bf16, 67 TFLOP/s float32
outside the tensor cores; null off the card), with the card's name and
power limit. Float32 runs with TF32 off for both matmuls and cuDNN
convolutions, so float32 means float32. The JAX script's analytic ResNet
count and v5e peaks are not used. Not ported: the compile cache and the
TPU assert.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np

# family -> (preset, batch rows' shape)
FAMILIES = {
    "conformer": ("conformer_eeg", (30, 500)),
    "scnn": ("scnn_audio", (180,)),
    "resnet": ("resnet_vision", (224, 224, 3)),
}


@contextlib.contextmanager
def tf32_off():
    """Float32 products and convolutions in full float32 for the block."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def step_flops(step) -> int:
    """FLOP of one call of ``step`` as ``torch.utils.flop_counter`` counts
    them (matrix products and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    return counter.get_total_flops()


def bench_preset(preset_name: str, shape, device, card: str, steps: int = 50,
                 label: str = "", **model_kw) -> dict:
    """The unfrozen production step of ``preset_name`` at batch rows of
    ``shape``, ``model_kw`` over the preset's model kwargs -> its line."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.optim import HEAD_REGEX, make_optimizer, set_trainable
    from eav_tpu_torch.scripts.bench import achieved, time_call
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset(preset_name)
    cfg = preset.finetune
    if model_kw:
        cfg = dataclasses.replace(cfg, model_kwargs={**(cfg.model_kwargs or {}), **model_kw})
        preset = dataclasses.replace(preset, finetune=cfg)
    model = build_model(preset)
    trainer = Trainer(model, cfg, getattr(model, "HEAD_REGEX", HEAD_REGEX), device=device)
    set_trainable(model, False)
    opt = make_optimizer(model, cfg)
    for group in opt.param_groups:
        group["lr"] = cfg.phases[-1].lr
    model.train()
    bs = cfg.batch_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(bs, *shape)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 5, size=bs)).to(device)
    dtype = str((cfg.model_kwargs or {}).get("compute_dtype") or "float32")
    with tf32_off():
        step = lambda: trainer.train_step(opt, x, y)  # noqa: E731
        t = time_call(step, steps, device)
        flops = step_flops(step)
    sps = bs * 1e3 / t["wall_ms"]
    line = {"case": f"{preset_name}{label}", "batch": bs, **t, "samples_per_sec": round(sps, 2),
            "gflop_per_step": round(flops / 1e9, 3), "dtype": dtype,
            **achieved(flops * 1e3 / t["wall_ms"], device, dtype), "device": card}
    print(json.dumps(line), flush=True)
    return line


def run(which: str = "all", device="cuda", steps: int = 50, **family_kw) -> list:
    """The families ``which`` names -> their lines. ``family_kw`` maps a
    family to its model keywords and ``<family>_shape`` to its rows' shape
    (the tests' cuts)."""
    import torch

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.scripts.bench import device_line

    device = resolve_device(device)
    card = device_line(device)
    lines = []
    for family, (preset_name, shape) in FAMILIES.items():
        if which not in ("all", family):
            continue
        kw = family_kw.get(family, {})
        shape = family_kw.get(f"{family}_shape", shape)
        n = min(steps, 20) if family == "resnet" else steps
        lines.append(bench_preset(preset_name, shape, device, card, n,
                                  " (f32)" if family == "resnet" else "", **kw))
        if family == "resnet":
            lines.append(bench_preset(preset_name, shape, device, card, n, " (bf16)",
                                      **{**kw, "compute_dtype": "bfloat16"}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=("all", *FAMILIES))
    ap.add_argument("--steps", type=int, default=50, help="timed steps (ResNet: 20)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.which, args.device, args.steps)


if __name__ == "__main__":
    main()
