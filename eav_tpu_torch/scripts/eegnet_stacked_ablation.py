"""EEGNet's stacked step at the sweep's shape, by component and variant, the
counterpart of the JAX package's ``scripts/eegnet_stacked_ablation.py``:

    python -m eav_tpu_torch.scripts.eegnet_stacked_ablation [--stack 8] [--iters 20] \\
        [--device cuda]

S stacked EEGNet subjects (``--stack``; the CLI stacks up to 42 on the
card, so run it at 42 too) at batch 32 of (30, 500) trials
(`EEGNet_tor.py:159-161`), normals from seed 0, through the port's stacked trainer
(``parallel/subject.py``: ``torch.func.vmap`` over stacked parameters),
for ``temporal_mode`` in {``fft``, ``conv``} crossed with float32 and bf16
convolutions, three components each:

- ``temporal_ms``: the (1, 300) temporal convolution alone, vmapped over the
  subjects' kernels (the direct conv, or the rFFT correlation);
- ``fwd_ms``: the stacked eval-mode forward;
- ``step_ms``: the stacked train step (``SubjectParallelTrainer.train_step``:
  train mode, each subject's dropout masks, the double softmax's
  cross-entropy, Adam at 1e-5, max-norm), as the sweep runs it.

One JSON line a variant: each component's host-clock ms (median of
``--iters`` fenced calls; the ``*_device_ms`` keys are CUDA-event medians),
the step's samples/s, the 200-epoch phase of 9 steps in seconds, the step's
first loss of each subject, and the card's name and power limit. Not
ported: the compile cache and the backend assert.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

BS, C, T = 32, 30, 500


def variant_trainer(mode: str, dtype, device, **model_kw):
    """The ``eegnet_subject`` preset's stacked trainer with ``temporal_mode``
    ``mode`` and convolutions in ``dtype`` (None: float32)."""
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset("eegnet_subject")
    cfg = dataclasses.replace(preset.finetune, phases=(
        dataclasses.replace(preset.finetune.phases[0], lr=1e-5),))
    model = build_model(preset, temporal_mode=mode, compute_dtype=dtype, **model_kw)
    return SubjectParallelTrainer(model, cfg, device=device)


def temporal(mode: str, dtype):
    """The first layer's temporal correlation of one subject, as
    ``EEGNet.forward`` computes it: (weight (F, 1, 1, K), x (B, C, T)) ->
    (B, F, C, T)."""
    import torch
    import torch.nn.functional as F

    from eav_tpu_torch.models.eegnet import _same_pad, fft_correlate

    dt = dtype or torch.float32

    def one(weight, x):
        x = x.unsqueeze(1)
        if mode == "fft":
            return fft_correlate(x, weight).to(dt)
        return F.conv2d(F.pad(x, _same_pad(weight.shape[-1])).to(dt), weight.to(dt))

    return one


def ablate(device="cuda", stack: int = 8, iters: int = 20, batch: int = BS, chans: int = C,
           samples: int = T, **model_kw) -> list:
    """Every variant -> the printed lines; ``batch``, ``chans``, ``samples``
    and ``model_kw`` cut the shapes for the tests."""
    import torch
    from torch.func import vmap

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.scripts.bench import device_line, time_call

    device = resolve_device(device)
    card = device_line(device)
    rng = np.random.default_rng(0)
    bx = torch.from_numpy(rng.normal(size=(stack, batch, chans, samples)).astype(np.float32))
    by = torch.from_numpy(rng.integers(0, 5, size=(stack, batch)))
    bx, by = bx.to(device), by.to(device)
    lines = []
    for mode in ("fft", "conv"):
        for dt_name, dt in (("f32", None), ("bf16", torch.bfloat16)):
            sp = variant_trainer(mode, dt, device, chans=chans, samples=samples, **model_kw)
            st = sp.init_stack(range(stack))
            weights = st.params["conv_temporal.weight"].detach()
            t_conv = time_call(lambda: vmap(temporal(mode, dt))(weights, bx), iters, device)
            t_fwd = time_call(lambda: sp._eval((st.params, st.buffers), bx, "full"), iters, device)
            sp.model.train()
            first_loss = sp.train_step(st, bx, by)[0].cpu().tolist()
            t_step = time_call(lambda: sp.train_step(st, bx, by), iters, device)
            lines.append({
                "variant": f"{mode}-{dt_name}", "stack": stack,
                "temporal_ms": t_conv["wall_ms"], "temporal_device_ms": t_conv["device_ms"],
                "fwd_ms": t_fwd["wall_ms"], "fwd_device_ms": t_fwd["device_ms"],
                "step_ms": t_step["wall_ms"], "step_device_ms": t_step["device_ms"],
                "samples_per_sec_step": round(stack * batch * 1e3 / t_step["wall_ms"], 1),
                "phase_200ep_9steps_s": round(t_step["wall_ms"] * 1.8, 3),
                "first_step_loss": first_loss, "device": card})
            print(json.dumps(lines[-1]), flush=True)
            del sp, st
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stack", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return ablate(args.device, args.stack, args.iters)


if __name__ == "__main__":
    main()
