"""Train-step and attention microbenchmarks on the card, the counterpart of
the JAX package's ``scripts/tpu_microbench.py``:

    python -m eav_tpu_torch.scripts.microbench [all|eegnet|ast|vit|attn|flash4k] [--long] \\
        [--steps 20] [--device cuda]

- ``eegnet``: EEGNet (dropout 0) at batch 256 on (30, 500) trials, float32
  and bf16 convolutions;
- ``ast``: AST-base at batch 8 in float32, bf16, and bf16 through the flash
  kernels K1-K3;
- ``vit``: ViT-base at batch 128 on float32 224 x 224 frames, float32 and
  bf16 (not in ``all``, as in the JAX script);
- ``attn``: AST-base in float32 through the flash kernels;
- ``flash4k``: the forward and the backward of ``flash_attention`` (K1, then
  K2 and K3) against the plain math attention (``reference_attention``,
  which holds the (B, H, T, T) scores), the value and gradient of
  sum(attention(q, k, v)^2) with respect to q, k and v: T 4096 (B 2, H 8,
  D 64) in bf16 and float32, T 8192 (B 1, H 8) in bf16 and T 1280 (B 8, H
  12) in bf16; with ``--long``, T 16384 (B 1, H 8) and T 32768 (B 1, H 4)
  instead, where math attention must hold gigabytes of scores.

A model step is ``Trainer.train_step`` in eval mode (AdamW, lr 1e-4; weight
decay 0.01 for the transformers, 0 for EEGNet, as the JAX script steps
them). Every time is a median of ``--steps`` fenced calls, host clock and
CUDA events (``bench.time_call``); each line carries the card's name and
power limit, and the attention lines K1-K3's launches a call. Math
attention running out of device memory at long T is a reading
(``math_ms: null``, ``math_error: "OutOfMemoryError"``); any other error
raises. Not ported: the compile cache.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

MODES = ("all", "eegnet", "ast", "vit", "attn", "flash4k")
# (T, B, H, D, dtype) of the flash4k cases, and of --long's
FLASH_CASES = ((4096, 2, 8, 64, "bfloat16"), (4096, 2, 8, 64, "float32"),
               (8192, 1, 8, 64, "bfloat16"), (1280, 8, 12, 64, "bfloat16"))
LONG_CASES = ((16384, 1, 8, 64, "bfloat16"), (32768, 1, 4, 64, "bfloat16"))


def bench_model_step(model, x, y, label: str, device, card: str, lr: float = 1e-4,
                     wd: float = 0.0, steps: int = 20) -> dict:
    """One unfrozen AdamW step of ``model`` on (x, y) through
    ``Trainer.train_step``, timed -> its printed line."""
    from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.scripts.bench import time_call
    from eav_tpu_torch.train.loop import Trainer

    cfg = FinetuneConfig(model="bench", batch_size=x.shape[0], weight_decay=wd,
                         phases=(PhaseConfig(epochs=1, lr=lr, freeze=False),))
    trainer = Trainer(model, cfg, device=device)
    model.eval()
    opt = make_optimizer(model, cfg)
    x, y = x.to(device), y.to(device)
    t = time_call(lambda: trainer.train_step(opt, x, y), steps, device)
    line = {"case": label, **t, "samples_per_sec": round(x.shape[0] * 1e3 / t["wall_ms"], 2),
            "device": card}
    print(json.dumps(line), flush=True)
    return line


def reference_attention(q, k, v):
    """Plain multi-head attention in the (B, T, H, D) layout, the JAX
    package's ``_reference_attention``: scores in q's dtype divided by
    sqrt(D) in that dtype, softmax, then P V; the (B, H, T, T) scores are
    held in device memory."""
    import torch

    root = torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / root.to(q.device)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def loss_and_grads(attn, q, k, v):
    """The value and the gradients (q, k, v) of sum(attn(q, k, v)^2) in
    float32."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    loss = (attn(*leaves).float() ** 2).sum()
    return (loss.detach(), *torch.autograd.grad(loss, leaves))


def attention_inputs(t: int, b: int, h: int, d: int, dtype: str, device, seed: int = 0):
    """q, k, v (B, T, H, D) normals from ``seed``, in ``dtype`` on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                 .to(device, getattr(torch, dtype)) for _ in range(3))


def bench_attention(t: int, b: int, h: int, d: int, dtype: str, device, card: str,
                    steps: int = 20) -> dict:
    """Flash against math attention at one shape -> the printed line."""
    import torch

    from eav_tpu_torch.ops.attention import flash_attention
    from eav_tpu_torch.scripts.bench import launches, time_call

    q, k, v = attention_inputs(t, b, h, d, dtype, device)
    line = {"case": f"attn fwd+bwd T={t} B={b} H={h} D={d} {dtype}"}
    before = launches()
    flash = time_call(lambda: loss_and_grads(flash_attention, q, k, v), steps, device)
    after = launches()
    line.update(flash_ms=flash["wall_ms"], flash_device_ms=flash["device_ms"],
                launches_per_call={n: (after[n] - before[n]) / (steps + 1) for n in after})
    try:
        ref = time_call(lambda: loss_and_grads(reference_attention, q, k, v), steps, device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        line.update(math_ms=None, math_device_ms=None, math_error="OutOfMemoryError")
    else:
        line.update(math_ms=ref["wall_ms"], math_device_ms=ref["device_ms"],
                    speedup_vs_math=round(ref["wall_ms"] / flash["wall_ms"], 3))
    line["device"] = card
    print(json.dumps(line), flush=True)
    return line


def run(mode: str = "all", long: bool = False, device="cuda", steps: int = 20,
        cases=None, **widths) -> list:
    """The ``mode``'s benchmarks -> their printed lines. ``cases`` (the
    attention shapes) and ``widths`` (model keywords: ``eegnet``, ``ast``,
    ``vit`` dicts and ``batch`` overrides) cut it for the tests."""
    import torch

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.models.eegnet import EEGNet
    from eav_tpu_torch.models.vit import ViT
    from eav_tpu_torch.scripts.bench import device_line

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    device = resolve_device(device)
    card = device_line(device)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    lines = []

    def data(batch, shape):
        return (torch.from_numpy(rng.normal(size=(batch, *shape)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 5, size=batch)))

    if mode in ("all", "eegnet"):
        kw = widths.get("eegnet", {})
        x, y = data(widths.get("eegnet_batch", 256),
                    (kw.get("chans", 30), kw.get("samples", 500)))
        for label, dt in (("eegnet f32 bs256", None), ("eegnet bf16 bs256", bf16)):
            lines.append(bench_model_step(EEGNet(dropout_rate=0.0, compute_dtype=dt, **kw), x, y,
                                          label, device, card, steps=steps))
    ast_kw = widths.get("ast", {})
    if mode in ("all", "ast", "attn"):
        x, y = data(widths.get("ast_batch", 8), (ast_kw.get("max_frames", 1024), 128))
        variants = [("ast f32+flash bs8", {"attn_impl": "flash"})] if mode == "attn" else [
            ("ast f32 bs8", {}), ("ast bf16 bs8", {"compute_dtype": bf16}),
            ("ast bf16+flash bs8", {"compute_dtype": bf16, "attn_impl": "flash"})]
        if mode == "all":
            variants.append(("ast f32+flash bs8", {"attn_impl": "flash"}))
        for label, kw in variants:
            lines.append(bench_model_step(AST(**ast_kw, **kw), x, y, label, device, card,
                                          wd=0.01, steps=steps))
    if mode == "vit":
        vit_kw = widths.get("vit", {})
        size = vit_kw.get("image_size", 224)
        x, y = data(widths.get("vit_batch", 128), (size, size, 3))
        for label, dt in (("vit f32 bs128", None), ("vit bf16 bs128", bf16)):
            lines.append(bench_model_step(ViT(compute_dtype=dt, **vit_kw), x, y, label, device,
                                          card, wd=0.01, steps=steps))
    if mode in ("all", "flash4k"):
        for case in cases or (LONG_CASES if long else FLASH_CASES):
            lines.append(bench_attention(*case, device, card, steps))
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="all", choices=MODES)
    ap.add_argument("--long", action="store_true", help="flash4k at T 16384 and 32768")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.mode, args.long, args.device, args.steps)


if __name__ == "__main__":
    main()
