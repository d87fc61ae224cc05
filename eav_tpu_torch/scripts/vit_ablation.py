"""Where the ViT-base train step's time goes, the counterpart of the JAX
package's ``scripts/vit_ablation.py``:

    python -m eav_tpu_torch.scripts.vit_ablation [--steps 20] [--device cuda]

ViT-base at batch 128 on uint8 224 x 224 frames (seed 0), bf16 compute,
uint8 preprocessing in the model, eval mode (its dropout is 0), in four
variants: ``base`` (float32 residual stream, math attention), ``+bf16
stream``, ``+flash attn`` (K1-K3 at T 197) and ``+both``. For each, the
forward and its loss, and the full step (``Trainer.train_step``: AdamW at
lr 5e-6, weight decay 0.01): host-clock and CUDA-event ms (medians of
``--steps`` fenced calls), samples/s, TFLOP/s from the JAX script's
analytic ``FLOP_PER_SAMPLE`` and MFU against the card's bf16 peak
(``bench.CARD_PEAKS``; both null off the card). Then two components: the
uint8 preprocessing alone ((x / 255 - 0.5) / 0.5, its sum) and the
patch-embed conv's forward and gradient on preprocessed frames. Each line
carries the card's name and power limit.

The JAX script also times its ``PatchProj`` ``'slices'`` lowering, a TPU
matrix-unit layout; the port's patch embedding is the conv alone, so only
the conv is timed. Not ported: the compile cache and the TPU assert.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

BS = 128
# ViT-base forward: 197 tokens x ~172 MFLOP a token (2 x 86M parameters)
# plus the attention scores, ~35.2 GFLOP; forward + backward = 3 x forward
# (the JAX script's count)
FLOP_PER_SAMPLE = 3 * 35.2e9

VARIANTS = {
    "base (bf16, math attn, f32 stream)": {},
    "+bf16 stream": {"stream_dtype": "bfloat16"},
    "+flash attn": {"attn_impl": "flash"},
    "+both": {"attn_impl": "flash", "stream_dtype": "bfloat16"},
}


def ablate(device="cuda", steps: int = 20, batch: int = BS, image: int = 224,
           **model_kw) -> list:
    """Every variant, then the components -> the printed lines; ``batch``,
    ``image`` and ``model_kw`` (over ViT-base's widths) cut it for the
    tests."""
    import torch

    from eav_tpu_torch.core.config import get_preset, torch_dtype
    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.models.transformer import PatchProj
    from eav_tpu_torch.models.vit import ViT
    from eav_tpu_torch.ops.image import pixel_values
    from eav_tpu_torch.scripts.bench import achieved, device_line, time_call
    from eav_tpu_torch.train.loop import Trainer, cross_entropy

    device = resolve_device(device)
    card = device_line(device)
    cfg = get_preset("vit_finetune").finetune
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(0, 256, size=(batch, image, image, 3), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 5, size=batch))
    x8, y = x8.to(device), y.to(device)
    lines = []
    for name, kw in VARIANTS.items():
        kw = {k: torch_dtype(v) if k.endswith("dtype") else v for k, v in kw.items()}
        model = ViT(compute_dtype=torch.bfloat16, preprocess_uint8=True, image_size=image,
                    **{**model_kw, **kw})
        trainer = Trainer(model, cfg, device=device)
        model.eval()
        opt = make_optimizer(model, cfg)
        for group in opt.param_groups:
            group["lr"] = 5e-6

        def fwd():
            with torch.no_grad():
                return cross_entropy(model(x8), y)

        for part, fn in (("fwd", fwd), ("step", lambda: trainer.train_step(opt, x8, y))):
            t = time_call(fn, steps, device)
            sps = batch * 1e3 / t["wall_ms"]
            line = {"variant": name, "part": part, **t, "samples_per_sec": round(sps, 2)}
            if part == "step":
                line.update(achieved(sps * FLOP_PER_SAMPLE, device))
            lines.append({**line, "device": card})
            print(json.dumps(lines[-1]), flush=True)
        del trainer, model, opt

    pre = time_call(lambda: ((x8.float() / 255.0 - 0.5) / 0.5).sum(), steps, device)
    lines.append({"component": "uint8 preprocess alone", **pre, "device": card})
    print(json.dumps(lines[-1]), flush=True)
    hidden = model_kw.get("hidden", 768)
    patch = model_kw.get("patch_size", 16)
    proj = PatchProj(3, hidden, patch, (patch, patch)).to(device)
    xf = pixel_values(x8, image).permute(0, 3, 1, 2).contiguous()

    def grad():
        torch.autograd.grad((proj(xf) ** 2).sum(), list(proj.parameters()))

    with torch.no_grad():
        fwd_t = time_call(lambda: (proj(xf) ** 2).sum(), steps, device)
    lines.append({"component": "patch_embed[conv]", "fwd": fwd_t,
                  "fwd_grad": time_call(grad, steps, device), "device": card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return ablate(args.device, args.steps)


if __name__ == "__main__":
    main()
