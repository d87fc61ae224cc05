"""Where the AST-base train step's time goes, the counterpart of the JAX
package's ``scripts/ast_ablation.py``:

    python -m eav_tpu_torch.scripts.ast_ablation [--steps 20] [--device cuda]

AST-base at batch 8 on (8, 1024, 128) normals (seed 0), bf16 compute with a
float32 residual stream as the JAX script builds it, eval mode (its
dropout is 0), with attention through the flash kernels K1-K3 and through
math, each timed three ways: the forward and its loss, the forward and the
backward, and the full step (``Trainer.train_step``: forward, backward and
AdamW at the unfrozen phase's lr 5e-6 and weight decay 0.01). One JSON line
a variant and a part: host-clock and CUDA-event ms (medians of ``--steps``
fenced calls, ``bench.time_call``) and samples/s from the host clock, with
the card's name and power limit. Not ported: the compile cache and the
backend assert.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def ablate(device="cuda", steps: int = 20, batch: int = 8, **model_kw) -> list:
    """The three parts of the step with flash and with math attention -> the
    printed lines; ``model_kw`` over AST-base's widths (the tests' cuts)."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.scripts.bench import _unfrozen, device_line, time_call
    from eav_tpu_torch.train.loop import Trainer, cross_entropy

    device = resolve_device(device)
    card = device_line(device)
    cfg = get_preset("ast_finetune").finetune
    rng = np.random.default_rng(0)
    lines = []
    for impl in ("flash", "math"):
        model = AST(compute_dtype=torch.bfloat16, attn_impl=impl, **model_kw)
        x = torch.from_numpy(rng.normal(size=(batch, *model.input_shape)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 5, size=batch))
        trainer = Trainer(model, cfg, device=device)
        x, y = x.to(device), y.to(device)
        model.eval()
        opt = make_optimizer(model, cfg)
        for group in opt.param_groups:
            group["lr"] = _unfrozen(get_preset("ast_finetune")).lr

        def fwd():
            with torch.no_grad():
                return cross_entropy(model(x), y)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            cross_entropy(model(x), y).backward()

        for part, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd),
                         ("step", lambda: trainer.train_step(opt, x, y))):
            t = time_call(fn, steps, device)
            lines.append({"variant": f"{impl}-bf16", "part": part, **t,
                          "samples_per_sec": round(batch * 1e3 / t["wall_ms"], 2),
                          "batch": batch, "device": card})
            print(json.dumps(lines[-1]), flush=True)
        del trainer, model, opt
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return ablate(args.device, args.steps)


if __name__ == "__main__":
    main()
