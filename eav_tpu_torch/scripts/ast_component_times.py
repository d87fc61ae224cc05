"""The AST-base train step's components timed one by one, the counterpart of
the JAX package's ``scripts/ast_component_times.py``:

    python -m eav_tpu_torch.scripts.ast_component_times [--steps 30] [--device cuda]

At the AST shape (batch 8, 1214 tokens, hidden 768, 12 heads, MLP 3072,
bf16 compute), each component's forward (the sum of its output in float32)
and forward + backward (gradients of every parameter and of its input),
built from the port's own modules (``models/transformer.py``):

- ``patch_embed``: ``PatchProj``, the 16 x 16 stride-10 conv over the
  (8, 1024, 128) spectrogram, as ``AST`` applies it;
- ``mlp``: ``x + TransformerLayer(x, block="mlp")`` (ln2, fc1, GELU, fc2);
- ``attn_flash`` / ``attn_math``: ``x + TransformerLayer(x, block="attn")``
  (ln1, qkv, attention through K1-K3 or math, out);
- ``layer``: one whole ``TransformerLayer`` through the flash kernels;

each with a float32 and a bf16 residual stream (the JAX script times math
attention with the float32 stream only; the port times both). One JSON line
a component, a stream and a pass: the host-clock ms of a fenced call and
the CUDA-event ms (the device's time, which the host's launches do not
inflate), medians of ``--steps`` calls, with the card's name and power
limit. On the card, a ``torch.profiler`` window over ``--steps`` forward +
backward passes of one whole layer (bf16 stream) then gives its device
time by kernel: which copies, casts and products the layer's time is made
of (the 25 costliest kernels, ms a pass). Components timed alone re-read from
device memory what the whole step keeps in flight, so the parts sum to more
than the step; their ratios are the signal. Not ported: the compile cache and the backend assert.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

B, T, HIDDEN, HEADS, MLP = 8, 1214, 768, 12, 3072
TOP = 25  # kernels the layer's profile lists


def components(hidden: int = HIDDEN, heads: int = HEADS, mlp: int = MLP, dtype="bfloat16"):
    """name -> (module builder, input kind): the modules each component
    runs, from ``models/transformer.py``, computing in ``dtype``; the input
    kind is ``"spec"`` (the spectrogram) or ``"tokens"`` (the residual
    stream)."""
    import torch

    from eav_tpu_torch.models.transformer import PatchProj, TransformerLayer

    def layer(impl):
        return TransformerLayer(hidden, heads, mlp, dropout=0.0, attn_impl=impl,
                                dtype=getattr(torch, dtype))

    return {
        "patch_embed": (lambda: PatchProj(1, hidden, 16, (10, 10)), "spec"),
        "mlp": (lambda: layer("flash"), "tokens"),
        "attn_flash": (lambda: layer("flash"), "tokens"),
        "attn_math": (lambda: layer("math"), "tokens"),
        "layer": (lambda: layer("flash"), "tokens"),
    }


def apply(name: str, module, x):
    """What component ``name`` computes with its ``module`` on ``x``."""
    if name == "patch_embed":
        return module(x.transpose(1, 2).unsqueeze(1)).flatten(2).transpose(1, 2)
    if name == "mlp":
        return x + module(x, block="mlp").to(x.dtype)
    if name.startswith("attn"):
        return x + module(x, block="attn").to(x.dtype)
    return module(x)


def profile_layer(module, x, steps: int, card: str) -> dict:
    """Device ms a forward + backward pass of ``module`` (a layer) on ``x``
    by kernel, from a ``torch.profiler`` window of ``steps`` passes: the
    ``TOP`` kernels by self device time, their launches a pass, and the sum
    over every kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    leaf = x.clone().requires_grad_(True)

    def fwd_bwd():
        torch.autograd.grad(module(leaf).float().sum(), [leaf, *module.parameters()])

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fwd_bwd()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"profile": "layer_fwd_bwd", "stream": str(x.dtype).split(".")[-1],
            "device_ms_per_pass": round(sum(e.self_device_time_total for e in kernels)
                                        / 1e3 / steps, 4),
            "kernels": [[e.key[:120], round(e.self_device_time_total / 1e3 / steps, 4),
                         e.count // steps] for e in kernels[:TOP]],
            "device": card}


def measure(device="cuda", steps: int = 30, batch: int = B, tokens: int = T,
            frames: int = 1024, hidden: int = HIDDEN, heads: int = HEADS,
            mlp: int = MLP) -> list:
    """Every component, stream and pass -> the printed lines; the keywords
    cut the shapes for the tests."""
    import torch

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.scripts.bench import device_line, time_call

    device = resolve_device(device)
    card = device_line(device)
    rng = np.random.default_rng(0)
    spec = torch.from_numpy(rng.normal(size=(batch, frames, 128)).astype(np.float32)).to(device)
    tok = torch.from_numpy(rng.normal(size=(batch, tokens, hidden)).astype(np.float32)).to(device)
    lines = []
    for name, (build, kind) in components(hidden, heads, mlp).items():
        module = build().to(device)
        streams = ("float32",) if kind == "spec" else ("float32", "bfloat16")
        for stream in streams:
            x = spec if kind == "spec" else tok.to(getattr(torch, stream))
            leaf = x.clone().requires_grad_(True)

            def fwd():
                with torch.no_grad():
                    return apply(name, module, x).float().sum()

            def fwd_bwd():
                loss = apply(name, module, leaf).float().sum()
                # a sublayer leaves the other one's parameters out of its graph
                torch.autograd.grad(loss, [leaf, *module.parameters()], allow_unused=True)

            for part, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                lines.append({"component": name, "stream": stream, "part": part,
                              **time_call(fn, steps, device), "device": card})
                print(json.dumps(lines[-1]), flush=True)
    if device.type == "cuda":
        module = components(hidden, heads, mlp)["layer"][0]().to(device)
        lines.append(profile_layer(module, tok.to(torch.bfloat16), steps, card))
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return measure(args.device, args.steps)


if __name__ == "__main__":
    main()
