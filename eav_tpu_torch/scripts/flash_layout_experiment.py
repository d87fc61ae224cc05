"""Whether head-major operands beat ``flash_attention``'s layout copies, the
counterpart of the JAX package's ``scripts/flash_layout_experiment.py``:

    python -m eav_tpu_torch.scripts.flash_layout_experiment [--steps 30] [--device cuda]

The attention sublayer at the AST shape (B 8, T 1214, H 12, D 64, bf16:
x (B, T, 768), Wqkv (768, 3, 768), Wout (768, 768), weights N(0, 0.02) from
seed 0), forward and backward with respect to Wqkv and Wout of the loss
sum((sublayer(x))^2) in float32, in two layouts over the same kernels K1-K3:

- ``attn_bthd``: qkv in (B, T, 3, H, D), through ``flash_attention`` (the
  (B, T, H, D) API, whose ``_to_bh`` copies q, k and v to head-major form
  and whose output is permuted back);
- ``attn_bhtd``: qkv produced head-major by one ``einsum`` into (3, B, H,
  T, D), through ``flash_attention_bh`` on (B·H, T, D) views, with O
  consumed head-major by the output ``einsum``.

It prints each layout's host-clock and CUDA-event ms a call (medians of
``--steps`` fenced calls), the two losses and their relative difference,
and the card's name and power limit. The JAX script pads T to
``_pick_blocks``' T_pad before ``flash_attention_bh``; the port's kernels
tile any T and mask the ragged tile themselves, so nothing is padded here
(as nowhere in the port). Not ported: the compile cache and the TPU assert.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

B, T, H, DH = 8, 1214, 12, 64


def attn_bthd(x, wqkv, wout, heads: int):
    """The sublayer through the (B, T, H, D) flash API."""
    from eav_tpu_torch.ops.attention import flash_attention

    b, t, hid = x.shape
    d = hid // heads
    qkv = (x @ wqkv.reshape(hid, 3 * hid)).view(b, t, 3, heads, d)
    ctx = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, t, hid)
    return ctx @ wout


def attn_bhtd(x, wqkv, wout, heads: int):
    """The sublayer with head-major q, k, v and O."""
    import torch

    from eav_tpu_torch.ops.attention import flash_attention_bh

    b, t, hid = x.shape
    d = hid // heads
    qkv = torch.einsum("btc,ckhd->kbhtd", x, wqkv.reshape(hid, 3, heads, d))
    q, k, v = (qkv[i].reshape(b * heads, t, d) for i in range(3))
    o = flash_attention_bh(q, k, v, t).view(b, heads, t, d)
    return torch.einsum("bhtd,hdc->btc", o, wout.reshape(heads, d, hid))


LAYOUTS = {"attn_bthd": attn_bthd, "attn_bhtd": attn_bhtd}


def loss_and_grads(fn, x, wqkv, wout, heads: int):
    """(loss, dWqkv, dWout) of sum(fn(x)^2) in float32."""
    import torch

    leaves = [w.detach().clone().requires_grad_(True) for w in (wqkv, wout)]
    loss = (fn(x, *leaves, heads).float() ** 2).sum()
    return (loss.detach(), *torch.autograd.grad(loss, leaves))


def inputs(device, batch: int = B, tokens: int = T, heads: int = H, head_dim: int = DH,
           dtype="bfloat16"):
    """x, Wqkv, Wout from seed 0, as the JAX script draws them."""
    import torch

    hid = heads * head_dim
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    x = rng.normal(size=(batch, tokens, hid)).astype(np.float32)
    wqkv = (rng.normal(size=(hid, 3, hid)) * 0.02).astype(np.float32)
    wout = (rng.normal(size=(hid, hid)) * 0.02).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device, dt) for a in (x, wqkv, wout))


def experiment(device="cuda", steps: int = 30, batch: int = B, tokens: int = T, heads: int = H,
               head_dim: int = DH, dtype: str = "bfloat16") -> list:
    """Both layouts timed, then their losses -> the printed lines; the
    keywords cut the shape for the tests."""
    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.scripts.bench import device_line, time_call

    device = resolve_device(device)
    card = device_line(device)
    x, wqkv, wout = inputs(device, batch, tokens, heads, head_dim, dtype)
    lines, losses = [], {}
    for name, fn in LAYOUTS.items():
        t = time_call(lambda: loss_and_grads(fn, x, wqkv, wout, heads), steps, device)
        losses[name] = float(loss_and_grads(fn, x, wqkv, wout, heads)[0])
        lines.append({"layout": name, **t, "shape": [batch, tokens, heads, head_dim],
                      "dtype": dtype, "device": card})
        print(json.dumps(lines[-1]), flush=True)
    a, b = losses["attn_bthd"], losses["attn_bhtd"]
    lines.append({"loss_match": [a, b], "rel": abs(a - b) / abs(a), "device": card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return experiment(args.device, args.steps)


if __name__ == "__main__":
    main()
