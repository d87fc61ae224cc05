"""The one-pass flash forward against the streaming one, and GELU erf against
tanh: the counterpart of ``scripts/flash_onepass_experiment.py``.

    python -m eav_tpu_torch.scripts.flash_onepass_experiment [--device cuda]

At the AST shape (B 8, T 1214, H 12, D 64, bf16) it times

- the streaming forward: ``flash_attention`` (K1, the online-softmax
  recurrence over 64-key tiles) with its (B, T, H, D) layout copies;
- the one-pass forward: ``flash_onepass_attention`` (K5, one plain softmax
  over each query row's whole score row);
- the exact (erf) and the tanh GELU on the MLP shape (B, T, 3072);

and returns the max |err| between the two forwards. Each time is the mean
over ``steps`` calls after a warm-up call, on the host clock around work that
ends in a device synchronize. On the CPU the kernels' plain versions run and
the times are CPU times. Nothing runs at import.
"""

from __future__ import annotations

import argparse
import json
import time

B, T, H, D, MLP = 8, 1214, 12, 64, 3072


def _mean_ms(fn, args, steps: int, device) -> float:
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / steps * 1e3


def run(device="cuda", b: int = B, t: int = T, h: int = H, d: int = D, mlp: int = MLP,
        steps: int = 50) -> dict:
    """The experiment's readings at (b, t, h, d) in bfloat16 on ``device``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.ops.attention import flash_attention, flash_onepass_attention

    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def normal(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(dev).to(torch.bfloat16)

    q, k, v = (normal(b, t, h, d) for _ in range(3))
    with torch.no_grad():
        stream_ms = _mean_ms(flash_attention, (q, k, v), steps, dev)
        onepass_ms = _mean_ms(flash_onepass_attention, (q, k, v), steps, dev)
        a, o = flash_attention(q, k, v), flash_onepass_attention(q, k, v)
        err = float((a.float() - o.float()).abs().max())
        x = normal(b, t, mlp)
        gelu = {approx: _mean_ms(lambda x, a=approx: F.gelu(x, approximate=a), (x,), steps, dev)
                for approx in ("none", "tanh")}
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "shape": [b, t, h, d], "dtype": "bfloat16", "steps": steps,
        "stream_ms": stream_ms, "onepass_ms": onepass_ms, "max_abs_err": err,
        "gelu_erf_ms": gelu["none"], "gelu_tanh_ms": gelu["tanh"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    res = run(args.device, steps=args.steps)
    print(f"fwd streaming (K1, 64-key tiles): {res['stream_ms']:.3f} ms")
    print(f"fwd one-pass  (K5, whole rows):   {res['onepass_ms']:.3f} ms")
    print(f"max|err|: {res['max_abs_err']:.2e}")
    print(f"gelu erf : {res['gelu_erf_ms']:.3f} ms")
    print(f"gelu tanh: {res['gelu_tanh_ms']:.3f} ms")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
