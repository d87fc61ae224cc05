"""The MTCNN cascade's throughput on the card, the counterpart of the JAX
package's ``scripts/measure_mtcnn.py``:

    python -m eav_tpu_torch.scripts.measure_mtcnn [--frames 30] [--device cuda]

The port's ``MTCNNDetector`` (P-Net over the image pyramid, R- and O-Net
over the surviving crops, NMS on the host) with random facenet-layout
weights (``random_mtcnn_params``: normals scaled by each layer's fan-in
from an explicit ``torch.Generator``; the cascade's work does not depend
on the weights' values beyond how many candidates survive), on
``synth_face_frames`` (the JAX script's frames: noise with one bright
face-like block, drawn with the same numpy calls), at 640 x 480 and at
480 x 270, the reference camera's class. For each size and for both
cascades, ``crop_faces_batched`` (the ingest path) and ``crop_faces``
(frame by frame): frames/s and ms a frame, host clock around a fenced
call after a warm call on two frames. On the card, a ``torch.profiler``
window over a second batched call gives the device's busy share of that
call (kernel time over the window's wall) and the kernel ms a frame. Each
line carries the card's name and power limit. Not ported: the compile
cache and the TPU assert.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def random_mtcnn_params(seed: int = 0):
    """Facenet-layout state dicts of P-, R- and O-Net: normals times 1 /
    sqrt(fan-in) for kernels, times 0.25 for vectors, from a
    ``torch.Generator`` seeded ``seed``."""
    import torch

    from eav_tpu_torch.models.mtcnn import ONet, PNet, RNet

    gen = torch.Generator().manual_seed(seed)
    out = []
    for net in (PNet(), RNet(), ONet()):
        sd = {}
        for k, v in net.state_dict().items():
            scale = 1.0 / np.sqrt(np.prod(v.shape[1:])) if v.ndim >= 2 else 0.25
            sd[k] = torch.randn(v.shape, generator=gen) * scale
        out.append(sd)
    return tuple(out)


def synth_face_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Frames with a bright face-like block, so that the cascade does real
    stage-2/3 work (the JAX script's draws, call for call)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(40, 80, size=(n, h, w, 3), dtype=np.uint8)
    for i in range(n):
        cy, cx = h // 2 + rng.integers(-h // 8, h // 8), w // 2 + rng.integers(-w // 8, w // 8)
        s = rng.integers(h // 6, h // 3)
        y0, y1 = max(0, cy - s), min(h, cy + s)
        x0, x1 = max(0, cx - s), min(w, cx + s)
        frames[i, y0:y1, x0:x1] = rng.integers(150, 230, size=(y1 - y0, x1 - x0, 3))
    return frames


def busy_share(fn, device) -> dict:
    """The device's busy share over one call of ``fn`` (its kernels' self
    time over the call's wall, from ``torch.profiler``) and the kernel ms;
    nulls off the card."""
    if device.type != "cuda":
        return {"busy_pct": None, "kernel_ms": None}
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    return {"busy_pct": round(100.0 * kernel_us / 1e6 / wall, 2),
            "kernel_ms": round(kernel_us / 1e3, 3)}


def measure(device="cuda", frames: int = 30, sizes=((480, 640), (270, 480))) -> list:
    """Both cascades at each (h, w) of ``sizes`` -> the printed lines."""
    import torch

    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.models.mtcnn import MTCNNDetector
    from eav_tpu_torch.scripts.bench import device_line

    device = resolve_device(device)
    card = device_line(device)
    det = MTCNNDetector(*random_mtcnn_params(), face_size=56, device=device)
    lines = []
    for h, w in sizes:
        clip = synth_face_frames(frames, h, w)
        for name, fn in (("batched", det.crop_faces_batched), ("perframe", det.crop_faces)):
            fn(clip[:2])  # every pyramid size's kernels and weight matrices
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn(clip)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            line = {"metric": f"mtcnn_{name}_fps_{w}x{h}", "value": round(frames / dt, 3),
                    "unit": "frames/s", "ms_per_frame": round(1000 * dt / frames, 3)}
            if name == "batched":
                line.update(busy_share(lambda: fn(clip), device))
            lines.append({**line, "device": card})
            print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return measure(args.device, args.frames)


if __name__ == "__main__":
    main()
