"""MP4 ingest throughput on the host, the counterpart of the JAX package's
``scripts/bench_video_decode.py``:

    python -m eav_tpu_torch.scripts.bench_video_decode [--clips 100] [--wh 320x240] \\
        [--frames 600]

Writes ``--clips`` synthetic mp4v clips with cv2 (a seeded noise frame
rolled a few pixels a frame), then decodes every 6th of the first 600
frames of each clip with each variant in turn:

- ``reference_serial``: the reference's loop, which reads and converts
  every frame and keeps every 6th (``reference_read_loop``);
- ``grab_serial``: ``ingest/video.decode_strided_frames(backend="cv2")``,
  whose skipped frames are only ``grab()``-ed;
- ``native_serial``: the same through the native library's libav decoder,
  only where ``ingest/native.mp4_supported()`` (a line on stderr says when
  it is left out);
- ``threaded``: ``ingest/video.decode_clips_threaded`` (its default
  backend, its default workers).

Every variant must decode the same number of frames. It prints one JSON
line a variant, ``{"variant", "clips_per_s", "speedup", "host"}``, the
speedup against ``reference_serial``; ``host`` is the CPU's model name and
core count, since every number is the host's (nothing runs on a card).
Without cv2, ``main`` raises ``ImportError`` before it writes or prints
anything. The clips are deleted at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import sys
import tempfile
import time

import numpy as np


def make_clips(n: int, w: int, h: int, frames: int = 600) -> list:
    """``n`` mp4v clips of ``frames`` frames at w x h, 30 fps, in a new
    temporary directory: clip i's frame f is seed 0's noise frame rolled
    3f + i pixels along the width."""
    import cv2

    d = tempfile.mkdtemp(prefix="eav_vidbench_")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"clip{i:03d}.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        for f in range(frames):
            vw.write(np.roll(base, 3 * f + i, axis=1))
        vw.release()
        paths.append(p)
    return paths


def reference_read_loop(path: str, stride: int = 6, max_frames: int = 600):
    """The reference's decode: read and convert every frame, keep every
    ``stride``-th (``Dataload_vision.py:49-62``)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    idx = 0
    while idx < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        if idx % stride == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        idx += 1
    cap.release()
    return frames


def host_line() -> dict:
    """The host the numbers were taken on: the CPU's model name (from
    ``/proc/cpuinfo``, else the platform's) and ``os.cpu_count()``."""
    cpu = None
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), None)
    except OSError:
        pass
    return {"cpu": cpu or platform.processor() or platform.machine(), "cores": os.cpu_count()}


def _clips_per_s(paths, decode) -> tuple:
    """(frames decoded in all, clips a second) of ``decode`` over ``paths``."""
    t0 = time.perf_counter()
    n = sum(len(decode(p)) for p in paths)
    return n, len(paths) / (time.perf_counter() - t0)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=100)
    ap.add_argument("--wh", default="320x240")
    ap.add_argument("--frames", type=int, default=600)
    args = ap.parse_args(argv)
    if args.clips < 1:
        ap.error("--clips must be at least 1")
    w, h = (int(v) for v in args.wh.split("x"))

    import cv2  # noqa: F401  (no cv2: ImportError before anything is written)

    from eav_tpu_torch.ingest import native
    from eav_tpu_torch.ingest.video import decode_clips_threaded, decode_strided_frames

    host = host_line()
    paths = make_clips(args.clips, w, h, args.frames)
    try:
        print(f"# {args.clips} clips, {w}x{h}, {args.frames} frames each, "
              f"{host['cores']} host cores ({host['cpu']})", file=sys.stderr)
        results, counts = {}, []
        variants = [("reference_serial", reference_read_loop),
                    ("grab_serial", lambda p: decode_strided_frames(p, backend="cv2"))]
        if native.mp4_supported():
            variants.append(("native_serial",
                             lambda p: decode_strided_frames(p, backend="native")))
        else:
            print("# native_serial left out: the native ingest library was built "
                  "without libav", file=sys.stderr)
        for name, decode in variants:
            n, results[name] = _clips_per_s(paths, decode)
            counts.append(n)
        t0 = time.perf_counter()
        counts.append(sum(len(f) for _, f in decode_clips_threaded(paths)))
        results["threaded"] = len(paths) / (time.perf_counter() - t0)
    finally:
        shutil.rmtree(os.path.dirname(paths[0]), ignore_errors=True)

    if len(set(counts)) != 1:
        raise AssertionError(f"the variants decoded different frame counts: {counts}")
    base = results["reference_serial"]
    lines = []
    for k, v in results.items():
        lines.append({"variant": k, "clips_per_s": round(v, 2), "speedup": round(v / base, 2),
                      "host": host})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
