"""Writes the MP4 fixture of ``chip_smoke.py``'s native-ingest phase and the
frames cv2 decodes from it:

    python -m eav_tpu_torch.scripts.make_video_fixture

``eav_tpu_torch/fixtures/clip.mp4`` (60 frames of 64 x 48, mp4v, 30 fps,
a moving colour gradient, as ``tests/test_native.py`` draws its clips) and
``clip_frames.npz`` (``frames``: frames 0, 6, ..., 54 as cv2's grab loop
returns them, RGB uint8). The card's machine may lack libav's development
files and cv2: where the native library has libav, the phase decodes the
clip with it and holds it to the stored frames. Needs cv2; run where it is installed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
FRAMES, HEIGHT, WIDTH, STRIDE = 60, 48, 64, 6


def main() -> int:
    import cv2

    from eav_tpu_torch.ingest.video import decode_strided_frames

    FIXTURES.mkdir(exist_ok=True)
    clip = FIXTURES / "clip.mp4"
    vw = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 30, (WIDTH, HEIGHT))
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    for f in range(FRAMES):
        vw.write(np.stack([(xx * 2 + f * 4) % 256, (yy * 2) % 256, ((xx + yy) + f * 2) % 256],
                          axis=-1).astype(np.uint8))
    vw.release()
    frames = np.stack(decode_strided_frames(str(clip), STRIDE, FRAMES, backend="cv2"))
    np.savez_compressed(FIXTURES / "clip_frames.npz", frames=frames)
    print(f"{clip}: {clip.stat().st_size} bytes; frames {frames.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
