"""Vision ingest: .mp4 -> (samples, 25, H, W, 3) uint8 frame stacks + labels,
the host code of ``eav_tpu/ingest/video.py`` (reference ``DataLoadVision``,
`Dataload_vision.py:9-99`): Speaking clips only, every 6th frame of the first
600 (100 frames per 20 s clip), grouped 25 frames = 5 s per sample, labels
from filename token 4.

Decoding goes through cv2 (the JAX package's native libav reader is a later
slice), imported inside the functions that use it: a machine without cv2 can
import this module. Face crops: a ``face_cropper`` when one is given, else
the square center crop resized to ``face_image_size`` (what the JAX package
does when it has no MTCNN weights); with ``EAV_TPU_MTCNN_WEIGHTS`` naming a
directory the JAX package would run MTCNN, which the port does not have yet,
so the loader raises rather than crop differently.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from eav_tpu_torch.core.config import EMOTION_TO_INDEX, VisionPreprocConfig
from eav_tpu_torch.core.device import resolve_device


def decode_strided_frames(path: str, stride: int = 6, max_frames: int = 600) -> List[np.ndarray]:
    """RGB frames 0, stride, 2*stride, ... < max_frames (reference
    `Dataload_vision.py:49-62`); skipped frames are only ``grab()``-ed."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    idx = 0
    while idx < max_frames:
        if idx % stride == 0:
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        elif not cap.grab():
            break
        idx += 1
    cap.release()
    return frames


def decode_clips_threaded(
    paths: List[str],
    stride: int = 6,
    max_frames: int = 600,
    workers: Optional[int] = None,
    prefetch: Optional[int] = None,
):
    """Decode clips in worker threads (cv2 releases the GIL), yielding
    (path, frames) in input order, with at most ``prefetch`` (default
    workers + 1) clips in flight so decoded frames never pile up ahead of the
    consumer."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if prefetch is None:
        prefetch = workers + 1
    it = iter(paths)
    with ThreadPoolExecutor(workers) as ex:
        pending: deque = deque()

        def top_up():
            while len(pending) < prefetch:
                try:
                    p = next(it)
                except StopIteration:
                    return
                pending.append((p, ex.submit(decode_strided_frames, p, stride, max_frames)))

        top_up()
        while pending:
            p, fut = pending.popleft()
            top_up()  # keep the workers fed before waiting on this clip
            yield p, fut.result()


def center_crop_resize(frames: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, size, size, 3): square center crop + cv2
    resize (faces are centered in EAV recordings)."""
    import cv2

    n, h, w, _ = frames.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        out[i] = cv2.resize(frames[i, y0 : y0 + s, x0 : x0 + s], (size, size))
    return out


def resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    import cv2

    n = frames.shape[0]
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        out[i] = cv2.resize(frames[i], (size, size))
    return out


class DataLoadVision:
    """``process() -> (images, image_label_idx)`` with images (samples,
    frames_per_sample, H, W, 3) uint8 (`Dataload_vision.py:96-99`).

    Decoding and resizing are host work; ``device`` is where face detection
    runs once the port has it (MTCNN, ROADMAP slice 6)."""

    def __init__(
        self,
        subject: int = 1,
        parent_directory: str = "./Datasets/EAV",
        config: VisionPreprocConfig = VisionPreprocConfig(),
        face_cropper: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        device="cuda",
    ):
        self.subject = subject
        self.parent_directory = parent_directory
        self.cfg = config
        self._face_cropper = face_cropper
        self.device = resolve_device(device)

    def data_files(self) -> List[str]:
        path = os.path.join(self.parent_directory, f"subject{self.subject:02d}", "Video")
        return [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if "Speaking" in f and f.endswith(".mp4")
        ]

    def _crop(self, frames: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        if not cfg.face_detection:
            return resize_frames(frames, cfg.image_size)
        if self._face_cropper is not None:
            return self._face_cropper(frames)
        if os.path.isdir(os.environ.get("EAV_TPU_MTCNN_WEIGHTS", "")):
            raise NotImplementedError(
                "EAV_TPU_MTCNN_WEIGHTS is set, so the JAX package would crop faces with "
                "MTCNN; MTCNN is ROADMAP slice 6 of the port. Unset it for the center "
                "crop, or pass face_cropper=")
        return center_crop_resize(frames, cfg.face_image_size)

    def process(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        samples, labels = [], []
        for path, frames in decode_clips_threaded(
            self.data_files(), cfg.frame_stride, cfg.max_frames
        ):
            emotion = os.path.basename(path).split("_")[4].split(".")[0]
            if not frames:
                continue
            frames = self._crop(np.stack(frames))
            n_groups = len(frames) // cfg.frames_per_sample
            for g in range(n_groups):
                samples.append(
                    frames[g * cfg.frames_per_sample : (g + 1) * cfg.frames_per_sample]
                )
                labels.append(EMOTION_TO_INDEX[emotion])
        return np.stack(samples), np.asarray(labels, np.int32)
