"""Vision ingest: .mp4 -> (samples, 25, H, W, 3) uint8 frame stacks + labels,
the host code of ``eav_tpu/ingest/video.py`` (reference ``DataLoadVision``,
`Dataload_vision.py:9-99`): Speaking clips only, every 6th frame of the first
600 (100 frames per 20 s clip), grouped 25 frames = 5 s per sample, labels
from filename token 4.

Decoding goes through the native library's libav decoder when it was built
with libav, else through cv2, imported inside the function that uses it: a
machine without either can import this module, and crop and resize without
them (``resize_linear_u8`` computes cv2's resize bit for bit). Face crops: a ``face_cropper`` when one
is given, else MTCNN (``models/mtcnn.py``) on the loader's device when
``EAV_TPU_MTCNN_WEIGHTS`` names its weights, else the square center crop
resized to ``face_image_size`` (what the JAX package does without weights).
A variable that names no weights raises; the JAX package center-crops.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from eav_tpu_torch.core.config import EMOTION_TO_INDEX, VisionPreprocConfig
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.ingest import native
from eav_tpu_torch.ops.image import resize_linear_u8


VIDEO_BACKENDS = ("auto", "native", "cv2")


def decode_strided_frames(path: str, stride: int = 6, max_frames: int = 600,
                          backend: str = "auto") -> List[np.ndarray]:
    """RGB frames 0, stride, 2*stride, ... < max_frames (reference
    `Dataload_vision.py:49-62`).

    ``backend``: ``'native'`` is the native library's libav decoder
    (``ingest/native.read_mp4_strided``: no GIL, only the kept frames
    converted); ``'cv2'`` the cv2 loop, whose skipped frames are only
    ``grab()``-ed; ``'auto'`` the native decoder when the library has libav,
    else cv2 when it imports, else it raises. A native decode error raises:
    the JAX package warns and retries the file with cv2."""
    if backend not in VIDEO_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {VIDEO_BACKENDS}")
    if backend == "native" or (backend == "auto" and native.mp4_supported()):
        return list(native.read_mp4_strided(path, stride, max_frames))
    try:
        import cv2
    except ImportError:
        if backend == "cv2":
            raise
        raise RuntimeError(f"no video decoder for {path}: the native ingest library has "
                           "no libav (build it with the ffmpeg development files) and "
                           "cv2 is not installed") from None

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
    """(N, H, W, 3) uint8 -> (N, size, size, 3): square center crop resized
    as ``cv2.resize`` does (faces are centered in EAV recordings)."""
    _, h, w, _ = frames.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return resize_linear_u8(frames[:, y0 : y0 + s, x0 : x0 + s], size, size)


def resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, size, size, 3), as ``cv2.resize`` does."""
    return resize_linear_u8(frames, size, size)


class DataLoadVision:
    """``process() -> (images, image_label_idx)`` with images (samples,
    frames_per_sample, H, W, 3) uint8 (`Dataload_vision.py:96-99`).

    Decoding and resizing are host work; ``device`` is where MTCNN runs."""

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
        if self._face_cropper is None:
            from eav_tpu_torch.models.mtcnn import default_face_cropper

            self._face_cropper = default_face_cropper(cfg, self.device)
        if self._face_cropper is not None:
            return self._face_cropper(frames)
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
