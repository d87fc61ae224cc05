"""MTCNN face detection (P-Net / R-Net / O-Net), the port of
``eav_tpu/models/mtcnn.py``.

The nets are facenet_pytorch's, under its names (``conv1``, ``prelu1``, …,
``dense4``, ``conv4_1``, ``dense6_3``), so a facenet state dict loads with
``load_state_dict``: NCHW, max pooling with ``ceil_mode=True``, and the first
dense layer reading the last conv's activations flattened as facenet does
(``permute(0, 3, 2, 1)``). ``models/bridge.mtcnn_params_from_jax`` carries
the JAX package's Flax trees across.

``MTCNNDetector`` is the JAX package's cascade: the P-Net pyramid (factor
0.709, min size 20) resized as ``jax.image.resize(..., "bilinear")`` does
(``ops/image.resize_bilinear``, antialiased when downsampling), host NMS
between the stages, R-Net and O-Net on crops resized by the same linear map
(``resize_weight_matrix``), and the final aligned crop with facenet's
post-processing re-expanded to uint8. ``detect`` / ``crop_faces`` run one
frame at a time, ``detect_batched`` / ``crop_faces_batched`` a whole clip
per pyramid scale and stage. A crop gathers only the window of frame rows
and columns its box covers; the JAX package multiplies a whole float32 frame
per box by zero-padded weights: the same sum, but for its order.

One difference, made on purpose: a candidate whose box, clamped into the
frame, is empty (it lies wholly right of or below the frame) is dropped
before the crops are gathered, in both paths. The JAX package divides by
zero there (``resize_weight_matrix(0, size)``) and raises.

Weights are not vendored. ``default_face_cropper`` builds the detector from
``EAV_TPU_MTCNN_WEIGHTS`` (facenet's ``{p,r,o}net.pt`` or the ``.npz`` files
``scripts/convert_mtcnn.py`` writes), returns None when the variable is
unset or empty, and raises when it names no weights.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.core.config import VisionPreprocConfig
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.ops.image import resize_bilinear

NETS = ("pnet", "rnet", "onet")


def _flatten_whc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, W*H*C), facenet's flatten before its first dense
    layer."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):  # (B, 3, H, W) -> prob (B, 2, h, w), reg (B, 4, h, w)
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 2, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return self.conv4_1(x).softmax(1), self.conv4_2(x)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):  # (B, 3, 24, 24) -> prob (B, 2), reg (B, 4)
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = self.prelu4(self.dense4(_flatten_whc(self.prelu3(self.conv3(x)))))
        return self.dense5_1(x).softmax(1), self.dense5_2(x)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):  # (B, 3, 48, 48) -> prob (B, 2), reg (B, 4), landmarks (B, 10)
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu3(self.conv3(x)), 2, 2, ceil_mode=True)
        x = self.prelu5(self.dense5(_flatten_whc(self.prelu4(self.conv4(x)))))
        return self.dense6_1(x).softmax(1), self.dense6_2(x), self.dense6_3(x)


# ---------------------------------------------------------------------------
# host helpers (copies of the JAX package's)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, threshold: float,
              method: str = "union") -> np.ndarray:
    """Greedy NMS (host-side, between cascade stages)."""
    if len(boxes) == 0:
        return np.empty(0, np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        if method == "min":
            iou = inter / np.minimum(area[i], area[order[1:]])
        else:
            iou = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][iou <= threshold]
    return np.asarray(keep, np.int64)


def _square(boxes: np.ndarray) -> np.ndarray:
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    s = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + w * 0.5 - s * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - s * 0.5
    out[:, 2] = out[:, 0] + s
    out[:, 3] = out[:, 1] + s
    return out


def _apply_regression(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    return boxes + np.concatenate([w, h, w, h], axis=1) * reg


def _clamp_boxes(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """(M, 4) boxes -> (M, 4) int64 pixel bounds x1, y1, x2, y2 inside an
    h x w frame, the JAX package's ``_clamp_box`` on every row: corners
    rounded half to even, the start clamped to 0, the end to at least one
    past the start and at most the frame's size. A box wholly right of or
    below the frame comes out empty (x2 <= x1 or y2 <= y1)."""
    x1, y1, x2, y2 = np.rint(np.asarray(boxes, np.float64).reshape(-1, 4)).astype(np.int64).T
    x1, y1 = np.maximum(x1, 0), np.maximum(y1, 0)
    x2, y2 = np.minimum(np.maximum(x2, x1 + 1), w), np.minimum(np.maximum(y2, y1 + 1), h)
    return np.stack([x1, y1, x2, y2], axis=1)


def _nonempty(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Which boxes keep at least one pixel once clamped into an h x w frame."""
    x1, y1, x2, y2 = _clamp_boxes(boxes, h, w).T
    return (x2 > x1) & (y2 > y1)


@functools.lru_cache(maxsize=4096)
def resize_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) linear map identical to
    ``jax.image.resize(x, (out_size, ...), 'bilinear', antialias=True)``
    along one axis: triangle kernel widened by 1/scale when downscaling,
    weights renormalized over the in-range taps. Cached, so read-only: a
    clip's thousands of crops come in a few hundred sizes."""
    scale = out_size / in_size
    kernel_scale = max(1.0, 1.0 / scale)
    sample_f = (np.arange(out_size) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


def _post_process(raw: np.ndarray) -> np.ndarray:
    """Float crops -> uint8: facenet's (x - 127.5) / 128, re-expanded to
    0..255 as the reference does (`Dataload_vision.py:67-69`)."""
    norm = (raw - 127.5) / 128.0
    return np.clip((norm + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the cascade


class MTCNNDetector:
    """Batched cascade on ``device`` from the three nets' state dicts.
    Returns aligned face crops and detection probabilities."""

    # boxes a crop call gathers at once: a chunk's window of frame pixels
    # is (crop_chunk, rows, cols, 3) float32 on the device
    crop_chunk = 256

    def __init__(
        self,
        params_pnet: Dict[str, torch.Tensor],
        params_rnet: Dict[str, torch.Tensor],
        params_onet: Dict[str, torch.Tensor],
        min_face_size: int = 20,
        thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7),
        factor: float = 0.709,
        face_size: int = 56,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        for net, sd in zip((self.pnet, self.rnet, self.onet), (params_pnet, params_rnet, params_onet)):
            net.load_state_dict(sd)
            net.to(self.device).eval()
        self.min_face_size = min_face_size
        self.thresholds = thresholds
        self.factor = factor
        self.face_size = face_size

    def _scales(self, h: int, w: int) -> List[float]:
        m = 12.0 / self.min_face_size
        minl = min(h, w) * m
        scales, s = [], m
        while minl >= 12:
            scales.append(s)
            s *= self.factor
            minl *= self.factor
        return scales

    def _pyramid(self, h: int, w: int) -> List[Tuple[float, int, int]]:
        """(scale, height, width) of each P-Net input."""
        out = []
        for scale in self._scales(h, w):
            hs, ws = int(np.ceil(h * scale)), int(np.ceil(w * scale))
            if hs >= 12 and ws >= 12:
                out.append((scale, hs, ws))
        return out

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) float in 0..255 -> the nets' normalized NCHW input."""
        return ((x - 127.5) / 128.0).permute(0, 3, 1, 2)

    @torch.no_grad()
    def _pnet_scaled(self, frames: torch.Tensor, hs: int, ws: int):
        """P-Net over uint8 frames (N, H, W, 3) on the device resized to
        (hs, ws) -> host prob (N, h, w) of a face and reg (N, h, w, 4)."""
        prob, reg = self.pnet(self._nchw(resize_bilinear(frames.float(), hs, ws)))
        return prob[:, 1].cpu().numpy(), reg.permute(0, 2, 3, 1).cpu().numpy()

    def _stage1_host(self, prob: np.ndarray, reg: np.ndarray, scale: float):
        """One frame's P-Net map at one scale -> rows (n, 9): box, score, reg,
        after NMS 0.5 on the raw boxes. Box coordinates use the original
        MTCNN offsets x1 = floor((2x + 1) / s), x2 = floor((2x + 12) / s)."""
        ys, xs = np.where(prob >= self.thresholds[0])
        if len(ys) == 0:
            return None
        stride, cell = 2.0, 12.0
        x1 = np.floor((xs * stride + 1) / scale)
        y1 = np.floor((ys * stride + 1) / scale)
        x2 = np.floor((xs * stride + cell) / scale)
        y2 = np.floor((ys * stride + cell) / scale)
        boxes = np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)
        scores = prob[ys, xs]
        r = reg[ys, xs]
        keep = nms_numpy(boxes, scores, 0.5)
        return np.concatenate([boxes[keep], scores[keep, None], r[keep]], axis=1)

    @staticmethod
    def _stage1_merge(rows_list: list) -> np.ndarray:
        """A frame's rows of every scale -> (n, 5) boxes and scores after the
        cross-scale NMS 0.7 and the box regression."""
        if not rows_list:
            return np.empty((0, 5), np.float32)
        rows = np.concatenate(rows_list, axis=0)
        rows = rows[nms_numpy(rows[:, :4], rows[:, 4], 0.7)]
        boxes = _apply_regression(rows[:, :4], rows[:, 5:9])
        return np.concatenate([boxes, rows[:, 4:5]], axis=1)

    @torch.no_grad()
    def _gather_crops(self, frames: torch.Tensor, idx: np.ndarray, boxes: np.ndarray,
                      size: int) -> torch.Tensor:
        """Frames (N, H, W, 3) on the device, a frame index and a box per crop
        -> (M, size, size, 3) float32 crops: each box clamped into its frame
        and resized by ``resize_weight_matrix`` along each axis. Every box
        must be non-empty once clamped."""
        _, h, w, _ = frames.shape
        clamped = _clamp_boxes(boxes, h, w)
        x1, y1, x2, y2 = clamped.T
        rows, cols = int((y2 - y1).max()), int((x2 - x1).max())
        # each crop's window: rows y1 .. y1 + rows and cols x1 .. x1 + cols,
        # the taps past its box weighted zero
        wy = np.zeros((len(boxes), size, rows), np.float32)
        wx = np.zeros((len(boxes), size, cols), np.float32)
        for i, (bx1, by1, bx2, by2) in enumerate(clamped):
            wy[i, :, : by2 - by1] = resize_weight_matrix(int(by2 - by1), size)
            wx[i, :, : bx2 - bx1] = resize_weight_matrix(int(bx2 - bx1), size)
        ry = torch.as_tensor(np.minimum(y1[:, None] + np.arange(rows), h - 1), device=self.device)
        rx = torch.as_tensor(np.minimum(x1[:, None] + np.arange(cols), w - 1), device=self.device)
        fi = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        window = frames[fi[:, None, None], ry[:, :, None], rx[:, None, :]].float()
        t = torch.einsum("msh,mhwc->mswc", torch.as_tensor(wy, device=self.device), window)
        return torch.einsum("mtw,mswc->mstc", torch.as_tensor(wx, device=self.device), t)

    def _crops_chunked(self, frames: torch.Tensor, idx: np.ndarray, boxes: np.ndarray,
                       size: int, net: Optional[nn.Module] = None) -> List[np.ndarray]:
        """The crops of ``boxes`` (through ``net``, when given) in chunks of
        ``crop_chunk`` boxes -> host arrays, one per output."""
        parts: List[List[np.ndarray]] = []
        with torch.no_grad():
            for i in range(0, len(idx), self.crop_chunk):
                sl = slice(i, i + self.crop_chunk)
                crops = self._gather_crops(frames, idx[sl], boxes[sl], size)
                outs = (crops,) if net is None else net(self._nchw(crops))
                outs = [o.cpu().numpy() for o in outs]
                parts = [[o] for o in outs] if not parts else [p + [o] for p, o in zip(parts, outs)]
        return [np.concatenate(p, axis=0) for p in parts]

    # -- one frame at a time ---------------------------------------------

    def _frame_crops(self, image: torch.Tensor, boxes: np.ndarray, size: int) -> torch.Tensor:
        return self._gather_crops(image[None], np.zeros(len(boxes), np.int64), boxes, size)

    @torch.no_grad()
    def _stage1(self, image: torch.Tensor) -> np.ndarray:
        """P-Net pyramid sweep, following facenet_pytorch detect_face's
        first-stage semantics: per-scale NMS 0.5 on the raw boxes, then
        cross-scale NMS 0.7, then box regression."""
        h, w = image.shape[:2]
        rows = []
        for scale, hs, ws in self._pyramid(h, w):
            prob, reg = self._pnet_scaled(image[None], hs, ws)
            r = self._stage1_host(prob[0], reg[0], scale)
            if r is not None:
                rows.append(r)
        return self._stage1_merge(rows)

    @torch.no_grad()
    def _stage2(self, image: torch.Tensor, boxes: np.ndarray) -> np.ndarray:
        """R-Net refine: square crops -> threshold -> NMS on the
        pre-regression boxes -> regression (facenet_pytorch's order)."""
        sq = _square(boxes[:, :4])
        sq = sq[_nonempty(sq, *image.shape[:2])]
        if len(sq) == 0:
            return np.empty((0, 5), np.float32)
        prob, reg = self.rnet(self._nchw(self._frame_crops(image, sq, 24)))
        prob, reg = prob[:, 1].cpu().numpy(), reg.cpu().numpy()
        mask = prob > self.thresholds[1]
        if not mask.any():
            return np.empty((0, 5), np.float32)
        sq, prob, reg = sq[mask], prob[mask], reg[mask]
        keep = nms_numpy(sq, prob, 0.7)
        return np.concatenate([_apply_regression(sq[keep], reg[keep]), prob[keep, None]], axis=1)

    @torch.no_grad()
    def _stage3(self, image: torch.Tensor, boxes: np.ndarray) -> np.ndarray:
        """O-Net refine: square crops -> threshold -> regression -> NMS with
        the 'min' overlap (facenet_pytorch's order)."""
        sq = _square(boxes[:, :4])
        sq = sq[_nonempty(sq, *image.shape[:2])]
        if len(sq) == 0:
            return np.empty((0, 5), np.float32)
        prob, reg, _landmarks = self.onet(self._nchw(self._frame_crops(image, sq, 48)))
        prob, reg = prob[:, 1].cpu().numpy(), reg.cpu().numpy()
        mask = prob > self.thresholds[2]
        if not mask.any():
            return np.empty((0, 5), np.float32)
        out, prob = _apply_regression(sq[mask], reg[mask]), prob[mask]
        keep = nms_numpy(out, prob, 0.7, "min")
        return np.concatenate([out[keep], prob[keep, None]], axis=1)

    def detect(self, image: np.ndarray) -> Tuple[Optional[np.ndarray], float]:
        """Best face box for one RGB uint8 image (H, W, 3), or (None, 0.0)."""
        img = torch.as_tensor(np.ascontiguousarray(image), device=self.device)
        boxes = self._stage3(img, self._stage2(img, self._stage1(img)))
        if len(boxes) == 0:
            return None, 0.0
        best = boxes[np.argmax(boxes[:, 4])]
        return best[:4], float(best[4])

    def crop_faces(self, frames: np.ndarray, prob_threshold: float = 0.3) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, face_size, face_size, 3) uint8 aligned
        crops; a frame without a confident face (or whose box lies outside
        it) takes the previous crop, the first frame the center crop."""
        from eav_tpu_torch.ingest.video import center_crop_resize

        h, w = frames.shape[1:3]
        out = np.empty((len(frames), self.face_size, self.face_size, 3), np.uint8)
        prev = center_crop_resize(frames[:1], self.face_size)[0]
        for i, frame in enumerate(frames):
            box, prob = self.detect(frame)
            if box is not None and prob > prob_threshold and _nonempty(box[None], h, w)[0]:
                # facenet's extract_face crops the detection box as it is
                img = torch.as_tensor(np.ascontiguousarray(frame), device=self.device)
                prev = _post_process(self._frame_crops(img, box[None], self.face_size)[0].cpu().numpy())
            out[i] = prev
        return out

    # -- a whole clip per scale and stage -----------------------------------

    @staticmethod
    def _flatten(per_frame: Sequence[np.ndarray], h: int, w: int):
        """Per-frame (n, 5) candidates -> frame index (M,) and squared boxes
        (M, 4) of every candidate whose squared box is non-empty."""
        idx = np.concatenate([np.full(len(b), fi, np.int64) for fi, b in enumerate(per_frame)]
                             + [np.empty(0, np.int64)])
        if idx.size == 0:
            return idx, np.empty((0, 4), np.float32)
        sq = np.concatenate([_square(b[:, :4]) for b in per_frame if len(b)])
        keep = _nonempty(sq, h, w)
        return idx[keep], sq[keep]

    def cascade_batched(self, frames: np.ndarray) -> Tuple[List[np.ndarray], ...]:
        """Each frame's candidates (n, 5: box, probability) after stage 1, 2
        and 3 for a uint8 (N, H, W, 3) clip: the cascade of ``detect`` with
        one P-Net call per pyramid scale and one R-Net and O-Net pass per
        chunk of candidates."""
        frames = np.ascontiguousarray(frames)
        n, h, w = frames.shape[:3]
        fdev = torch.as_tensor(frames, device=self.device)
        rows_per_frame: List[list] = [[] for _ in range(n)]
        for scale, hs, ws in self._pyramid(h, w):
            prob, reg = self._pnet_scaled(fdev, hs, ws)
            for fi in range(n):
                rows = self._stage1_host(prob[fi], reg[fi], scale)
                if rows is not None:
                    rows_per_frame[fi].append(rows)
        stage1 = [self._stage1_merge(r) for r in rows_per_frame]

        # stage 2 (R-Net) over every frame's candidates
        idx, sq = self._flatten(stage1, h, w)
        stage2 = [np.empty((0, 5), np.float32)] * n
        if idx.size:
            prob, reg = self._crops_chunked(fdev, idx, sq, 24, self.rnet)
            prob = prob[:, 1]
            for fi in range(n):
                m = (idx == fi) & (prob > self.thresholds[1])
                if not m.any():
                    continue
                sqf, pf, rf = sq[m], prob[m], reg[m]
                keep = nms_numpy(sqf, pf, 0.7)
                stage2[fi] = np.concatenate([_apply_regression(sqf[keep], rf[keep]),
                                             pf[keep, None]], axis=1)

        # stage 3 (O-Net)
        idx, sq = self._flatten(stage2, h, w)
        stage3 = [np.empty((0, 5), np.float32)] * n
        if idx.size:
            prob, reg, _lm = self._crops_chunked(fdev, idx, sq, 48, self.onet)
            prob = prob[:, 1]
            for fi in range(n):
                m = (idx == fi) & (prob > self.thresholds[2])
                if not m.any():
                    continue
                out, pf = _apply_regression(sq[m], reg[m]), prob[m]
                keep = nms_numpy(out, pf, 0.7, "min")
                stage3[fi] = np.concatenate([out[keep], pf[keep, None]], axis=1)
        return stage1, stage2, stage3

    def detect_batched(self, frames: np.ndarray) -> List[Tuple[Optional[np.ndarray], float]]:
        """Best (box, prob) per frame of a uint8 (N, H, W, 3) clip, or
        (None, 0.0): the most probable of ``cascade_batched``'s last stage."""
        out: List[Tuple[Optional[np.ndarray], float]] = []
        for cands in self.cascade_batched(frames)[2]:
            if len(cands) == 0:
                out.append((None, 0.0))
                continue
            best = cands[int(np.argmax(cands[:, 4]))]
            out.append((best[:4], float(best[4])))
        return out

    def crop_faces_batched(self, frames: np.ndarray, prob_threshold: float = 0.3) -> np.ndarray:
        """``crop_faces`` (the previous-crop fallback included) over the
        batched cascade, with the final crops gathered in chunks."""
        from eav_tpu_torch.ingest.video import center_crop_resize

        frames = np.ascontiguousarray(frames)
        n, h, w = frames.shape[:3]
        dets = self.detect_batched(frames)
        hit = [i for i, (b, p) in enumerate(dets)
               if b is not None and p > prob_threshold and _nonempty(b[None], h, w)[0]]
        crops = {}
        if hit:
            boxes = np.stack([dets[i][0] for i in hit])
            fdev = torch.as_tensor(frames, device=self.device)
            (raw,) = self._crops_chunked(fdev, np.asarray(hit, np.int64), boxes, self.face_size)
            crops = dict(zip(hit, _post_process(raw)))
        out = np.empty((n, self.face_size, self.face_size, 3), np.uint8)
        prev = center_crop_resize(frames[:1], self.face_size)[0]
        for i in range(n):
            prev = crops.get(i, prev)
            out[i] = prev
        return out


# ---------------------------------------------------------------------------
# weights


def load_mtcnn_params(weights_dir: str) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The P/R/O-Net state dicts from ``weights_dir``: ``{net}.npz`` (the
    flattened Flax tree ``scripts/convert_mtcnn.py`` writes, carried across
    by ``bridge.mtcnn_params_from_jax``) where present, as the JAX package
    prefers it, else facenet's ``{net}.pt``. A missing pair raises
    ``FileNotFoundError``."""
    from eav_tpu_torch.core.checkpoint import _unflatten
    from eav_tpu_torch.models.bridge import mtcnn_params_from_jax

    out = []
    for net in NETS:
        npz = os.path.join(weights_dir, f"{net}.npz")
        pt = os.path.join(weights_dir, f"{net}.pt")
        if os.path.isfile(npz):
            with np.load(npz) as z:
                out.append(mtcnn_params_from_jax(net, _unflatten(dict(z))))
        elif os.path.isfile(pt):
            out.append(torch.load(pt, map_location="cpu", weights_only=True))
        else:
            raise FileNotFoundError(f"missing {npz} (or {pt})")
    return tuple(out)


def default_face_cropper(cfg: VisionPreprocConfig, device="cuda"
                         ) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """The batched MTCNN cropper of ``EAV_TPU_MTCNN_WEIGHTS``'s weights on
    ``device``, or None when the variable is unset or empty. A variable that
    names no weights raises (``FileNotFoundError``, or the load's error);
    the JAX package returns None there and center-crops."""
    device = resolve_device(device)
    weights_dir = os.environ.get("EAV_TPU_MTCNN_WEIGHTS", "")
    if not weights_dir:
        return None
    if not os.path.isdir(weights_dir):
        raise FileNotFoundError(f"EAV_TPU_MTCNN_WEIGHTS={weights_dir!r} is not a directory")
    det = MTCNNDetector(
        *load_mtcnn_params(weights_dir),
        min_face_size=cfg.mtcnn_min_face_size,
        thresholds=cfg.mtcnn_thresholds,
        factor=cfg.mtcnn_factor,
        face_size=cfg.face_image_size,
        device=device,
    )
    return functools.partial(det.crop_faces_batched, prob_threshold=cfg.face_prob_threshold)
