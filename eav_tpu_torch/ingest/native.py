"""ctypes bindings of the port's native ingest library (``csrc/eav_ingest.cc``),
under the names of ``eav_tpu/ingest/native.py``: ``available``, ``read_wav``,
``read_mat_var``, ``mp4_supported``, ``read_mp4_strided`` and
``WavPrefetcher``.

The library is built at first use by ``ops/build.py`` (g++, zlib, pthreads,
and libav when ``pkg-config`` finds its development files) into
``eav_tpu_torch/_build/``. Where the JAX package swallows a failed build and
falls back to its Python readers, a failed compile raises here with g++'s
output: only a host without a C++ compiler has no native library
(``available()`` is False there, and the callers read with the pure-Python
``ingest/wav.py`` and ``ingest/mat5.py``, which are also the tests' oracle).
The MP4 decoder exists only in a build with libav (``mp4_supported``).
"""

from __future__ import annotations

import ctypes
import shutil
from typing import Iterator, Tuple

import numpy as np

from eav_tpu_torch.ops import build

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # name -> (restype, argtypes)
    "eav_last_error": (ctypes.c_char_p, []),
    "eav_free": (None, [ctypes.c_void_p]),
    "eav_read_wav": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_F32P),
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
                                    ctypes.POINTER(ctypes.c_int)]),
    "eav_read_mat_var": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                                        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                                        ctypes.POINTER(ctypes.c_int)]),
    "eav_prefetch_create": (ctypes.c_void_p, [ctypes.c_int]),
    "eav_prefetch_submit": (None, [ctypes.c_void_p, ctypes.c_char_p]),
    "eav_prefetch_pop": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                        ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_long),
                                        ctypes.POINTER(ctypes.c_int)]),
    "eav_prefetch_destroy": (None, [ctypes.c_void_p]),
    "eav_mp4_supported": (ctypes.c_int, []),
    "eav_mp4_probe": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]),
    "eav_read_mp4_strided_into": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p, ctypes.c_long,
                                                 ctypes.POINTER(ctypes.c_int),
                                                 ctypes.POINTER(ctypes.c_int),
                                                 ctypes.POINTER(ctypes.c_int)]),
}
_PATH_CAP = 4096  # bytes of a path popped from the prefetch queue


def _lib() -> ctypes.CDLL:
    """The built and typed library (built at first use; raises if g++ fails)."""
    with build.LOCK:
        lib = build.load("eav_ingest")
        if not getattr(lib, "_eav_typed", False):
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            lib._eav_typed = True
        return lib


def available() -> bool:
    """True when the library is built and loaded (building it now if it is
    not); False only on a host without g++. A failed compile raises."""
    if shutil.which("g++") is None:
        return False
    _lib()
    return True


def _error(lib) -> str:
    return lib.eav_last_error().decode()


def _copy_native(ptr, ctype, count: int, dtype) -> np.ndarray:
    """A numpy copy of a malloc'd native buffer of ``count`` elements, as one
    memcpy (``np.ctypeslib.as_array(...).copy()`` converts element by
    element, far slower on a subject's buffers)."""
    if count == 0:
        return np.empty(0, dtype)
    view = ctypes.cast(ptr, ctypes.POINTER(ctype * count)).contents
    return np.frombuffer(view, dtype=dtype, count=count).copy()


def _planar(lib, data, channels, samples) -> np.ndarray:
    """(channels, samples) float32 from a native WAV buffer, which is freed."""
    n = channels.value * samples.value
    try:
        return _copy_native(data, ctypes.c_float, n, np.float32).reshape(
            channels.value, samples.value)
    finally:
        lib.eav_free(data)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(waveform (channels, samples) float32, sample rate), as
    ``ingest/wav.read_wav`` returns them."""
    lib = _lib()
    data, channels, samples, rate = _F32P(), ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    if lib.eav_read_wav(path.encode(), ctypes.byref(data), ctypes.byref(channels),
                        ctypes.byref(samples), ctypes.byref(rate)) != 0:
        raise IOError(f"{path}: {_error(lib)}")
    return _planar(lib, data, channels, samples), rate.value


def read_mat_var(path: str, name: str) -> np.ndarray:
    """The numeric variable ``name`` of a v5 ``.mat`` file as float64, in
    its MATLAB shape. Raises ``IOError`` when the file holds no such
    variable."""
    lib = _lib()
    data = ctypes.POINTER(ctypes.c_double)()
    dims = ctypes.POINTER(ctypes.c_int64)()
    ndims = ctypes.c_int()
    if lib.eav_read_mat_var(path.encode(), name.encode(), ctypes.byref(data),
                            ctypes.byref(dims), ctypes.byref(ndims)) != 0:
        raise IOError(f"{path}: {_error(lib)}")
    try:
        shape = tuple(int(dims[i]) for i in range(ndims.value))
        flat = _copy_native(data, ctypes.c_double, int(np.prod(shape)), np.float64)
    finally:
        lib.eav_free(data)
        lib.eav_free(dims)
    return flat.reshape(shape, order="F")


def mp4_supported() -> bool:
    """Whether the library was built with libav (its MP4 decoder)."""
    return available() and bool(_lib().eav_mp4_supported())


def read_mp4_strided(path: str, stride: int = 6, max_frames: int = 600) -> np.ndarray:
    """Frames 0, stride, 2*stride, ... < max_frames of the first video
    stream -> (n, H, W, 3) uint8 RGB, decoded by libav without the GIL
    (every frame is decoded, as inter-frame codecs need, and only the kept
    ones are converted). The frames are written straight into a numpy
    buffer sized from the header probe. Raises ``IOError`` on a file libav
    cannot decode, ``RuntimeError`` in a build without libav."""
    if stride <= 0 or max_frames <= 0:
        raise ValueError(f"stride {stride} and max_frames {max_frames} must be positive")
    lib = _lib()
    if not lib.eav_mp4_supported():
        raise RuntimeError("the native ingest library was built without libav "
                           "(its MP4 decoder needs the ffmpeg development files)")
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.eav_mp4_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"{path}: {_error(lib)}")
    probed = (h.value, w.value)
    out = np.empty((-(-max_frames // stride), *probed, 3), np.uint8)
    n = ctypes.c_int()
    if lib.eav_read_mp4_strided_into(path.encode(), stride, max_frames,
                                     out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                                     ctypes.byref(n), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"{path}: {_error(lib)}")
    if (h.value, w.value) != probed:  # never reshape frames to the wrong geometry
        raise IOError(f"{path}: decoded {h.value}x{w.value} frames, probed "
                      f"{probed[0]}x{probed[1]}")
    return out[: n.value]


class WavPrefetcher:
    """A native queue of WAV decodes on ``n_threads`` threads: ``submit``
    paths, then iterate (path, waveform, rate) in completion order."""

    def __init__(self, n_threads: int = 4):
        self._q = None
        if n_threads < 1:
            raise ValueError(f"n_threads {n_threads} < 1")
        self._lib = _lib()
        self._q = self._lib.eav_prefetch_create(n_threads)
        self._pending = 0

    def submit(self, path: str) -> None:
        if self._q is None:
            raise RuntimeError("the prefetcher is closed")
        self._lib.eav_prefetch_submit(self._q, path.encode())
        self._pending += 1

    def pop(self) -> Tuple[str, np.ndarray, int]:
        if self._pending <= 0:
            raise RuntimeError("no pending jobs")
        buf = ctypes.create_string_buffer(_PATH_CAP)
        data, channels, samples, rate = _F32P(), ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
        rc = self._lib.eav_prefetch_pop(self._q, buf, _PATH_CAP, ctypes.byref(data),
                                        ctypes.byref(channels), ctypes.byref(samples),
                                        ctypes.byref(rate))
        self._pending -= 1
        path = buf.value.decode()
        if rc != 0:
            raise IOError(f"{path}: {_error(self._lib)}")
        return path, _planar(self._lib, data, channels, samples), rate.value

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, int]]:
        while self._pending > 0:
            yield self.pop()

    def close(self) -> None:
        """Stops the threads; decodes not yet popped are freed."""
        if self._q is not None:
            self._lib.eav_prefetch_destroy(self._q)
            self._q = None

    def __enter__(self) -> "WavPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
