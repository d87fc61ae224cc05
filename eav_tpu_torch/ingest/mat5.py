"""Minimal MATLAB v5 (.mat) reader for EAV EEG files.

A copy of ``eav_tpu/ingest/mat5.py`` (numpy and zlib only). The reference
uses scipy.io.loadmat to read the per-subject ``*_eeg.mat`` /
``*_eeg_label.mat`` files (`Dataload_eeg.py:70-77`). This reader covers the
subset EAV needs — numeric N-D arrays (miMATRIX / mxDOUBLE/mxSINGLE/int
classes), including zlib-compressed elements — parsed straight into numpy
arrays (Fortran-order, as MATLAB stores them). Unlike the JAX package's
reader, it does not pad a compressed element to 8 bytes, so it reads a file
of several compressed variables (``scipy.io.savemat(...,
do_compression=True)``).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Dict

import numpy as np

_MI_INT8, _MI_UINT8, _MI_INT16, _MI_UINT16, _MI_INT32, _MI_UINT32 = 1, 2, 3, 4, 5, 6
_MI_SINGLE, _MI_DOUBLE = 7, 9
_MI_INT64, _MI_UINT64 = 12, 13
_MI_MATRIX, _MI_COMPRESSED, _MI_UTF8 = 14, 15, 16

_MI_DTYPES = {
    _MI_INT8: np.int8,
    _MI_UINT8: np.uint8,
    _MI_INT16: np.int16,
    _MI_UINT16: np.uint16,
    _MI_INT32: np.int32,
    _MI_UINT32: np.uint32,
    _MI_SINGLE: np.float32,
    _MI_DOUBLE: np.float64,
    _MI_INT64: np.int64,
    _MI_UINT64: np.uint64,
}

# mxCLASS -> numpy dtype for the numeric classes we support
_MX_DTYPES = {
    6: np.float64,  # mxDOUBLE_CLASS
    7: np.float32,  # mxSINGLE_CLASS
    8: np.int8,
    9: np.uint8,
    10: np.int16,
    11: np.uint16,
    12: np.int32,
    13: np.uint32,
    14: np.int64,
    15: np.uint64,
}


def _read_element(buf: io.BytesIO):
    """Read one data element (tag + payload), handling small-element format.
    Returns (mi_type, raw_bytes) or None at EOF."""
    tag = buf.read(8)
    if len(tag) < 8:
        return None
    mi_type, nbytes = struct.unpack("<II", tag)
    if mi_type >> 16:  # small element: type/len packed into one word
        nbytes = mi_type >> 16
        mi_type = mi_type & 0xFFFF
        data = tag[4 : 4 + nbytes]
        return mi_type, data
    data = buf.read(nbytes)
    # elements are padded to 8-byte boundaries, except compressed ones (a
    # second compressed variable starts right after the first's bytes)
    pad = (-nbytes) % 8
    if pad and mi_type != _MI_COMPRESSED:
        buf.read(pad)
    return mi_type, data


def _parse_matrix(data: bytes):
    """Parse a miMATRIX payload -> (name, ndarray) or (name, None) if
    unsupported class."""
    buf = io.BytesIO(data)
    # array flags
    _, flags_raw = _read_element(buf)
    mx_class = flags_raw[0]
    # dimensions
    _, dims_raw = _read_element(buf)
    dims = np.frombuffer(dims_raw, dtype=np.int32)
    # name
    _, name_raw = _read_element(buf)
    name = name_raw.rstrip(b"\x00").decode("latin1")
    if mx_class not in _MX_DTYPES:
        return name, None
    # real part
    mi_type, real_raw = _read_element(buf)
    arr = np.frombuffer(real_raw, dtype=_MI_DTYPES[mi_type])
    # MATLAB stores column-major; expose the logical shape
    arr = arr.reshape(tuple(int(d) for d in dims), order="F")
    out_dtype = _MX_DTYPES[mx_class]
    if arr.dtype != out_dtype:
        arr = arr.astype(out_dtype)
    return name, arr


def loadmat(path: str) -> Dict[str, np.ndarray]:
    """Load numeric variables from a MATLAB v5 .mat file.

    Equivalent (for EAV's files) to ``scipy.io.loadmat`` minus the metadata
    keys. Compressed (miCOMPRESSED) elements are inflated with zlib.
    """
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        header = f.read(128)
        if len(header) < 128:
            raise ValueError(f"{path}: truncated .mat header")
        version, endian = struct.unpack("<HH", header[124:128])
        if endian != 0x4D49:  # 'IM' little-endian
            raise NotImplementedError(f"{path}: big-endian .mat not supported")
        body = io.BytesIO(f.read())
    while True:
        el = _read_element(body)
        if el is None:
            break
        mi_type, raw = el
        if mi_type == _MI_COMPRESSED:
            raw = zlib.decompress(raw)
            inner = io.BytesIO(raw)
            el2 = _read_element(inner)
            if el2 is None:
                continue
            mi_type, raw = el2
        if mi_type == _MI_MATRIX:
            name, arr = _parse_matrix(raw)
            if arr is not None:
                out[name] = arr
    return out


def savemat(path: str, variables: Dict[str, np.ndarray]) -> None:
    """Write numeric arrays as an (uncompressed) MATLAB v5 file.

    Used by tests and the synthetic-subject generator to produce files that
    both this reader and scipy can load.
    """
    def element(mi_type: int, payload: bytes) -> bytes:
        pad = (-len(payload)) % 8
        return struct.pack("<II", mi_type, len(payload)) + payload + b"\x00" * pad

    with open(path, "wb") as f:
        desc = b"MATLAB 5.0 MAT-file, created by eav_tpu_torch"
        f.write(desc + b" " * (116 - len(desc)))
        f.write(b"\x00" * 8)  # subsys offset
        f.write(struct.pack("<HH", 0x0100, 0x4D49))
        for name, arr in variables.items():
            arr = np.asarray(arr)
            if arr.dtype == np.float64:
                mx_class, mi = 6, _MI_DOUBLE
            elif arr.dtype == np.float32:
                mx_class, mi = 7, _MI_SINGLE
            elif arr.dtype == np.int32:
                mx_class, mi = 12, _MI_INT32
            else:
                arr = arr.astype(np.float64)
                mx_class, mi = 6, _MI_DOUBLE
            flags = element(_MI_UINT32, struct.pack("<II", mx_class, 0))
            dims = element(
                _MI_INT32, np.asarray(arr.shape, dtype=np.int32).tobytes()
            )
            name_el = element(_MI_INT8, name.encode("latin1"))
            data_el = element(mi, arr.tobytes(order="F"))
            payload = flags + dims + name_el + data_el
            f.write(element(_MI_MATRIX, payload))
