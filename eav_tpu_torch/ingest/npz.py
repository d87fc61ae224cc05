"""Zero-copy ``.npz`` reader for the feature caches (a copy of
``eav_tpu/ingest/npz.py``, numpy only, through numpy's public header
readers).

``np.load`` on an ``.npz`` reads each member through ``zipfile`` in
Python-level chunks with a CRC32 per chunk, far below disk speed on a
multi-GB vision cache. ``np.savez`` writes members ZIP_STORED (uncompressed),
so each member's bytes sit contiguous in the file: parse the zip central
directory (metadata only), locate each member's data from its local header,
and return ``np.frombuffer`` views over one shared ``mmap``.

The returned arrays are READ-ONLY views (the mmap is kept alive through the
buffer-protocol base chain); callers that mutate must copy. Non-STORED
members (``np.savez_compressed``) fall back to the decompressing path;
object/pickled members are refused, as ``np.load``'s ``allow_pickle=False``
default does.
"""

from __future__ import annotations

import io
import mmap
import struct
import zipfile
from typing import Dict

import numpy as np
from numpy.lib import format as _npfmt

__all__ = ["fast_npz_load"]

_LOCAL_HEADER_FMT = "<HH"  # name length, extra length at offset 26 of the 30-byte header


def _member_view(mm: mmap.mmap, info: zipfile.ZipInfo) -> memoryview:
    """Memoryview of a ZIP_STORED member's raw bytes inside the mapped file."""
    hoff = info.header_offset
    nlen, elen = struct.unpack(_LOCAL_HEADER_FMT, mm[hoff + 26 : hoff + 30])
    doff = hoff + 30 + nlen + elen
    return memoryview(mm)[doff : doff + info.file_size]


def _array_from_view(view: memoryview) -> np.ndarray:
    """Parse one ``.npy`` member from its mapped bytes without copying."""
    # The mapped path skips zipfile's per-chunk CRC32 (that's the speedup),
    # so validate the member's npy magic at the computed offset — it catches
    # offset-arithmetic bugs and header corruption for free. Body bit-rot is
    # accepted as out of scope, same as np.load on an uncompressed .npy.
    if bytes(view[:6]) != b"\x93NUMPY":
        raise ValueError(
            "npz member does not start with the .npy magic at its computed "
            "data offset — corrupted archive or non-savez layout"
        )
    # header size: magic(6) + version(2) + a 2-byte (v1) or 4-byte (v2/v3)
    # little-endian header length — read exactly what the file declares
    # instead of guessing a cap (structured dtypes can have multi-KB headers)
    major = view[6]
    if major == 1:
        (hlen,) = struct.unpack("<H", view[8:10])
        start = 10 + hlen
    else:
        (hlen,) = struct.unpack("<I", view[8:12])
        start = 12 + hlen
    bio = io.BytesIO(view[:start].tobytes())
    # the public header readers: numpy versions differ in their private one
    version = _npfmt.read_magic(bio)
    read_header = _npfmt.read_array_header_1_0 if version == (1, 0) else _npfmt.read_array_header_2_0
    shape, fortran, dtype = read_header(bio)
    if dtype.hasobject:  # np.load's allow_pickle=False default: refuse
        raise ValueError(
            "Object arrays cannot be loaded via fast_npz_load (pickled "
            "payloads are refused, matching np.load's allow_pickle=False)"
        )
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(view, dtype=dtype, count=count, offset=start)
    # 0-d members return 0-d ndarray views, exactly like np.load
    return arr.reshape(shape, order="F" if fortran else "C")


def fast_npz_load(path: str) -> Dict[str, np.ndarray]:
    """Load every array in ``path`` as zero-copy views over one mmap.

    Drop-in for ``dict(np.load(path))`` on uncompressed archives; compressed
    members (savez_compressed) silently fall back to the decompressing path.
    """
    f = open(path, "rb")  # kept alive by the mmap; mmap kept alive by the arrays
    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(f) as z:
        for info in z.infolist():
            name = info.filename
            key = name[:-4] if name.endswith(".npy") else name
            if info.compress_type == zipfile.ZIP_STORED:
                out[key] = _array_from_view(_member_view(mm, info))
            else:  # compressed archive — decode this member the slow way
                out[key] = np.load(io.BytesIO(z.read(info)), allow_pickle=False)
    return out
