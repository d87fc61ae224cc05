"""Build the package's CUDA sources with nvcc at first use, load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes
``_build/lib<name>-<hash>.so``, where the hash covers the source and the
compiler flags: an edited source builds anew, an unchanged one is reused.
ptxas's report of each kernel's registers and spills is kept beside it as
``lib<name>-<hash>.log`` (``resource_usage`` reads it). The build needs
``nvcc`` (from ``CUDA_HOME`` as PyTorch finds it) and targets Hopper
(``sm_90a``). Nothing here runs at import time. ``LOCK`` serialises the
build and the load within a process (the farm's workers reach them from
threads of their own).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
LOCK = threading.RLock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); nvcc builds the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists. Writes to a
    temporary name and renames, so a process building at the same time never
    loads a partial library. Raises with the compiler output if nvcc fails."""
    path = library_path(name)
    with LOCK:
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = (nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu"))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc {name}.cu failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
        return path


def resource_usage(name: str) -> Dict[str, Tuple[int, int]]:
    """``{"kernel<D>": (registers, spill store bytes)}`` of the built
    ``csrc/<name>.cu`` from ptxas's report (building it first if needed)."""
    report = build(name).with_suffix(".log").read_text()
    usage, kernel, spills = {}, None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d(flash_\w+?)ILi(\d+)E", line)
        if entry:
            kernel = f"{entry.group(1)}<{entry.group(2)}>"
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            spills = int(m.group(1))
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            usage[kernel] = (int(m.group(1)), spills)
            kernel, spills = None, 0
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
