"""Build the package's native sources at first use, load them with ctypes.

Each ``csrc/<name>.cu`` (CUDA, compiled with nvcc) or ``csrc/<name>.cc``
(host C++, compiled with g++) exposes a plain C interface and becomes
``_build/lib<name>-<hash>.so``, where the hash covers the source and the
compiler flags: an edited source builds anew, an unchanged one is reused.
The compiler's report is kept beside it as ``lib<name>-<hash>.log``; for a
CUDA source that is ptxas's report of each kernel's registers and spills
(``resource_usage`` reads it). A CUDA build needs ``nvcc`` (from
``CUDA_HOME`` as PyTorch finds it) and targets Hopper (``sm_90a``). A host
build links zlib and pthreads, and libav (``-DEAV_HAVE_LIBAV``) when
``pkg-config`` finds its development files (``HOST_LIBAV_PACKAGES``).
Nothing here runs at import time. ``LOCK`` serialises the builds and the
loads within a process (the farm's workers reach them from threads of their
own).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
HOST_LIBS = ("-lz", "-lpthread")
HOST_LIBAV_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")

_loaded: Dict[str, ctypes.CDLL] = {}
_host_flags: List[Tuple[Tuple[str, ...], Tuple[str, ...]]] = []  # found once a process
LOCK = threading.RLock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); nvcc builds the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def host_flags() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, link flags) of a host build: ``HOST_FLAGS`` and
    ``HOST_LIBS``, plus ``-DEAV_HAVE_LIBAV`` and libav's own flags when
    ``pkg-config --exists`` finds every package of ``HOST_LIBAV_PACKAGES``."""
    with LOCK:
        if not _host_flags:
            cflags, libs = HOST_FLAGS, HOST_LIBS
            try:
                found = subprocess.run(("pkg-config", "--exists", *HOST_LIBAV_PACKAGES),
                                       capture_output=True).returncode == 0
            except FileNotFoundError:  # no pkg-config: no libav
                found = False
            if found:
                def pkg(what):
                    return tuple(subprocess.run(("pkg-config", what, *HOST_LIBAV_PACKAGES),
                                                check=True, capture_output=True,
                                                text=True).stdout.split())

                cflags = (*cflags, "-DEAV_HAVE_LIBAV", *pkg("--cflags"))
                libs = (*libs, *pkg("--libs"))
            _host_flags.append((cflags, libs))
        return _host_flags[0]


def _source(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def _flags(src: Path) -> Tuple[str, ...]:
    if src.suffix == ".cu":
        return NVCC_FLAGS
    cflags, libs = host_flags()
    return (*cflags, *libs)


def _command(src: Path, out: Path) -> Tuple[str, ...]:
    if src.suffix == ".cu":
        return (nvcc(), *NVCC_FLAGS, "-o", str(out), str(src))
    cflags, libs = host_flags()
    return ("g++", *cflags, "-o", str(out), str(src), *libs)  # libraries after the source


def library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cc`` unless its library exists.
    Writes to a temporary name and renames, so a process building at the
    same time never loads a partial library. Raises with the compiler's
    output if it fails: nothing falls back to another path."""
    path = library_path(name)
    with LOCK:
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _source(name)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = _command(src, tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{Path(cmd[0]).name} {src.name} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
        return path


def resource_usage(name: str) -> Dict[str, Tuple[int, int]]:
    """``{"kernel<D>": (registers, spill store bytes)}`` of the built
    ``csrc/<name>.cu`` from ptxas's report (building it first if needed); a
    kernel's causal instantiation is ``"kernel<D,causal>"``."""
    report = build(name).with_suffix(".log").read_text()
    usage, kernel, spills = {}, None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d(flash_\w+?)ILi(\d+)E(Lb1E)?", line)
        if entry:
            kernel = f"{entry.group(1)}<{entry.group(2)}{',causal' if entry.group(3) else ''}>"
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            spills = int(m.group(1))
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            usage[kernel] = (int(m.group(1)), spills)
            kernel, spills = None, 0
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>``, built first if needed."""
    with LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
