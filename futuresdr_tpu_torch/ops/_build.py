"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
at the repository root, and loads through :mod:`ctypes`. The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited source
or header never loads a stale library. Nothing
builds at import: :func:`load` builds on first use, and :func:`build_all`
starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build_all", "load", "library_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fir", "fir_fft", "rotator", "poly_fir", "quad_demod", "pfb")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    shared headers ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(name, out, tmp, proc)``, with
    ``proc`` None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return name, out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a library
    return out


def build_all() -> List[Path]:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together. Raises with the compiler's output if any
    build fails."""
    with _lock:
        started = [_start(n) for n in SOURCES]
        errors, paths = [], []
        for item in started:
            try:
                paths.append(_finish(*item))
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(*_start(name))))
            _libs[name] = lib
        return lib
