"""Build and load the package's native libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
at the repository root, and loads through :mod:`ctypes`. The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited source
or header never loads a stale library. Nothing
builds at import: :func:`load` builds on first use, and :func:`build_all`
starts one ``nvcc`` per source at once.

The host flavour builds ``csrc/host/<name>.cpp`` with ``g++`` into
``build/host/lib<name>-<hash>.so``: :func:`load_host`. Its flags are the
source's own (:func:`host_flags`): the double-mapped ring and the Viterbi
loop take ``-O2``; ``mm`` adds ``-ffp-contract=off``, since its contract is
bit-equality with a Python loop that an FMA would break by an ulp; the
native fast chain takes ``-O3 -march=native``, whose FIR tiles rely on
auto-vectorization and on AVX-512 where the CPU has it, and keeps FMA
contraction (its contract is float32 rounding). The hash covers the source,
the headers ``csrc/host/*.h`` and the flags, and for ``-march=native`` the
CPU's feature flags, so a library built on another CPU never loads. A
library loads with :class:`ctypes.PyDLL`, whose calls keep the interpreter
lock, or with :class:`ctypes.CDLL` (``gil=False``), whose calls release it
(the fast chain runs a whole pipe in one call).
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

__all__ = ["SOURCES", "build_all", "load", "load_host", "library_path",
           "host_library_path", "host_flags"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fir", "fir_fft", "rotator", "poly_fir", "quad_demod", "pfb", "viterbi")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

HOST_CSRC = CSRC / "host"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
# the sources whose flags differ from HOST_FLAGS
HOST_SOURCE_FLAGS = {
    "mm": HOST_FLAGS + ("-ffp-contract=off",),
    "fastchain": ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared"),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[tuple, ctypes.CDLL] = {}


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


def host_flags(name: str) -> tuple:
    """The ``g++`` flags of ``csrc/host/<name>.cpp``."""
    return tuple(HOST_SOURCE_FLAGS.get(name, HOST_FLAGS))


def _cpu_flags() -> bytes:
    """This CPU's feature flags (the first ``flags`` line of
    ``/proc/cpuinfo``; empty where there is none)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def host_library_path(name: str) -> Path:
    """The library of ``csrc/host/<name>.cpp``, named by a hash of the
    source, the headers ``csrc/host/*.h``, the flags and, under
    ``-march=native``, the CPU's feature flags."""
    flags = host_flags(name)
    h = hashlib.sha1((HOST_CSRC / f"{name}.cpp").read_bytes())
    for header in sorted(HOST_CSRC.glob("*.h")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_cpu_flags())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _spawn(src: Path, out: Path, compiler: List[str]):
    """Start the compiler for one source; returns ``(src, out, tmp, proc)``,
    with ``proc`` None when the library is already built."""
    if out.exists():
        return src, out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [*compiler, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return src, out, tmp, proc


def _start(name: str):
    return _spawn(CSRC / f"{name}.cu", library_path(name), [_nvcc(), *FLAGS])


def _finish(src: Path, out: Path, tmp, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {src.relative_to(CSRC.parent)} "
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


def load_host(name: str, gil: bool = True) -> ctypes.CDLL:
    """The loaded host library for ``csrc/host/<name>.cpp``, built with
    ``g++`` (``CXX``) on first use with :func:`host_flags`. ``gil=False``
    loads it with :class:`ctypes.CDLL`, whose calls release the interpreter
    lock. Raises with the compiler's output if the build fails."""
    key = (name, gil)
    with _lock:
        lib = _host_libs.get(key)
        if lib is None:
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            path = _finish(*_spawn(HOST_CSRC / f"{name}.cpp", host_library_path(name),
                                   [cxx, *host_flags(name)]))
            lib = (ctypes.PyDLL if gil else ctypes.CDLL)(str(path))
            _host_libs[key] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(*_start(name))))
            _libs[name] = lib
        return lib
