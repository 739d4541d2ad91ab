"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source ``cvssl_tpu_torch/csrc/<name>.cu`` exposes a plain C interface
(``extern "C"``). :func:`load` compiles it for ``sm_90a`` (Hopper) into a
shared library ``build/kernels/<name>-<source hash>.so`` at the repository
root, once per source hash, loads it and declares the C functions' argument
and result types, which the wrapper module gives as ``signatures``. A
pointer or a stream is ``ctypes.c_void_p``: undeclared, ctypes would pass it
as a 32-bit int and cut it.

Nothing is built when a module is imported: a wrapper calls :func:`load` at
its first launch, and ``chip_smoke.py`` calls it for every source at once,
in threads, so the ``nvcc`` processes run side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output (ptxas registers / shared memory / spills) of each build
BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCKS: dict[str, threading.Lock] = {}
_GUARD = threading.Lock()


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def _build(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    BUILD_LOGS[name] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed ({res.returncode}):\n"
                           f"{BUILD_LOGS[name]}")
    os.replace(tmp, so)
    return so


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if its source changed, with
    ``signatures`` ({function: (restype, [argtypes])}) declared. Threads
    that ask for the same library wait for one build."""
    with _GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _LIBS[name] = lib
        return _LIBS[name]
