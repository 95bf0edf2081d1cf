"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, for ``sm_90a``, into a
shared library with a plain C interface (no PyTorch headers: a build
takes seconds, not minutes). Libraries go to ``aot.aot_dir()`` (the
package's ``build/`` directory, or ``SUBPIXAL_TPU_AOT_DIR``) under a name
keyed by a hash of the source and the flags, so a stale library is never
loaded. Nothing is built at import time: the first
CUDA call of a wrapper builds what it needs, and :func:`build` starts one
``nvcc`` for every missing library at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> csrc source file
SOURCES = {
    "drizzle_deposit": "drizzle_deposit.cu",
    "blot_gather": "blot_gather.cu",
    "measure_displacement": "measure_displacement.cu",
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Where the library of kernel ``name`` is (or will be) built."""
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        tag = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    from ..aot import aot_dir

    return os.path.join(aot_dir(), f"{name}_{tag}.so")


def build(names=tuple(SOURCES)) -> dict[str, float]:
    """Build the missing libraries of ``names``, all nvcc runs in parallel.

    Returns the wall seconds of each build started (empty when all were
    already built). Raises ``RuntimeError`` with nvcc's output when a
    build fails.
    """
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.time())
    times, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate(timeout=600)
        times[name] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {SOURCES[name]}]\n{log.rstrip()}")
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
