"""ctypes loader for the host C++ connected-component labeling.

Counterpart of ``subpixal_tpu/_native.py``, carried into the port so that
importing it never loads JAX. ``csrc/labeling.cpp`` is host code, not a
TPU kernel: it is built with g++ on first use into the package's
``build/`` directory (keyed by a hash of the source and the machine, so a
stale or foreign binary is never loaded) and bound through ctypes. Every
entry point keeps the scipy/numpy path of the JAX package for a machine
without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_and_load() -> ctypes.CDLL | None:
    import hashlib
    import platform

    src = os.path.join(_CSRC, "labeling.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(
            f.read() + platform.machine().encode()).hexdigest()[:16]
    out = os.path.join(_BUILD, f"_subpixal_native_{tag}.so")
    try:
        if not os.path.exists(out):
            os.makedirs(_BUILD, exist_ok=True)
            # build under a private name, then rename: a concurrent
            # process never loads a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            src, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
    except (OSError, subprocess.SubprocessError):
        return None

    lib.label_components.restype = ctypes.c_int32
    lib.label_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.component_stats.restype = None
    lib.component_stats.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def label_components(mask: np.ndarray, connectivity: int = 8):
    """Label connected components of a boolean mask.

    Returns (labels int32 array, n_labels). Native two-pass union-find;
    falls back to scipy.ndimage.label when the native lib is unavailable.
    """
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    H, W = mask.shape
    lib = get_lib()
    if lib is not None:
        labels = np.zeros((H, W), np.int32)
        n = lib.label_components(_ptr(mask, ctypes.c_uint8), H, W,
                                 int(connectivity), _ptr(labels, ctypes.c_int32))
        return labels, int(n)
    from scipy import ndimage  # fallback

    structure = np.ones((3, 3)) if connectivity == 8 else None
    labels, n = ndimage.label(mask, structure=structure)
    return labels.astype(np.int32), int(n)


def component_stats(labels: np.ndarray, data: np.ndarray, n: int):
    """Per-component area/flux/centroid/bbox/peak.

    Returns a dict of arrays of length n (label l -> index l-1).
    """
    labels = np.ascontiguousarray(labels, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    H, W = labels.shape
    lib = get_lib()
    if lib is not None:
        area = np.zeros(n + 1, np.int64)
        flux = np.zeros(n + 1, np.float64)
        cx = np.zeros(n + 1, np.float64)
        cy = np.zeros(n + 1, np.float64)
        xmin = np.zeros(n + 1, np.int32)
        xmax = np.zeros(n + 1, np.int32)
        ymin = np.zeros(n + 1, np.int32)
        ymax = np.zeros(n + 1, np.int32)
        peak = np.zeros(n + 1, np.float32)
        lib.component_stats(
            _ptr(labels, ctypes.c_int32), _ptr(data, ctypes.c_float),
            H, W, n,
            _ptr(area, ctypes.c_int64), _ptr(flux, ctypes.c_double),
            _ptr(cx, ctypes.c_double), _ptr(cy, ctypes.c_double),
            _ptr(xmin, ctypes.c_int32), _ptr(xmax, ctypes.c_int32),
            _ptr(ymin, ctypes.c_int32), _ptr(ymax, ctypes.c_int32),
            _ptr(peak, ctypes.c_float),
        )
        sl = slice(1, n + 1)
        return dict(area=area[sl], flux=flux[sl], cx=cx[sl], cy=cy[sl],
                    xmin=xmin[sl], xmax=xmax[sl], ymin=ymin[sl],
                    ymax=ymax[sl], peak=peak[sl])
    # numpy fallback
    flat = labels.ravel()
    vals = data.ravel().astype(np.float64)
    idx = np.arange(flat.size)
    xs = (idx % W).astype(np.float64)
    ys = (idx // W).astype(np.float64)
    sel = flat > 0
    lab = flat[sel]
    area = np.bincount(lab, minlength=n + 1)[1:]
    flux = np.bincount(lab, weights=vals[sel], minlength=n + 1)[1:]
    cx = np.bincount(lab, weights=vals[sel] * xs[sel], minlength=n + 1)[1:]
    cy = np.bincount(lab, weights=vals[sel] * ys[sel], minlength=n + 1)[1:]
    safe = np.where(flux != 0, flux, 1.0)
    cx = cx / safe
    cy = cy / safe
    xmin = np.full(n, W, np.int32)
    xmax = np.full(n, -1, np.int32)
    ymin = np.full(n, H, np.int32)
    ymax = np.full(n, -1, np.int32)
    peak = np.full(n, -np.inf, np.float32)
    np.minimum.at(xmin, lab - 1, xs[sel].astype(np.int32))
    np.maximum.at(xmax, lab - 1, xs[sel].astype(np.int32))
    np.minimum.at(ymin, lab - 1, ys[sel].astype(np.int32))
    np.maximum.at(ymax, lab - 1, ys[sel].astype(np.int32))
    np.maximum.at(peak, lab - 1, data.ravel()[sel].astype(np.float32))
    # zero-flux components: the weighted centroid is undefined — fall
    # back to the bbox center, matching the native labeling.cpp path
    # (catalogs must not differ between machines with and without g++)
    zero = flux == 0
    if zero.any():
        cx[zero] = 0.5 * (xmin[zero] + xmax[zero])
        cy[zero] = 0.5 * (ymin[zero] + ymax[zero])
    return dict(area=area, flux=flux, cx=cx, cy=cy, xmin=xmin, xmax=xmax,
                ymin=ymin, ymax=ymax, peak=peak)
