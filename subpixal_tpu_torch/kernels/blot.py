"""Kernel B2: the blot gather, hand-written CUDA (``csrc/blot_gather.cu``).

Replaces ``subpixal_tpu/kernels/blot.py · sample_cutouts_pallas``. The
plain version is :func:`subpixal_tpu_torch.ops.interp.sample_image` over
the whole (B, h, w) batch.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.interp import INTERP_TAPS, bspline3_prefilter, sample_image
from . import LAUNCHES, _launches
from ._build import load

__all__ = ["sample_cutouts"]

#: interpolant -> code understood by csrc/blot_gather.cu
_CODES = {"nearest": 0, "linear": 1, "poly3": 2, "poly5": 3,
          "spline3": 4, "sinc": 5}

_VP = ctypes.c_void_p


def _lib():
    lib = load("blot_gather")
    fn = lib.blot_gather_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_VP, ctypes.c_int, ctypes.c_int, _VP, _VP,
                       ctypes.c_longlong, _VP, _VP, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, _VP]
    return fn


def sample_cutouts(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   interp: str = "poly5", fill: float = 0.0,
                   prefiltered: bool = False, sinscl: float = 1.0,
                   row0: int = 0, use_pallas: bool | str = "auto"):
    """Sample ``image`` (H, W) at per-cutout coordinate grids (B, h, w).

    Returns ``(values, valid, escaped)``: values and validity with the
    shape of ``x`` (``valid`` False and ``fill`` where the interpolation
    footprint leaves the image), and a (B,) int32 count of pixels that
    escaped a static tile. The CUDA kernel has no tile, so ``escaped`` is
    zeros by construction (the JAX package's Pallas kernel counts the
    pixels its per-cutout tiles missed). ``spline3`` prefilters ``image``
    in plain torch first unless ``prefiltered``. ``sinscl`` scales the
    sinc's argument (``sinc(x / sinscl) · sinc(x / 3)``, as the plain
    version); the kernel takes it at run time, so one build serves every
    scale. ``row0`` is the row of ``y``'s frame at which ``image`` starts
    (a band of a larger plane): it is taken from ``floor(y)`` in integers,
    so the fraction stays the frame's own. The library is built under a
    hash of its source, so a checkout whose kernel changed rebuilds it on
    its first call.

    CPU tensors and ``use_pallas=False`` take the plain version. CUDA
    tensors (contiguous float32, on one device) launch the kernel on the
    current stream; anything else raises, ``use_pallas=True`` off CUDA
    too.
    """
    if interp not in INTERP_TAPS:
        raise ValueError(f"unknown interp: {interp!r} "
                         f"(expected one of {sorted(INTERP_TAPS)})")
    dev = image.device
    if x.dim() != 3 or y.shape != x.shape or image.dim() != 2:
        raise ValueError(
            f"sample_cutouts: image must be (H, W) and x, y (B, h, w); got "
            f"{tuple(image.shape)}, {tuple(x.shape)}, {tuple(y.shape)}")
    if not _launches(use_pallas, dev, "sample_cutouts"):
        vals, valid = sample_image(image, x, y, interp=interp, fill=fill,
                                   sinscl=sinscl, prefiltered=prefiltered,
                                   row0=row0)
        return vals, valid, torch.zeros(x.shape[0], dtype=torch.int32,
                                        device=x.device)
    for t in (image, x, y):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(
                "sample_cutouts: image, x and y must be contiguous float32 "
                "tensors on one CUDA device; got "
                + ", ".join(f"{p.dtype} {p.device}" for p in (image, x, y)))
    if interp == "spline3" and not prefiltered:
        image = bspline3_prefilter(image).contiguous()
    H, W = image.shape
    vals = torch.empty_like(x)
    valid = torch.empty(x.shape, dtype=torch.bool, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        rc = fn(image.data_ptr(), H, W, x.data_ptr(), y.data_ptr(),
                x.numel(), vals.data_ptr(), valid.data_ptr(), _CODES[interp],
                float(fill), float(sinscl), int(row0),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sample_cutouts: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["blot_gather"] += 1
    return vals, valid, torch.zeros(x.shape[0], dtype=torch.int32,
                                    device=dev)
