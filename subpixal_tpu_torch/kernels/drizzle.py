"""Kernel B1: the drizzle deposit, hand-written CUDA (``csrc/drizzle_deposit.cu``).

Replaces ``subpixal_tpu/kernels/drizzle.py · drizzle_deposit_pallas``.
The plain versions are :func:`subpixal_tpu_torch.ops.drizzle.drizzle_deposit`
and :func:`~subpixal_tpu_torch.ops.drizzle.drizzle_deposit_stack`. One
launch deposits a whole (E, H, W) stack, summed over the planes or (with
``per_plane=True``) into (E, Ho, Wo) planes; a single plane is the E = 1
call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.drizzle import DRIZZLE_KERNELS, kernel_reach
from ..ops.drizzle import drizzle_deposit_stack as _plain_stack
from . import LAUNCHES, _launches
from ._build import load

__all__ = ["drizzle_deposit", "drizzle_deposit_stack"]

#: kernel name -> code understood by csrc/drizzle_deposit.cu
_CODES = {"square": 0, "turbo": 0, "point": 1, "gaussian": 2,
          "lanczos2": 3, "lanczos3": 4, "tophat": 5}

#: the strip of the kernel's input tile (the JAX package's DEPOSIT_BLOCK,
#: 16 x 128) that one warp deposits, and the cells of slack its
#: shared-memory window keeps per axis for rotation
_STRIP = (2, 128)
_SLACK = 4
#: the largest window (sci + wht, f32) a warp may take: an eighth of 227 KB
_MAX_CELLS = 227 * 1024 // 64

_VP = ctypes.c_void_p


def _lib():
    lib = load("drizzle_deposit")
    fn = lib.drizzle_deposit_stack_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([_VP] * 4 + [ctypes.c_int] * 3 + [_VP] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [_VP, _VP])
    return fn


@functools.lru_cache(maxsize=None)
def _plane_params(kernel: str, pixfrac: float, ratios: tuple, device: str):
    """Per-plane parameters (K, half, norm, half2, sigma2, s, reach, 0) as
    a device f32 tensor, and each warp's shared-memory window in cells:
    the largest strip footprint of the planes, (2·r + K + slack) by
    (128·r + K + slack) cells for ratio r (the pixmap's scale). Never
    evicted: the align loop's cached CUDA graph reads it by address."""
    rows, cap = [], 1
    for r in ratios:
        half = 0.5 * pixfrac * r
        s = max(pixfrac * r, 1e-3)
        sigma = s / 2.3548
        reach = kernel_reach(kernel, pixfrac, r)
        K = 1 if kernel == "point" else int(math.ceil(2.0 * reach)) + 1
        rows.append([K, half, 4.0 * half * half, half * half, sigma * sigma,
                     s, reach, 0.0])
        cap = max(cap, (math.ceil(_STRIP[0] * r) + K + _SLACK)
                  * (math.ceil(_STRIP[1] * r) + K + _SLACK))
    prm = torch.as_tensor(np.asarray(rows, np.float32), device=device)
    return prm, min(cap, _MAX_CELLS)


def _deposit_stack(in_data, in_wht, x_out, y_out, out_shape, pixfrac,
                   pscale_ratio, kernel, direct_strips=None, per_plane=False,
                   use_pallas="auto"):
    """Launch the kernel on a CUDA stack (the plain version on CPU
    tensors or under ``use_pallas=False``); ``direct_strips`` is None or
    an int32 CUDA tensor of one element to which the kernel adds each
    2 x 128 strip that took the direct global-atomics path."""
    if kernel not in DRIZZLE_KERNELS:
        raise ValueError(f"unknown kernel: {kernel!r} "
                         f"(expected one of {DRIZZLE_KERNELS})")
    dev = in_data.device
    ratios = tuple(float(r) for r in pscale_ratio)
    if not _launches(use_pallas, dev, "drizzle_deposit"):
        sci, wht = _plain_stack(in_data, in_wht, x_out, y_out, out_shape,
                                pixfrac=pixfrac, pscale_ratio=ratios,
                                kernel=kernel, per_plane=per_plane)
        return sci, wht, torch.zeros(len(ratios), dtype=torch.int32,
                                     device=sci.device)
    planes = [in_data, x_out, y_out] + ([] if in_wht is None else [in_wht])
    for t in planes:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != in_data.shape
                or t.dim() != 3):
            raise ValueError(
                "drizzle_deposit: in_data, in_wht, x_out and y_out must be "
                "contiguous float32 (E, H, W) tensors on one CUDA device; "
                "got " + ", ".join(f"{tuple(p.shape)} {p.dtype} {p.device}"
                                   for p in planes))
    E, H, W = in_data.shape
    if len(ratios) != E:
        raise ValueError(f"drizzle_deposit: {len(ratios)} pscale ratios for "
                         f"{E} planes")
    Ho, Wo = (int(v) for v in out_shape)
    prm, cap = _plane_params(kernel, float(pixfrac), ratios, str(dev))
    planes_out = (E,) if per_plane else ()
    acc = torch.zeros((2,) + planes_out + (Ho, Wo), dtype=torch.float32,
                      device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        rc = fn(in_data.data_ptr(),
                None if in_wht is None else in_wht.data_ptr(),
                x_out.data_ptr(), y_out.data_ptr(), E, H, W, prm.data_ptr(),
                acc[0].data_ptr(), acc[1].data_ptr(), Ho, Wo,
                Ho * Wo if per_plane else 0, _CODES[kernel], cap,
                None if direct_strips is None else direct_strips.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"drizzle_deposit: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["drizzle_deposit"] += 1
    return acc[0], acc[1], torch.zeros(E, dtype=torch.int32, device=dev)


def drizzle_deposit_stack(in_data: torch.Tensor, in_wht: torch.Tensor | None,
                          x_out: torch.Tensor, y_out: torch.Tensor,
                          out_shape: tuple[int, int], pixfrac: float = 1.0,
                          pscale_ratio=(1.0,), kernel: str = "square",
                          per_plane: bool = False,
                          use_pallas: bool | str = "auto"):
    """Deposit a stack of E input planes onto one output grid, in one
    kernel launch.

    Same contract as
    :func:`subpixal_tpu_torch.ops.drizzle.drizzle_deposit_stack` (one
    ``pscale_ratio`` per plane; ``per_plane=True`` returns each plane's
    own (E, Ho, Wo) accumulators instead of their sum) plus (E,) int32
    ``escaped`` counts: returns ``(sci_acc, wht_acc, escaped)``. The CUDA
    kernel has no static output tile, so no live pixel can escape one and
    ``escaped`` is 0 by construction (the JAX package's Pallas kernel
    counts the pixels its tiles missed).

    CPU tensors and ``use_pallas=False`` take the plain version. CUDA
    tensors (all float32, contiguous, (E, H, W), on one device; ``in_wht``
    may be None) launch the kernel on the current stream; anything else
    raises, ``use_pallas=True`` off CUDA too. Float sums
    are taken by atomics in an order that changes from run to run, so the
    result equals the plain version's to float rounding, not bit for bit.
    """
    return _deposit_stack(in_data, in_wht, x_out, y_out, out_shape, pixfrac,
                          pscale_ratio, kernel, per_plane=per_plane,
                          use_pallas=use_pallas)


def drizzle_deposit(in_data: torch.Tensor, in_wht: torch.Tensor | None,
                    x_out: torch.Tensor, y_out: torch.Tensor,
                    out_shape: tuple[int, int], pixfrac: float = 1.0,
                    pscale_ratio: float = 1.0, kernel: str = "square",
                    use_pallas: bool | str = "auto"):
    """Deposit one input plane onto an output grid: the E = 1 call of
    :func:`drizzle_deposit_stack` on (H, W) planes.

    Same contract as :func:`subpixal_tpu_torch.ops.drizzle.drizzle_deposit`
    plus an int32 ``escaped`` count (0 by construction): returns
    ``(sci_acc, wht_acc, escaped)``. CPU tensors and ``use_pallas=False``
    take the plain version; CUDA tensors launch the kernel or raise, as
    the stacked call does.
    """
    for t in (in_data, in_wht, x_out, y_out):
        if t is not None and t.dim() != 2:
            raise ValueError("drizzle_deposit: planes must be (H, W), got "
                             f"{tuple(t.shape)}")
    sci, wht, esc = _deposit_stack(
        in_data[None], None if in_wht is None else in_wht[None], x_out[None],
        y_out[None], out_shape, pixfrac, (pscale_ratio,), kernel,
        use_pallas=use_pallas)
    return sci, wht, esc[0]
