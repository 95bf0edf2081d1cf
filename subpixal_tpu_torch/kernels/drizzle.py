"""Kernel B1: the drizzle deposit, hand-written CUDA (``csrc/drizzle_deposit.cu``).

Replaces ``subpixal_tpu/kernels/drizzle.py · drizzle_deposit_pallas``.
The plain version is :func:`subpixal_tpu_torch.ops.drizzle.drizzle_deposit`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.drizzle import DRIZZLE_KERNELS, kernel_reach
from ..ops.drizzle import drizzle_deposit as _plain
from . import LAUNCHES
from ._build import load

__all__ = ["drizzle_deposit"]

#: kernel name -> code understood by csrc/drizzle_deposit.cu
_CODES = {"square": 0, "turbo": 0, "point": 1, "gaussian": 2,
          "lanczos2": 3, "lanczos3": 4, "tophat": 5}

_VP = ctypes.c_void_p


def _lib():
    lib = load("drizzle_deposit")
    fn = lib.drizzle_deposit_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([_VP] * 4 + [ctypes.c_longlong, _VP, _VP]
                       + [ctypes.c_int] * 4 + [ctypes.c_float] * 6 + [_VP])
    return fn


def drizzle_deposit(in_data: torch.Tensor, in_wht: torch.Tensor | None,
                    x_out: torch.Tensor, y_out: torch.Tensor,
                    out_shape: tuple[int, int], pixfrac: float = 1.0,
                    pscale_ratio: float = 1.0, kernel: str = "square"):
    """Deposit one input plane onto an output grid.

    Same contract as :func:`subpixal_tpu_torch.ops.drizzle.drizzle_deposit`
    plus an int32 ``escaped`` count: returns ``(sci_acc, wht_acc,
    escaped)``. The CUDA kernel has no static output tile, so no live
    pixel can escape one and ``escaped`` is 0 by construction (the JAX
    package's Pallas kernel counts the pixels its tiles missed).

    CPU tensors take the plain version. CUDA tensors (all float32,
    contiguous, on one device, ``in_wht`` may be None) launch the kernel
    on the current stream; anything else raises. Float sums are taken by
    atomics in an order that changes from run to run, so the result
    equals the plain version's to float rounding, not bit for bit.
    """
    if kernel not in DRIZZLE_KERNELS:
        raise ValueError(f"unknown kernel: {kernel!r} "
                         f"(expected one of {DRIZZLE_KERNELS})")
    dev = in_data.device
    if dev.type == "cpu":
        sci, wht = _plain(in_data, in_wht, x_out, y_out, out_shape,
                          pixfrac=pixfrac, pscale_ratio=pscale_ratio,
                          kernel=kernel)
        return sci, wht, torch.zeros((), dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"drizzle_deposit: unsupported device {dev}")
    planes = [in_data, x_out, y_out] + ([] if in_wht is None else [in_wht])
    for t in planes:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != in_data.shape
                or t.dim() != 2):
            raise ValueError(
                "drizzle_deposit: in_data, in_wht, x_out and y_out must be "
                "contiguous float32 (H, W) tensors on one CUDA device; got "
                + ", ".join(f"{tuple(p.shape)} {p.dtype} {p.device}"
                            for p in planes))
    Ho, Wo = (int(v) for v in out_shape)
    sci = torch.zeros((Ho, Wo), dtype=torch.float32, device=dev)
    wht = torch.zeros((Ho, Wo), dtype=torch.float32, device=dev)
    half = 0.5 * float(pixfrac) * float(pscale_ratio)
    s = max(float(pixfrac) * float(pscale_ratio), 1e-3)
    sigma = s / 2.3548
    reach = kernel_reach(kernel, pixfrac, pscale_ratio)
    K = int(math.ceil(2.0 * reach)) + 1
    fn = _lib()
    with torch.cuda.device(dev):
        rc = fn(in_data.data_ptr(),
                None if in_wht is None else in_wht.data_ptr(),
                x_out.data_ptr(), y_out.data_ptr(), in_data.numel(),
                sci.data_ptr(), wht.data_ptr(), Ho, Wo, _CODES[kernel], K,
                half, 4.0 * half * half, half * half, sigma * sigma, s,
                reach, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"drizzle_deposit: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["drizzle_deposit"] += 1
    return sci, wht, torch.zeros((), dtype=torch.int32, device=dev)
