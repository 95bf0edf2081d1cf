"""Kernel B3: the fused displacement measurement, hand-written CUDA
(``csrc/measure_displacement.cu``).

Replaces ``subpixal_tpu/kernels/measure.py · measure_displacement_rank3``.
The plain version is :func:`subpixal_tpu_torch.ops.correlate.measure_window`
(``torch.fft`` and small matrix DFTs). :func:`find_displacement` is the
plain one with this wrapper as its windowed measurement; the package
exports it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.correlate import Displacement
from ..ops.correlate import find_displacement as _find_displacement
from ..ops.correlate import measure_window as _plain
from ..ops.correlate import window_fits
from . import LAUNCHES, _launches
from ._build import load

__all__ = ["measure_window", "find_displacement", "kernel_route", "Route"]

#: normalisation mode -> code understood by csrc/measure_displacement.cu
_CC, _NCC_MASKED, _NCC_SPECTRAL = 0, 1, 2

_VP = ctypes.c_void_p
_PLAN = ctypes.c_int * 4

#: kernel names, in the order of measure_window_plan's codes
_KERNELS = ("fft", "mixed_radix")


def _lib():
    lib = load("measure_displacement")
    fn = lib.measure_window_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([_VP] * 4 + [ctypes.c_int] * 10 + [_VP] * 3
                       + [ctypes.POINTER(ctypes.c_int)] + [_VP] * 5)
        plan = lib.measure_window_plan
        plan.restype = ctypes.c_longlong
        plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    return lib


class Route(NamedTuple):
    """How the kernel measures a batch: ``kernel`` 'fft' (square 16, 32,
    64; two warps a pair, several pairs a block) or 'mixed_radix' (any
    shape; a cluster of ``cluster`` CTAs a pair), and whether the mixed
    kernel's buffers live in a global ``workspace`` (shapes too large for
    a cluster's shared memory)."""

    kernel: str
    cluster: int
    workspace: bool


def _kernel_code(kernel: str | None) -> int:
    if kernel is None:
        return -1
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected None, "
                         "'fft' or 'mixed_radix')")
    return _KERNELS.index(kernel)


@functools.lru_cache(maxsize=64)
def _plan(B: int, H: int, W: int, nwin: int, ny: int, nx: int, kernel: int,
          device: int):
    """(Route, floats of workspace to allocate, the launcher's plan) on
    CUDA device ``device``; ``kernel`` -1 picks by shape."""
    plan = _PLAN()
    with torch.cuda.device(device):
        nws = _lib().measure_window_plan(B, H, W, nwin, ny, nx, kernel, plan)
    if nws < 0:
        which = "no kernel" if kernel < 0 else f"the {_KERNELS[kernel]} kernel"
        raise ValueError(f"measure_window: {which} takes {B} pairs of "
                         f"{H} x {W} at window {nwin}")
    route = Route(_KERNELS[plan[0]], int(plan[1]), bool(plan[2]))
    return route, int(nws), tuple(plan)


def kernel_route(B: int, H: int, W: int, nwin: int, bounds,
                 kernel: str | None = None) -> Route | None:
    """The route B (H, W) pairs take on the current CUDA device at window
    ``nwin`` and search box ``bounds`` (r0, r1, c0, c1): by shape, or
    through ``kernel`` when it is given (as :func:`measure_window`).
    None, by shape, where no kernel takes it
    (:func:`~subpixal_tpu_torch.ops.correlate.window_fits`):
    ``find_displacement`` then takes its full-surface chain."""
    r0, r1, c0, c1 = (int(v) for v in bounds)
    if kernel is None and not window_fits(H, W, int(nwin), r1 - r0,
                                          c1 - c0):
        return None
    return _plan(B, H, W, int(nwin), r1 - r0, c1 - c0, _kernel_code(kernel),
                 torch.cuda.current_device())[0]


@functools.lru_cache(maxsize=None)
def _consts(H: int, W: int, usfac: int, nwin: int, device: str):
    """Twiddle tables and window kernels, built in float64 and cast to f32
    (as ``_consts`` of the JAX kernel): ``cos, sin(2πj/H)`` then
    ``cos, sin(2πj/W)``; the (nwin, H) kernel ``exp(2πi f_u t_i / H)``;
    the (nwin, W//2+1) kernel ``exp(2πi f_v t_j / W)`` times the hermitian
    fold weights over H·W, with ``t_i = (i - nwin//2) / usfac``. Never
    evicted: the align loop's cached CUDA graph reads them by address."""
    Wr = W // 2 + 1
    ph = 2.0 * np.pi * np.arange(H) / H
    pw = 2.0 * np.pi * np.arange(W) / W
    tw = np.concatenate([np.cos(ph), np.sin(ph), np.cos(pw), np.sin(pw)])
    fy = np.round(np.fft.fftfreq(H) * H)
    fx = np.round(np.fft.fftfreq(W) * W)[:Wr]
    tf = (np.arange(nwin) - nwin // 2) / usfac
    wk = np.full(Wr, 2.0)
    wk[0] = 1.0
    if W % 2 == 0:
        wk[-1] = 1.0
    k2y = np.exp(2j * np.pi * np.outer(tf, fy) / H)
    k2x = np.exp(2j * np.pi * np.outer(tf, fx) / W) * wk / (H * W)

    def dev(*parts):
        flat = np.concatenate([np.ravel(p) for p in parts]).astype(np.float32)
        return torch.as_tensor(flat, device=device)

    return dev(tw), dev(k2y.real, k2y.imag), dev(k2x.real, k2x.imag)


def _masks(ref_mask, img_mask, shape, dev):
    """Both masks as the kernel reads them, and whether they are f32: bytes
    when every given mask is bool (the align loop's, read in place), else
    f32. None stays None (all ones) unless the other side has a mask;
    one mask given for both sides is passed once."""
    given = [m for m in (ref_mask, img_mask) if m is not None]
    for m in given:
        if m.device != dev:
            raise ValueError(f"measure_window: mask on {m.device}, data on "
                             f"{dev}")
    f32 = any(m.dtype != torch.bool for m in given)

    def conv(m):
        if m is None:
            return None
        m = torch.broadcast_to(m, shape)
        if f32:
            return m.to(torch.float32).contiguous()
        return m.contiguous().view(torch.uint8)

    rm = conv(ref_mask)
    im = rm if img_mask is ref_mask else conv(img_mask)
    if (rm is None) != (im is None):  # the kernel takes both or none
        ones = torch.ones(shape, dtype=torch.float32 if f32 else torch.uint8,
                          device=dev)
        rm, im = (ones, im) if rm is None else (rm, ones)
    return rm, im, int(f32)


def measure_window(ref: torch.Tensor, img: torch.Tensor,
                   ref_mask: torch.Tensor | None = None,
                   img_mask: torch.Tensor | None = None, *,
                   cc_type: str = "NCC", usfac: int, nwin: int,
                   bounds: tuple[int, int, int, int],
                   kernel: str | None = None,
                   use_pallas: bool | str = "auto"):
    """Upsampled correlation window of each (ref, img) cutout pair.

    Same contract as :func:`subpixal_tpu_torch.ops.correlate.measure_window`:
    returns ``(C2, s0y, s0x)``, the (B, nwin, nwin) window divided by H·W
    and sampled at ``s0 + (i - nwin//2) / usfac``, and the (B,) int32
    coarse shifts in signed-lag space.

    CPU tensors and ``use_pallas=False`` take the plain version. CUDA
    tensors (``ref``/``img`` contiguous float32 (B, H, W) on one device;
    masks of any type that broadcast to that shape, or None; bool masks
    are read in place as bytes) launch the kernel on the current stream;
    anything else raises, ``use_pallas=True`` off CUDA too.
    Square 16, 32 and 64 cutouts take the FFT kernel, every
    other shape the mixed-radix kernel (:func:`kernel_route`); ``kernel``
    'fft' or 'mixed_radix' asks for one of them (ValueError where it does
    not take the shape; the mixed-radix kernel takes every shape that
    :func:`~subpixal_tpu_torch.ops.correlate.window_fits` takes, and
    ``find_displacement`` calls it for no other).
    """
    if cc_type not in ("CC", "NCC", "ZNCC"):
        raise ValueError(
            f"unknown cc_type: {cc_type!r} (expected 'CC'|'NCC'|'ZNCC')")
    code = _kernel_code(kernel)
    dev = ref.device
    if not _launches(use_pallas, dev, "measure_window"):
        return _plain(ref, img, ref_mask, img_mask, cc_type=cc_type,
                      usfac=usfac, nwin=nwin, bounds=bounds)
    for t in (ref, img):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 3
                or t.shape != ref.shape):
            raise ValueError(
                "measure_window: ref and img must be contiguous float32 "
                "(B, H, W) tensors of one shape on one CUDA device; got "
                + ", ".join(f"{tuple(p.shape)} {p.dtype} {p.device}"
                            for p in (ref, img)))
    B, H, W = ref.shape
    r0, r1, c0, c1 = (int(v) for v in bounds)
    ny, nx = r1 - r0, c1 - c0
    if ny < 1 or nx < 1 or int(nwin) < 1 or int(usfac) < 1:
        raise ValueError(f"measure_window: empty search box {bounds} or "
                         f"window nwin={nwin}, usfac={usfac}")
    rm, im, mask_f32 = _masks(ref_mask, img_mask, ref.shape, dev)
    if cc_type == "CC":
        mode = _CC
    else:
        mode = _NCC_SPECTRAL if rm is None and im is None else _NCC_MASKED
    tw, k2y, k2x = _consts(H, W, int(usfac), int(nwin), str(dev))
    lib = _lib()
    _, nws, plan = _plan(B, H, W, int(nwin), ny, nx, code,
                         dev.index if dev.index is not None
                         else torch.cuda.current_device())
    ws = (torch.empty(nws, dtype=torch.float32, device=dev)
          if nws > 0 else None)
    c2 = torch.empty((B, nwin, nwin), dtype=torch.float32, device=dev)
    s0y = torch.empty(B, dtype=torch.int32, device=dev)
    s0x = torch.empty(B, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.measure_window_launch(
            ref.data_ptr(), img.data_ptr(), ptr(rm), ptr(im), mask_f32, B,
            H, W, mode, int(nwin), r0 - H // 2, c0 - W // 2, ny, nx,
            tw.data_ptr(), k2y.data_ptr(), k2x.data_ptr(), _PLAN(*plan),
            ptr(ws), c2.data_ptr(), s0y.data_ptr(), s0x.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"measure_window: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["measure_displacement"] += 1
    return c2, s0y, s0x


def find_displacement(ref: torch.Tensor, img: torch.Tensor,
                      cc_type: str = "NCC", usfac: int = 1,
                      peak_fit_box: int = 5, fit_type: str = "quadratic",
                      ref_mask: torch.Tensor | None = None,
                      img_mask: torch.Tensor | None = None,
                      peak_search_box="fitbox",
                      use_pallas: bool | str = "auto") -> Displacement:
    """:func:`subpixal_tpu_torch.ops.correlate.find_displacement` (the
    JAX package's ``find_displacement``, with its parameters and
    defaults) with its windowed ``usfac > 1`` measurement through
    :func:`measure_window` and its ``use_pallas``: kernel B3 on CUDA
    tensors, the plain version on CPU tensors and under
    ``use_pallas=False``; ``True`` off CUDA raises ``ValueError``."""
    _launches(use_pallas, ref.device, "find_displacement")
    return _find_displacement(
        ref, img, cc_type=cc_type, usfac=usfac, peak_fit_box=peak_fit_box,
        fit_type=fit_type, ref_mask=ref_mask, img_mask=img_mask,
        peak_search_box=peak_search_box,
        measure=functools.partial(measure_window, use_pallas=use_pallas))
