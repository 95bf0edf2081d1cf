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

import numpy as np
import torch

from ..ops.correlate import Displacement
from ..ops.correlate import find_displacement as _find_displacement
from ..ops.correlate import measure_window as _plain
from . import LAUNCHES
from ._build import load

__all__ = ["measure_window", "find_displacement", "uses_fft_kernel"]

#: normalisation mode -> code understood by csrc/measure_displacement.cu
_CC, _NCC_MASKED, _NCC_SPECTRAL = 0, 1, 2

_VP = ctypes.c_void_p


def _lib():
    lib = load("measure_displacement")
    fn = lib.measure_window_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_VP] * 4 + [ctypes.c_int] * 10 + [_VP] * 8
        ws = lib.measure_window_workspace_floats
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 6
        route = lib.measure_window_route
        route.restype = ctypes.c_int
        route.argtypes = [ctypes.c_int] * 4
    return lib


def uses_fft_kernel(H: int, W: int, nwin: int, ny: int) -> bool:
    """Whether (H, W) cutouts at window ``nwin`` and ``ny`` coarse rows
    take the FFT kernel (square 16, 32, 64; two warps a pair) rather
    than the one-block-per-pair kernel; the launcher picks by shape."""
    return bool(_lib().measure_window_route(H, W, nwin, ny))


@functools.lru_cache(maxsize=16)
def _consts(H: int, W: int, usfac: int, nwin: int, device: str):
    """Twiddle tables and window kernels, built in float64 and cast to f32
    (as ``_consts`` of the JAX kernel): ``cos, sin(2πj/H)`` then
    ``cos, sin(2πj/W)``; the (nwin, H) kernel ``exp(2πi f_u t_i / H)``;
    the (nwin, W//2+1) kernel ``exp(2πi f_v t_j / W)`` times the hermitian
    fold weights over H·W, with ``t_i = (i - nwin//2) / usfac``."""
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
                   bounds: tuple[int, int, int, int]):
    """Upsampled correlation window of each (ref, img) cutout pair.

    Same contract as :func:`subpixal_tpu_torch.ops.correlate.measure_window`:
    returns ``(C2, s0y, s0x)``, the (B, nwin, nwin) window divided by H·W
    and sampled at ``s0 + (i - nwin//2) / usfac``, and the (B,) int32
    coarse shifts in signed-lag space.

    CPU tensors take the plain version. CUDA tensors (``ref``/``img``
    contiguous float32 (B, H, W) on one device; masks of any type that
    broadcast to that shape, or None; bool masks are read in place as
    bytes) launch the kernel on the current stream; anything else raises.
    Square 16, 32 and 64 cutouts take the FFT kernel, every
    other shape the one-block-per-pair kernel (:func:`uses_fft_kernel`).
    """
    if cc_type not in ("CC", "NCC", "ZNCC"):
        raise ValueError(
            f"unknown cc_type: {cc_type!r} (expected 'CC'|'NCC'|'ZNCC')")
    dev = ref.device
    if dev.type == "cpu":
        return _plain(ref, img, ref_mask, img_mask, cc_type=cc_type,
                      usfac=usfac, nwin=nwin, bounds=bounds)
    if dev.type != "cuda":
        raise ValueError(f"measure_window: unsupported device {dev}")
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
    nws = lib.measure_window_workspace_floats(B, H, W, int(nwin), ny, nx)
    ws = (torch.empty(int(nws), dtype=torch.float32, device=dev)
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
            tw.data_ptr(), k2y.data_ptr(), k2x.data_ptr(), ptr(ws),
            c2.data_ptr(), s0y.data_ptr(), s0x.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"measure_window: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["measure_displacement"] += 1
    return c2, s0y, s0x


def find_displacement(ref: torch.Tensor, img: torch.Tensor, *args,
                      **kw) -> Displacement:
    """:func:`subpixal_tpu_torch.ops.correlate.find_displacement` with its
    windowed ``usfac > 1`` measurement through :func:`measure_window`:
    kernel B3 on CUDA tensors, the plain version on CPU tensors."""
    return _find_displacement(ref, img, *args, measure=measure_window, **kw)
