"""Batched FFT cross-correlation and subpixel displacement — PyTorch.

Counterpart of ``subpixal_tpu/ops/correlate.py · find_displacement`` and
``cross_correlate``: plain (``'CC'``) and normalized (``'NCC'`` /
``'ZNCC'``) correlation of cutout pairs with masks, optional Fourier
(matrix-DFT) upsampling of the peak region by ``usfac``, and a
quadratic/Gaussian peak fit. Transforms are ``torch.fft`` (the JAX
package's CPU path is ``jnp.fft``; its TPU matmul-DFT and lane-packed
layouts have no counterpart on the card). The coarse integer peak under a
small search box is read from a windowed half-spectrum matrix DFT, and
the integer part of every DFT phase is reduced in int32 before any float
(:func:`_us_dft_kernel`), as in the reference. With ``usfac > 1``, such
a box and a shape kernel B3 takes (:func:`window_fits`, a pure function
of the shape, so every device takes one route) the whole measurement is
:func:`measure_window`, or the callable passed as
``find_displacement(measure=...)``: the align loop and the package's
public ``find_displacement`` pass kernel B3's wrapper
(:mod:`subpixal_tpu_torch.kernels.measure`).

Sign convention: ``find_displacement(ref, img)`` returns ``(dx, dy)``
such that ``img[y, x] ≈ ref[y - dy, x - dx]``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .._precision import full_f32
from .peaks import find_peak, normalize_search_box

__all__ = ["cross_correlate", "find_displacement", "measure_window",
           "window_fits", "window_route", "Displacement"]

#: largest search-window side whose coarse lags are evaluated by the
#: windowed matrix DFT instead of the full inverse transform
_WINDOWED_COARSE_MAX = 17

#: shared memory (floats) one CTA of kernel B3 may take: the H100's
#: 227 KiB a block (``csrc/measure_displacement.cu · kSmemOne``)
_B3_SMEM_FLOATS = 227 * 1024 // 4

#: floats of a B3 CTA's reduction scratch (``kRed``: 4 partial sums and
#: an argmax pair for each of 16 warps, 16 slots of cluster sums)
_B3_RED_FLOATS = 4 * 16 + 16 + 2 * 16


class Displacement(NamedTuple):
    """Batched displacement: ``dx``/``dy`` shift of img vs ref (pixels),
    correlation ``peak`` value and ``fit_ok`` (False = integer fallback)."""

    dx: torch.Tensor
    dy: torch.Tensor
    peak: torch.Tensor
    fit_ok: torch.Tensor


def _normalize(a: torch.Tensor, mask, cc_type: str) -> torch.Tensor:
    """One side of the correlation: raw masked data for 'CC'; for
    'NCC'/'ZNCC' the masked mean removed and scaled by the masked std and
    sqrt(N), so identical cutouts peak at ~1."""
    a = a.to(torch.float32)
    m = (torch.ones_like(a) if mask is None
         else torch.broadcast_to(mask, a.shape).to(torch.float32))
    a = a * m
    if cc_type == "CC":
        return a
    if cc_type in ("NCC", "ZNCC"):
        n = torch.clamp(m.sum(dim=(-2, -1), keepdim=True), min=1.0)
        mean = a.sum(dim=(-2, -1), keepdim=True) / n
        d = (a - mean) * m
        var = (d * d).sum(dim=(-2, -1), keepdim=True) / n
        sigma = torch.sqrt(torch.clamp(var, min=1e-20))
        return d / (sigma * torch.sqrt(n))
    raise ValueError(
        f"unknown cc_type: {cc_type!r} (expected 'CC'|'NCC'|'ZNCC')")


@functools.lru_cache(maxsize=None)
def _hermitian_weights(W: int, device) -> torch.Tensor:
    """(W//2+1,) fold weights: interior half-spectrum columns count twice
    (their conjugates are the missing half), v=0 and an even W's Nyquist
    column once. Built once per (W, device) and never evicted: a copy from
    the host on every call could not be captured in a CUDA graph, and a
    cached graph reads it by address."""
    wv = np.full((W // 2 + 1,), 2.0, np.float32)
    wv[0] = 1.0
    if W % 2 == 0:
        wv[-1] = 1.0
    return torch.as_tensor(wv, device=device)


def _spectral_ncc_product(ref, img):
    """Unmasked-NCC cross-spectrum computed in the Fourier domain: the
    mean removal only zeroes the DC bin and the per-side scale follows
    from Parseval on the DC-free half-spectrum power."""
    H, W = ref.shape[-2:]
    n = float(H * W)
    R = torch.fft.rfft2(ref.to(torch.float32))
    I = torch.fft.rfft2(img.to(torch.float32))  # noqa: E741
    Rr, Ri, Ir, Ii = R.real, R.imag, I.real, I.imag
    wk = _hermitian_weights(W, ref.device)

    def dc_free_power(Xr, Xi):
        p = torch.sum(wk * (Xr * Xr + Xi * Xi), dim=(-2, -1))
        return p - Xr[..., 0, 0] ** 2

    scale = (n * torch.rsqrt(torch.clamp(dc_free_power(Rr, Ri), min=1e-20))
             * torch.rsqrt(torch.clamp(dc_free_power(Ir, Ii), min=1e-20)))
    scale = scale[..., None, None]
    Gr = (Ir * Rr + Ii * Ri) * scale
    Gi = (Ii * Rr - Ir * Ri) * scale
    Gr[..., 0, 0] = 0.0  # both sides' means removed: no DC
    return torch.complex(Gr, Gi)


def _cross_spectrum(ref, img, cc_type, ref_mask, img_mask):
    """rfft2 half-spectrum of the correlation, fft2(img)*conj(fft2(ref))."""
    if (cc_type in ("NCC", "ZNCC") and ref_mask is None
            and img_mask is None):
        return _spectral_ncc_product(ref, img)
    r = _normalize(ref, ref_mask, cc_type)
    i = _normalize(img, img_mask, cc_type)
    return torch.fft.rfft2(i) * torch.conj(torch.fft.rfft2(r))


@full_f32()
def cross_correlate(ref, img, cc_type: str = "NCC", ref_mask=None,
                    img_mask=None, shift_output: bool = True):
    """Circular cross-correlation surface(s) of ``img`` against ``ref``
    ((B, H, W) or (H, W)); fftshifted by default so zero shift peaks at
    ``(H//2, W//2)``."""
    squeeze = ref.dim() == 2
    ref_b = ref[None] if squeeze else ref
    img_b = img[None] if squeeze else img
    G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)
    cc = torch.fft.irfft2(G, s=tuple(ref_b.shape[-2:]))
    if shift_output:
        cc = torch.fft.fftshift(cc, dim=(-2, -1))
    return cc[0] if squeeze else cc


def _us_dft_kernel(s0: torch.Tensor, tfrac: torch.Tensor, nfreq: int,
                   period: int):
    """``K[b, i, u] = exp(+2πi f_u (s0_b + tfrac_i) / P)`` as (re, im),
    with ``f_u`` the first ``nfreq`` signed FFT frequencies of length
    ``period``. The integer part of the phase, ``(f_u * s0_b) mod P``, is
    reduced in exact int32 arithmetic, so float32 only ever sees phases
    of a few cycles."""
    dev = tfrac.device
    # the signed FFT frequencies, built on the device (no host copy)
    k = torch.arange(nfreq, dtype=torch.int32, device=dev)
    f = torch.where(k < (period + 1) // 2, k, k - period)
    int_ph = torch.remainder(f[None, :] * s0[:, None].to(torch.int32), period)
    int_ph = int_ph.to(torch.float32) / period                    # (B, U)
    frac_ph = (f.to(torch.float32)[None, :] / period) * tfrac[:, None]
    phase = int_ph[:, None, :] + frac_ph[None, :, :]            # (B, n, U)
    ang = (2.0 * math.pi) * (phase - torch.round(phase))
    return torch.cos(ang), torch.sin(ang)


def _window_dft(Gr, Gi, Kyr, Kyi, Kxr, Kxi):
    """``Re{Ky @ G @ Kxᵀ}`` over the batch: stage 1 as the 3-multiply
    complex product, stage 2 real-only (only the real part is used)."""
    P1 = torch.einsum("iu,buv->biv", Kyr, Gr)
    P2 = torch.einsum("iu,buv->biv", Kyi, Gi)
    P3 = torch.einsum("iu,buv->biv", Kyr + Kyi, Gr + Gi)
    return (torch.einsum("jv,biv->bij", Kxr, P1 - P2)
            - torch.einsum("jv,biv->bij", Kxi, P3 - P1 - P2))


def _upsampled_correlation(G, s0y, s0x, usfac: int, nwin: int, H: int,
                           W: int):
    """Matrix-DFT upsampled correlation window (B, nwin, nwin) around the
    integer shift (s0y, s0x), sampled at ``s0 + (i - nwin//2)/usfac``.
    The per-cutout integer shift is a diagonal phase twist of the
    half-spectrum; the window kernels are shared by the whole batch."""
    dev = G.device
    tf = (torch.arange(nwin, dtype=torch.float32, device=dev)
          - nwin // 2) / usfac
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    Kyr, Kyi = (a[0] for a in _us_dft_kernel(zero, tf, H, H))
    Kxr, Kxi = (a[0] for a in _us_dft_kernel(zero, tf, W // 2 + 1, W))
    nul = torch.zeros(1, dtype=torch.float32, device=dev)
    Dyr, Dyi = (a[:, 0] for a in _us_dft_kernel(s0y, nul, H, H))
    Dxr, Dxi = (a[:, 0] for a in _us_dft_kernel(s0x, nul, W // 2 + 1, W))
    Dy = torch.complex(Dyr, Dyi)
    Dx = torch.complex(Dxr, Dxi) * _hermitian_weights(W, dev)
    Gd = G * Dy[:, :, None] * Dx[:, None, :]
    C = _window_dft(Gd.real, Gd.imag, Kyr, Kyi, Kxr, Kxi)
    off_y = s0y.to(torch.float32) - (nwin // 2) / usfac
    off_x = s0x.to(torch.float32) - (nwin // 2) / usfac
    return C / (H * W), off_y, off_x


def _windowed_coarse_surface(G, bounds, H: int, W: int):
    """Correlation values at the integer lags inside ``bounds`` (on the
    fftshifted surface) only, by a direct half-spectrum matrix DFT.
    Returns (C (B, ny, nx), lag_y0, lag_x0, ny, nx)."""
    r0, r1, c0, c1 = bounds
    ny, nx = r1 - r0, c1 - c0
    lag_y0 = r0 - H // 2
    lag_x0 = c0 - W // 2
    dev = G.device
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    ty = torch.arange(ny, dtype=torch.float32, device=dev) + lag_y0
    tx = torch.arange(nx, dtype=torch.float32, device=dev) + lag_x0
    Kyr, Kyi = (a[0] for a in _us_dft_kernel(zero, ty, H, H))
    Kxr, Kxi = (a[0] for a in _us_dft_kernel(zero, tx, W // 2 + 1, W))
    Gw = G * _hermitian_weights(W, dev)[None, None, :]
    C = _window_dft(Gw.real, Gw.imag, Kyr, Kyi, Kxr, Kxi)
    return C / (H * W), lag_y0, lag_x0, ny, nx


def measure_window(ref, img, ref_mask=None, img_mask=None, *,
                   cc_type: str = "NCC", usfac: int, nwin: int, bounds):
    """The windowed ``usfac > 1`` measurement, plain version of kernel B3
    (:func:`subpixal_tpu_torch.kernels.measure.measure_window`).

    Contract of the JAX package's ``measure_displacement_rank3``: the
    cross-spectrum of each (B, H, W) pair, the correlation at the integer
    lags inside ``bounds`` (r0, r1, c0, c1 on the fftshifted surface) and
    its first-index argmax, then the ``usfac``-upsampled window around
    it. Returns ``(C2, s0y, s0x)``: C2 (B, nwin, nwin), already divided by
    H·W, sampled at ``s0 + (i - nwin//2) / usfac`` per axis, and the (B,)
    int32 coarse shifts in signed-lag space.
    """
    B, H, W = ref.shape
    G = _cross_spectrum(ref, img, cc_type, ref_mask, img_mask)
    Cc, ly0, lx0, ny, nx = _windowed_coarse_surface(G, bounds, H, W)
    flat = torch.argmax(Cc.reshape(B, -1), dim=-1)
    s0y = (flat // nx).to(torch.int32) + ly0
    s0x = (flat % nx).to(torch.int32) + lx0
    C, _, _ = _upsampled_correlation(G, s0y, s0x, int(usfac), nwin, H, W)
    return C, s0y, s0x


def window_fits(H: int, W: int, nwin: int, ny: int, nx: int) -> bool:
    """Whether the windowed measurement takes (H, W) pairs at window
    ``nwin`` and an ``ny`` x ``nx`` coarse search box.

    A pure function of the shape: kernel B3's limit, on every device. Its
    mixed-radix kernel plans its smallest cut (a cluster of up to 8 CTAs,
    at most ``min(H, W//2 + 1)``, with the line buffers in a global
    workspace); that CTA must still hold in shared memory the twiddles,
    the (nwin, H) window kernel, its (nwin, odd-padded column share) of
    the other, the coarse and window sums and the reduction scratch
    (``csrc/measure_displacement.cu · mix_plan``, which refuses exactly
    these shapes). They grow with ``nwin · H``: 512² cutouts pass at
    ``usfac`` 10 (nwin 16) and fail from ``usfac`` 43 (nwin 56).
    """
    Wr = W // 2 + 1
    C = 8
    while C > 1 and C > min(H, Wr):
        C //= 2
    cols = -(-Wr // C) | 1
    floats = (_B3_RED_FLOATS + 2 * (H + W) + 2 * nwin * H + 2 * nwin * cols
              + ny * nx + nwin * nwin)
    return floats <= _B3_SMEM_FLOATS


def window_route(H: int, W: int, usfac: int, peak_fit_box: int,
                 peak_search_box):
    """How :func:`find_displacement` measures (H, W) pairs at ``usfac >
    1``: ``(bounds, nwin, windowed)``, the search box on the surface (or
    None), the window's side (±0.5 coarse px, i.e. ``usfac`` upsampled px,
    plus the fit box, rounded up to a multiple of 8), and whether the
    windowed measurement takes it (a box of at most 17 lags a side that
    :func:`window_fits` takes) rather than the full surface."""
    bounds = normalize_search_box(peak_search_box, H, W, peak_fit_box)
    nwin = -(-(int(usfac) + int(peak_fit_box) + 1) // 8) * 8
    windowed = (bounds is not None
                and bounds[1] - bounds[0] <= _WINDOWED_COARSE_MAX
                and bounds[3] - bounds[2] <= _WINDOWED_COARSE_MAX
                and window_fits(H, W, nwin, bounds[1] - bounds[0],
                                bounds[3] - bounds[2]))
    return bounds, nwin, windowed


@full_f32()
def find_displacement(ref, img, cc_type: str = "NCC", usfac: int = 1,
                      peak_fit_box: int = 5, fit_type: str = "quadratic",
                      ref_mask=None, img_mask=None,
                      peak_search_box="fitbox",
                      measure=measure_window) -> Displacement:
    """Subpixel displacement of ``img`` relative to ``ref``, batched over
    (B, H, W) (or one (H, W) pair). Parameters as the JAX package's
    ``find_displacement``: ``usfac`` > 1 refines the coarse peak in a
    matrix-DFT upsampled window; masks mark valid pixels;
    ``peak_search_box`` confines the coarse argmax ('fitbox' = around
    zero lag). ``measure`` computes the windowed ``usfac > 1``
    measurement, with :func:`measure_window`'s contract, where
    :func:`window_route` takes it; the other shapes and boxes take the
    full inverse transform and its argmax inside the box (the same lags),
    on every device."""
    squeeze = ref.dim() == 2
    ref_b = ref[None] if squeeze else ref
    img_b = img[None] if squeeze else img
    if ref_b.shape != img_b.shape:
        raise ValueError(f"ref and img must have the same shape, got "
                         f"{tuple(ref_b.shape)} vs {tuple(img_b.shape)}")
    B, H, W = ref_b.shape
    if usfac <= 1:
        G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)
        cc_s = torch.fft.fftshift(torch.fft.irfft2(G, s=(H, W)),
                                  dim=(-2, -1))
        pk = find_peak(cc_s, peak_fit_box=peak_fit_box, fit_type=fit_type,
                       peak_search_box=peak_search_box)
        res = Displacement(dx=pk.x - W // 2, dy=pk.y - H // 2,
                           peak=pk.value, fit_ok=pk.fit_ok)
    else:
        bounds, nwin, windowed = window_route(H, W, usfac, peak_fit_box,
                                              peak_search_box)
        if windowed:
            C, s0y, s0x = measure(
                ref_b, img_b, ref_mask, img_mask, cc_type=cc_type,
                usfac=int(usfac), nwin=nwin, bounds=bounds)
            off_y = s0y.to(torch.float32) - (nwin // 2) / usfac
            off_x = s0x.to(torch.float32) - (nwin // 2) / usfac
        else:
            G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)
            cc_s = torch.fft.fftshift(torch.fft.irfft2(G, s=(H, W)),
                                      dim=(-2, -1))
            search = cc_s
            if bounds is not None:
                r0, r1, c0, c1 = bounds
                rows = torch.arange(H, device=G.device)[None, :, None]
                cols = torch.arange(W, device=G.device)[None, None, :]
                inside = ((rows >= r0) & (rows < r1)
                          & (cols >= c0) & (cols < c1))
                search = torch.where(inside, search,
                                     torch.full_like(search, -torch.inf))
            flat = torch.argmax(search.reshape(B, -1), dim=-1)
            s0y = (flat // W).to(torch.int32) - H // 2
            s0x = (flat % W).to(torch.int32) - W // 2
            C, off_y, off_x = _upsampled_correlation(G, s0y, s0x, int(usfac),
                                                     nwin, H, W)
        pk = find_peak(C, peak_fit_box=peak_fit_box, fit_type=fit_type)
        res = Displacement(dx=off_x + pk.x / usfac, dy=off_y + pk.y / usfac,
                           peak=pk.value, fit_ok=pk.fit_ok)
    if squeeze:
        res = Displacement(*(r[0] for r in res))
    return res
