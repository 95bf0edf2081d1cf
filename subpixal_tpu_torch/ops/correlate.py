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
(:func:`_us_dft_kernel`), as in the reference.

Sign convention: ``find_displacement(ref, img)`` returns ``(dx, dy)``
such that ``img[y, x] ≈ ref[y - dy, x - dx]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._precision import full_f32
from .peaks import find_peak, normalize_search_box

__all__ = ["cross_correlate", "find_displacement", "Displacement"]

#: largest search-window side whose coarse lags are evaluated by the
#: windowed matrix DFT instead of the full inverse transform
_WINDOWED_COARSE_MAX = 17


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


def _hermitian_weights(W: int, device) -> torch.Tensor:
    """(W//2+1,) fold weights: interior half-spectrum columns count twice
    (their conjugates are the missing half), v=0 and an even W's Nyquist
    column once."""
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
    f_np = np.rint(np.fft.fftfreq(period) * period).astype(np.int32)[:nfreq]
    f = torch.as_tensor(f_np, device=dev)
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


@full_f32()
def find_displacement(ref, img, cc_type: str = "NCC", usfac: int = 1,
                      peak_fit_box: int = 5, fit_type: str = "quadratic",
                      ref_mask=None, img_mask=None,
                      peak_search_box="fitbox") -> Displacement:
    """Subpixel displacement of ``img`` relative to ``ref``, batched over
    (B, H, W) (or one (H, W) pair). Parameters as the JAX package's
    ``find_displacement``: ``usfac`` > 1 refines the coarse peak in a
    matrix-DFT upsampled window; masks mark valid pixels;
    ``peak_search_box`` confines the coarse argmax ('fitbox' = around
    zero lag)."""
    squeeze = ref.dim() == 2
    ref_b = ref[None] if squeeze else ref
    img_b = img[None] if squeeze else img
    if ref_b.shape != img_b.shape:
        raise ValueError(f"ref and img must have the same shape, got "
                         f"{tuple(ref_b.shape)} vs {tuple(img_b.shape)}")
    B, H, W = ref_b.shape
    G = _cross_spectrum(ref_b, img_b, cc_type, ref_mask, img_mask)

    if usfac <= 1:
        cc_s = torch.fft.fftshift(torch.fft.irfft2(G, s=(H, W)),
                                  dim=(-2, -1))
        pk = find_peak(cc_s, peak_fit_box=peak_fit_box, fit_type=fit_type,
                       peak_search_box=peak_search_box)
        res = Displacement(dx=pk.x - W // 2, dy=pk.y - H // 2,
                           peak=pk.value, fit_ok=pk.fit_ok)
    else:
        bounds = normalize_search_box(peak_search_box, H, W, peak_fit_box)
        # window: ±0.5 coarse px (usfac upsampled px) plus the fit box,
        # rounded up to a multiple of 8
        nwin = -(-(int(usfac) + int(peak_fit_box) + 1) // 8) * 8
        windowed = (bounds is not None
                    and bounds[1] - bounds[0] <= _WINDOWED_COARSE_MAX
                    and bounds[3] - bounds[2] <= _WINDOWED_COARSE_MAX)
        if windowed:
            Cc, ly0, lx0, ny, nx = _windowed_coarse_surface(G, bounds, H, W)
            flat = torch.argmax(Cc.reshape(B, -1), dim=-1)
            s0y = (flat // nx).to(torch.int32) + ly0
            s0x = (flat % nx).to(torch.int32) + lx0
        else:
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
