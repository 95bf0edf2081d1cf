"""Drizzle (area-weighted scatter-add resampling) — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/drizzle.py`` and the plain version of
kernel B1 (:mod:`subpixal_tpu_torch.kernels.drizzle`): each input pixel
deposits its flux onto the output grid over a static K x K candidate-cell
window, weighted by the kernel's overlap with each cell, into separate
science and weight accumulators.

Supported kernels: ``square`` / ``turbo`` (area overlap), ``point``
(nearest cell), ``gaussian`` (truncated at 2.5 sigma), ``lanczos2`` /
``lanczos3`` (separable windowed sinc) and ``tophat`` (uniform within a
circular radius).
"""

from __future__ import annotations

import math

import torch

__all__ = ["drizzle_deposit", "drizzle_deposit_stack", "drizzle_combine",
           "kernel_reach", "DRIZZLE_KERNELS"]

#: supported deposit kernels (drizzlepac parity set)
DRIZZLE_KERNELS = ("square", "turbo", "point", "gaussian",
                   "lanczos2", "lanczos3", "tophat")


def kernel_reach(kernel: str, pixfrac: float, pscale_ratio: float) -> float:
    """Deposit window half-extent (output pixels) of ``kernel``."""
    half = 0.5 * float(pixfrac) * float(pscale_ratio)
    s = max(float(pixfrac) * float(pscale_ratio), 1e-3)
    if kernel in ("square", "turbo"):
        return half
    if kernel == "point":
        return 0.51
    if kernel == "gaussian":
        return 2.5 * s / 2.3548
    if kernel == "lanczos2":
        return 2.0 * s
    if kernel == "lanczos3":
        return 3.0 * s
    if kernel == "tophat":
        return half
    raise ValueError(f"unknown kernel: {kernel!r} "
                     f"(expected one of {DRIZZLE_KERNELS})")


def _lanczos1d(u: torch.Tensor, a: float) -> torch.Tensor:
    """lanczos_a(u) = sinc(u)·sinc(u/a) on |u| < a, 0 outside."""
    pu = math.pi * u
    val = torch.where(
        u.abs() < 1e-7, torch.ones_like(u),
        a * torch.sin(pu) * torch.sin(pu / a) / torch.clamp(pu * pu, min=1e-30))
    return torch.where(u.abs() >= a, torch.zeros_like(u), val)


def drizzle_deposit(in_data: torch.Tensor, in_wht: torch.Tensor | None,
                    x_out: torch.Tensor, y_out: torch.Tensor,
                    out_shape: tuple[int, int], pixfrac: float = 1.0,
                    pscale_ratio: float = 1.0, kernel: str = "square"):
    """Deposit one input plane onto an output grid.

    ``in_data``/``in_wht`` (H, W) science and weights (None = unit
    weights; pixels with weight <= 0 deposit nothing); ``x_out``/``y_out``
    (H, W) each input pixel center in output pixel coordinates (the
    pixmap). Returns ``(sci_acc, wht_acc)`` over ``out_shape`` with
    ``sci_acc = Σ v·w·a`` and ``wht_acc = Σ w·a``; combine with
    :func:`drizzle_combine`.
    """
    if kernel not in DRIZZLE_KERNELS:
        raise ValueError(f"unknown kernel: {kernel!r} "
                         f"(expected one of {DRIZZLE_KERNELS})")
    Ho, Wo = out_shape
    dev = in_data.device
    data = in_data.to(torch.float32).reshape(-1)
    w = (torch.ones_like(data) if in_wht is None
         else in_wht.to(torch.float32).reshape(-1))
    xo = x_out.to(torch.float32).reshape(-1)
    yo = y_out.to(torch.float32).reshape(-1)
    # one trash slot past the grid takes every invalid deposit
    sci = torch.zeros(Ho * Wo + 1, dtype=torch.float32, device=dev)
    wht = torch.zeros(Ho * Wo + 1, dtype=torch.float32, device=dev)
    trash = torch.full_like(xo, Ho * Wo, dtype=torch.int64)
    zero = torch.zeros_like(w)

    if kernel == "point":
        xi = torch.floor(xo + 0.5).to(torch.int64)  # C (int)(x+0.5)
        yi = torch.floor(yo + 0.5).to(torch.int64)
        valid = (xi >= 0) & (xi < Wo) & (yi >= 0) & (yi < Ho) & (w > 0)
        flat = torch.where(valid, yi * Wo + xi, trash)
        wv = torch.where(valid, w, zero)
        sci.index_add_(0, flat, wv * data)
        wht.index_add_(0, flat, wv)
        return sci[:-1].reshape(Ho, Wo), wht[:-1].reshape(Ho, Wo)

    half = 0.5 * float(pixfrac) * float(pscale_ratio)
    s = max(float(pixfrac) * float(pscale_ratio), 1e-3)
    sigma = s / 2.3548  # Gaussian: FWHM = pixfrac * pscale_ratio
    reach = kernel_reach(kernel, pixfrac, pscale_ratio)

    # cell c covers [c-0.5, c+0.5]: the leftmost cell meeting
    # [xo-reach, xo+reach] is floor(xo - reach + 0.5), and a window of
    # ceil(2*reach)+1 cells also covers the rightmost one
    K = int(math.ceil(2.0 * reach)) + 1
    c0x = torch.floor(xo - reach + 0.5).to(torch.int64)
    c0y = torch.floor(yo - reach + 0.5).to(torch.int64)

    for dy in range(K):
        cy = c0y + dy
        for dx in range(K):
            cx = c0x + dx
            fx = cx.to(torch.float32)
            fy = cy.to(torch.float32)
            if kernel in ("square", "turbo"):
                ox = (torch.minimum(xo + half, fx + 0.5)
                      - torch.maximum(xo - half, fx - 0.5))
                oy = (torch.minimum(yo + half, fy + 0.5)
                      - torch.maximum(yo - half, fy - 0.5))
                a = (ox.clamp(min=0.0) * oy.clamp(min=0.0)
                     / (4.0 * half * half))
            elif kernel == "gaussian":
                r2 = (fx - xo) ** 2 + (fy - yo) ** 2
                a = torch.exp(-0.5 * r2 / (sigma * sigma))
            elif kernel in ("lanczos2", "lanczos3"):
                la = 2.0 if kernel == "lanczos2" else 3.0
                a = (_lanczos1d((fx - xo) / s, la)
                     * _lanczos1d((fy - yo) / s, la))
            else:  # tophat: uniform within a circular radius `half`
                r2 = (fx - xo) ** 2 + (fy - yo) ** 2
                a = (r2 <= half * half).to(torch.float32)
            valid = (cx >= 0) & (cx < Wo) & (cy >= 0) & (cy < Ho) & (w > 0)
            flat = torch.where(valid, cy * Wo + cx, trash)
            wa = torch.where(valid, w * a, zero)
            sci.index_add_(0, flat, wa * data)
            wht.index_add_(0, flat, wa)
    return sci[:-1].reshape(Ho, Wo), wht[:-1].reshape(Ho, Wo)


def drizzle_deposit_stack(in_data: torch.Tensor, in_wht: torch.Tensor | None,
                          x_out: torch.Tensor, y_out: torch.Tensor,
                          out_shape: tuple[int, int], pixfrac: float = 1.0,
                          pscale_ratio=(1.0,), kernel: str = "square",
                          per_plane: bool = False):
    """Deposit a stack of E input planes onto one output grid.

    ``in_data``/``in_wht``/``x_out``/``y_out`` are (E, H, W) (``in_wht``
    may be None) and ``pscale_ratio`` holds one ratio per plane. Returns
    ``(sci_acc, wht_acc)``: the sums over e = 0..E-1, in that order, of
    :func:`drizzle_deposit` of each plane, or with ``per_plane`` those
    deposits stacked, (E, Ho, Wo) each.
    """
    ratios = [float(r) for r in pscale_ratio]
    if not ratios or len(ratios) != in_data.shape[0]:
        raise ValueError(f"{len(ratios)} pscale ratios for "
                         f"{in_data.shape[0]} planes")
    sci, wht = [], []
    for e, r in enumerate(ratios):
        s, w = drizzle_deposit(in_data[e], None if in_wht is None
                               else in_wht[e], x_out[e], y_out[e], out_shape,
                               pixfrac=pixfrac, pscale_ratio=r, kernel=kernel)
        if per_plane or not sci:
            sci.append(s)
            wht.append(w)
        else:
            sci[0] = sci[0] + s
            wht[0] = wht[0] + w
    if per_plane:
        return torch.stack(sci), torch.stack(wht)
    return sci[0], wht[0]


def drizzle_combine(sci_acc: torch.Tensor, wht_acc: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Final science image from summed accumulators (0-weight -> fill)."""
    good = wht_acc > 0
    return torch.where(good, sci_acc / torch.where(good, wht_acc,
                                                   torch.ones_like(wht_acc)),
                       torch.full_like(sci_acc, fill))
