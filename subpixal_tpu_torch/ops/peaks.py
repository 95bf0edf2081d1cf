"""Subpixel peak localization on (correlation) surfaces — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/peaks.py · find_peak``: batched over a
leading axis, a quadratic (or Gaussian, in log space) surface is fitted
over a ``peak_fit_box`` square around the first-index argmax through
box-centered masked moments, solved by an unrolled Cholesky, with a
fallback to the integer argmax where the stationary point is not an
interior maximum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["find_peak", "PeakFitResult", "normalize_search_box"]


class PeakFitResult(NamedTuple):
    """Batched peak-fit output: subpixel ``x``/``y`` (column/row),
    ``value`` at the peak, ``fit_ok`` (False = integer fallback) and the
    integer argmax ``ix``/``iy``."""

    x: torch.Tensor
    y: torch.Tensor
    value: torch.Tensor
    fit_ok: torch.Tensor
    ix: torch.Tensor
    iy: torch.Tensor


def _argmax2d(a: torch.Tensor):
    """Row/col of the FIRST maximum of each (n, m) surface of a batch
    (torch.argmax returns the first maximal index, as jnp.argmax)."""
    B, n, m = a.shape
    flat = torch.argmax(a.reshape(B, -1), dim=-1)
    return flat // m, flat % m


@functools.lru_cache(maxsize=16)
def _power_tables(n: int, k: int) -> np.ndarray:
    """``TR[s, q*n + r] = (r - s - (k-1)/2)**q * (s <= r < s+k)`` for
    ``q = 0..4`` and every box origin ``s`` in ``[0, n-k]``: a one-hot
    over ``s`` selects each surface's box-CENTERED coordinate powers."""
    ns = n - k + 1
    cc = (k - 1) / 2.0
    out = np.zeros((ns, 5 * n), np.float32)
    r = np.arange(n)
    for s in range(ns):
        inside = (r >= s) & (r < s + k)
        x = (r - s - cc) * inside
        for q in range(5):
            out[s, q * n:(q + 1) * n] = (x ** q) * inside
    return out


@functools.lru_cache(maxsize=None)
def _power_tables_on(n: int, k: int, dtype, device) -> torch.Tensor:
    """:func:`_power_tables` as a ``dtype`` tensor on ``device``, built
    once and never evicted: a copy from the host on every call could not
    be captured in a CUDA graph, and a cached graph reads it by address."""
    return torch.as_tensor(_power_tables(n, k), dtype=dtype, device=device)


def _solve_spd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve for tiny static n via an unrolled Cholesky."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[:, i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for p in range(i + 1, n):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _fit_moments(data, z, w, iy, ix, k):
    """Weighted quadratic least squares via box-centered masked moments.

    data (B, n, m) raw surface (for the non-finite check), z the fit
    target, w nonnegative weights (not yet box-masked). Returns
    ``(coef (B, 6), r0, c0, bad (B,))``.
    """
    B, n, m = data.shape
    half = k // 2
    r0 = torch.clamp(iy - half, 0, n - k)
    c0 = torch.clamp(ix - half, 0, m - k)
    dt, dev = z.dtype, z.device
    TR = _power_tables_on(n, k, dt, dev)
    TC = TR if m == n else _power_tables_on(m, k, dt, dev)
    oh_r = (r0[:, None] == torch.arange(n - k + 1, device=dev)[None]).to(dt)
    oh_c = (c0[:, None] == torch.arange(m - k + 1, device=dev)[None]).to(dt)
    RY = (oh_r @ TR).reshape(B, 5, n)   # y^q * rowmask
    CX = (oh_c @ TC).reshape(B, 5, m)   # x^p * colmask

    finite = torch.isfinite(data)
    boxmask = (RY[:, 0, :, None] > 0) & (CX[:, 0, None, :] > 0)
    # a non-finite pixel with nonzero weight inside the box poisons the
    # fit: flag it and zero it so it cannot poison other surfaces
    bad = (boxmask & (w > 0) & ~finite).any(dim=2).any(dim=1)
    w = torch.where(finite, w, torch.zeros_like(w))
    z = torch.where(finite & (w > 0), z, torch.zeros_like(z))

    wz = w * z
    Tw = torch.sum(w[:, None] * RY[:, :, :, None], dim=2)       # (B,5,m)
    Twz = torch.sum(wz[:, None] * RY[:, :3, :, None], dim=2)    # (B,3,m)
    Mw = torch.sum(Tw[:, :, None, :] * CX[:, None, :, :], dim=3)
    Mwz = torch.sum(Twz[:, :, None, :] * CX[:, None, :3, :], dim=3)

    pows = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))
    ata = torch.stack(
        [torch.stack([Mw[:, py_i + py_j, px_i + px_j]
                      for (px_j, py_j) in pows], dim=-1)
         for (px_i, py_i) in pows], dim=-2)                      # (B,6,6)
    atz = torch.stack([Mwz[:, py, px] for (px, py) in pows], dim=-1)
    # Tikhonov guard keeps the solve finite when too many pixels are
    # masked; such fits are rejected by the fit_ok checks
    ata = ata + 1e-8 * torch.eye(6, dtype=dt, device=dev)[None]
    return _solve_spd_small(ata, atz), r0, c0, bad


def normalize_search_box(peak_search_box, H: int, W: int,
                         peak_fit_box: int):
    """Resolve ``peak_search_box`` (None | 'all' | 'fitbox' | int |
    (r0, r1, c0, c1)) to static bounds on the surface, or None."""
    if peak_search_box is None or peak_search_box == "all":
        return None
    if isinstance(peak_search_box, bool):
        return (normalize_search_box("fitbox", H, W, peak_fit_box)
                if peak_search_box else None)
    if peak_search_box == "fitbox":
        s = int(peak_fit_box)
    elif isinstance(peak_search_box, (int, np.integer)):
        s = int(peak_search_box)
    else:
        r0, r1, c0, c1 = peak_search_box
        return (int(r0), int(r1), int(c0), int(c1))
    s = max(min(s, H, W), 1)
    r0 = H // 2 - s // 2
    c0 = W // 2 - s // 2
    return (r0, r0 + s, c0, c0 + s)


def find_peak(data: torch.Tensor, peak_fit_box: int = 5,
              peak_search_box=None, mask: torch.Tensor | None = None,
              fit_type: str = "quadratic") -> PeakFitResult:
    """Locate the peak of each (B, H, W) surface (or one (H, W) surface)
    with subpixel precision; see the JAX package's ``find_peak`` for the
    parameters. ``mask`` True/nonzero marks valid pixels."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    if mask is not None and mask.dim() == data.dim() - 1:
        mask = mask[None]
    B, H, W = data.shape
    dev = data.device
    k = int(peak_fit_box)
    if k < 3:
        raise ValueError("peak_fit_box must be >= 3")
    k = min(k, H, W)

    valid = None
    if mask is not None:
        valid = torch.broadcast_to(mask.to(torch.bool), data.shape)

    ninf = torch.full_like(data, -torch.inf)
    search = data
    if valid is not None:
        search = torch.where(valid, search, ninf)
    bounds = normalize_search_box(peak_search_box, H, W, k)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    if bounds is not None:
        r0, r1, c0, c1 = bounds
        inside = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
        search = torch.where(inside, search, ninf)
    iy, ix = _argmax2d(search)
    peak_val = search.amax(dim=(1, 2))

    half = k // 2
    r0b = torch.clamp(iy - half, 0, H - k)[:, None, None]
    c0b = torch.clamp(ix - half, 0, W - k)[:, None, None]
    boxmask = ((rows >= r0b) & (rows < r0b + k)
               & (cols >= c0b) & (cols < c0b + k))
    vm = boxmask if valid is None else (boxmask & valid)
    finite = torch.isfinite(data)
    safe = torch.where(finite, data, torch.zeros_like(data))

    if fit_type == "gaussian":
        # log-transform of the box-max-normalised surface, with
        # value-proportional weights (faint wings down-weighted)
        vals = torch.where(vm & finite, data, ninf)
        bmax = vals.amax(dim=(1, 2), keepdim=True)
        scale = torch.clamp(bmax, min=1e-30)
        ratio = safe / scale
        z = torch.log(torch.clamp(ratio, min=1e-8))
        gw = torch.clamp(ratio, 0.0, 1.0)
        w = vm.to(data.dtype) * gw
    elif fit_type == "quadratic":
        z = data
        w = vm.to(data.dtype)
    else:
        raise ValueError(f"unknown fit_type: {fit_type!r}")

    coef, r0_, c0_, badpix = _fit_moments(data, z, w, iy, ix, k)
    c0c, c1, c2, c3, c4, c5 = [coef[:, i] for i in range(6)]

    # stationary point: [2c3 c4; c4 2c5] p = -[c1; c2]
    det = 4.0 * c3 * c5 - c4 * c4
    safe_det = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    px = (-2.0 * c5 * c1 + c4 * c2) / safe_det
    py = (c4 * c1 - 2.0 * c3 * c2) / safe_det

    hb = (k - 1) / 2.0
    is_max = (det > 0) & (c3 < 0)
    inside = (px.abs() <= hb + 0.5) & (py.abs() <= hb + 0.5)
    fit_ok = is_max & inside & torch.isfinite(px) & torch.isfinite(py)
    fit_ok = fit_ok & torch.isfinite(peak_val) & ~badpix

    cy = r0_.to(data.dtype) + (k - 1) / 2.0
    cx = c0_.to(data.dtype) + (k - 1) / 2.0
    v_fit = c0c + c1 * px + c2 * py + c3 * px * px + c4 * px * py + c5 * py * py
    if fit_type == "gaussian":
        v_fit = torch.exp(v_fit) * scale[:, 0, 0]

    x = torch.where(fit_ok, cx + px, ix.to(data.dtype))
    y = torch.where(fit_ok, cy + py, iy.to(data.dtype))
    value = torch.where(fit_ok, v_fit, peak_val)
    res = PeakFitResult(x=x, y=y, value=value, fit_ok=fit_ok,
                        ix=ix.to(torch.int32), iy=iy.to(torch.int32))
    if squeeze:
        res = PeakFitResult(*(r[0] for r in res))
    return res
