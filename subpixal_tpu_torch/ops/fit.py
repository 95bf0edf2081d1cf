"""Sigma-clipped linear (WCS-correction) fits — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/fit.py · iter_linear_fit``: given
matched positions ``xy`` and measured counterparts ``uv``, fit
``uv ≈ M @ xy + t`` with ``fitgeom`` in ``{'shift','rscale','general'}``
and reject points beyond ``sigma`` times the fit RMS ``nclip`` times.
Clipping zeroes weights instead of removing rows, and the fit goes
through weighted moment sums. Every input may carry leading batch axes
(one independent fit per batch entry), which replaces the JAX package's
``vmap`` over exposures.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._precision import full_f32

__all__ = ["iter_linear_fit", "LinearFitResult", "apply_affine"]


class LinearFitResult(NamedTuple):
    """matrix (..., 2, 2) and shift (..., 2) with ``uv ≈ xy @ M.T + t``;
    per-axis ``rms`` (..., 2), total ``rmse`` and ``mae`` (...),
    ``nmatches`` (...) int32 surviving points, final ``weights`` (..., N)."""

    matrix: torch.Tensor
    shift: torch.Tensor
    rms: torch.Tensor
    rmse: torch.Tensor
    mae: torch.Tensor
    nmatches: torch.Tensor
    weights: torch.Tensor


def apply_affine(xy: torch.Tensor, matrix: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """``xy @ M.T + t`` (row-vector convention), batched."""
    return torch.einsum("...nj,...ij->...ni", xy, matrix) + shift[..., None, :]


def _solve_from_moments(sw, sx, su, sxx, sux, fitgeom: str):
    """Closed-form (M, t) from weighted moment sums (batched)."""
    eye = torch.eye(2, dtype=sx.dtype, device=sx.device)
    # a frame with (almost) no weight has no measurement: the identity,
    # not the zero matrix the degenerate moments would give
    dead = sw <= 1e-8
    sw = torch.clamp(sw, min=1e-12)
    cx = sx / sw[..., None]
    cu = su / sw[..., None]
    Sxx = sxx - sw[..., None, None] * cx[..., :, None] * cx[..., None, :]
    Sux = sux - sw[..., None, None] * cu[..., :, None] * cx[..., None, :]

    if fitgeom == "shift":
        M = eye.expand(Sxx.shape).clone()
    elif fitgeom == "rscale":
        a = Sux[..., 0, 0] + Sux[..., 1, 1]
        b = Sux[..., 1, 0] - Sux[..., 0, 1]
        nx = torch.clamp(Sxx[..., 0, 0] + Sxx[..., 1, 1], min=1e-12)
        denom = torch.clamp(torch.sqrt(a * a + b * b), min=1e-12)
        cos_t = a / denom
        sin_t = b / denom
        s = denom / nx
        R = torch.stack([torch.stack([cos_t, -sin_t], -1),
                         torch.stack([sin_t, cos_t], -1)], -2)
        M = s[..., None, None] * R
    elif fitgeom == "general":
        tr = Sxx[..., 0, 0] + Sxx[..., 1, 1]
        Sxx = Sxx + (1e-10 * tr)[..., None, None] * eye + 1e-12 * eye
        M = Sux @ torch.linalg.inv(Sxx)
    else:
        raise ValueError(f"unknown fitgeom: {fitgeom!r} "
                         "(expected 'shift'|'rscale'|'general')")
    t = cu - torch.einsum("...ij,...j->...i", M, cx)
    M = torch.where(dead[..., None, None], eye, M)
    t = torch.where(dead[..., None], torch.zeros_like(t), t)
    return M, t


@full_f32()
def iter_linear_fit(xy: torch.Tensor, uv: torch.Tensor,
                    wxy: torch.Tensor | None = None,
                    fitgeom: str = "general", nclip: int = 3,
                    sigma: float = 3.0) -> LinearFitResult:
    """Iterative sigma-clipped weighted fit of ``uv`` against ``xy``
    ((..., N, 2) each; ``wxy`` (..., N) nonnegative weights, None =
    uniform). A clip iteration that would leave fewer than 3 points is
    skipped. Coordinates are centred on their initial weighted centroid
    before any moment is taken (float32 second moments of absolute
    coordinates cancel catastrophically) and the shift is un-centred at
    the end."""
    xy = xy.to(torch.float32)
    uv = uv.to(torch.float32)
    w0 = (torch.ones(xy.shape[:-1], dtype=torch.float32, device=xy.device)
          if wxy is None else torch.clamp(wxy.to(torch.float32), min=0.0))

    sw0 = torch.clamp(w0.sum(-1), min=1e-12)
    c = torch.einsum("...n,...ni->...i", w0, xy) / sw0[..., None]
    xy = xy - c[..., None, :]
    uv = uv - c[..., None, :]

    def fit_and_resid(w):
        M, t = _solve_from_moments(
            w.sum(-1),
            torch.einsum("...n,...ni->...i", w, xy),
            torch.einsum("...n,...ni->...i", w, uv),
            torch.einsum("...n,...ni,...nj->...ij", w, xy, xy),
            torch.einsum("...n,...ni,...nj->...ij", w, uv, xy), fitgeom)
        resid = uv - apply_affine(xy, M, t)
        return M, t, resid, (resid * resid).sum(-1)

    w = w0
    for _ in range(nclip):
        _, _, _, r2 = fit_and_resid(w)
        wsum = torch.clamp(w.sum(-1), min=1e-12)
        rms2 = (w * r2).sum(-1) / wsum
        keep = r2 <= (sigma * sigma) * torch.clamp(rms2, min=1e-24)[..., None]
        w_new = torch.where(keep, w, torch.zeros_like(w))
        enough = (w_new > 0).sum(-1) >= 3
        w = torch.where(enough[..., None], w_new, w)
    M, t, resid, r2 = fit_and_resid(w)

    wsum = torch.clamp(w.sum(-1), min=1e-12)
    rms = torch.sqrt((w[..., None] * resid * resid).sum(-2) / wsum[..., None])
    rmse = torch.sqrt((w * r2).sum(-1) / wsum)
    mae = (w * torch.sqrt(r2)).sum(-1) / wsum
    nmatches = (w > 0).sum(-1).to(torch.int32)
    t = t + c - torch.einsum("...ij,...j->...i", M, c)
    return LinearFitResult(matrix=M, shift=t, rms=rms, rmse=rmse, mae=mae,
                           nmatches=nmatches, weights=w)
