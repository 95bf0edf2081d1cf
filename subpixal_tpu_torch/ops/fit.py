"""Sigma-clipped linear (WCS-correction) fits — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/fit.py · iter_linear_fit``: given
matched positions ``xy`` and measured counterparts ``uv``, fit
``uv ≈ M @ xy + t`` with ``fitgeom`` in ``{'shift','rscale','general'}``
and reject points beyond ``sigma`` times the fit RMS ``nclip`` times.
Clipping zeroes weights instead of removing rows, and the fit goes
through weighted moment sums. Every input of :func:`iter_linear_fit` may
carry leading batch axes (one independent fit per batch entry), which
replaces the JAX package's ``vmap`` over exposures.

:func:`iter_linear_fit_frames` fits every frame of a flattened (frame,
source) batch, and :func:`iter_linear_fit_sharded` one frame, with the
point axis split over the ranks of a ``torch.distributed`` process group:
every moment sum is this rank's partial sum ``all_reduce``-d over the
group (the JAX package's ``lax.psum`` under ``shard_map``), so every rank
solves the same global, globally clipped fit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._precision import full_f32

__all__ = ["iter_linear_fit", "iter_linear_fit_frames",
           "iter_linear_fit_sharded", "LinearFitResult", "apply_affine"]


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
        # inv_ex: inv without its error check, a host read that a CUDA
        # graph of the align step could not capture (Sxx is regularised)
        M = Sux @ torch.linalg.inv_ex(Sxx).inverse
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


def _reducer(group):
    """``reduce_sum(t)``: ``t``, a partial sum the caller no longer needs,
    summed over the ranks of ``group`` in place (the identity when
    ``group`` is None)."""
    if group is None:
        return lambda s: s
    import torch.distributed as dist

    def reduce_sum(s):
        s = s.contiguous()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s

    return reduce_sum


@full_f32()
def iter_linear_fit_frames(xy: torch.Tensor, uv: torch.Tensor,
                           frame_id: torch.Tensor, n_frames: int,
                           wxy: torch.Tensor | None = None,
                           fitgeom: str = "general", nclip: int = 3,
                           sigma: float = 3.0,
                           group=None) -> LinearFitResult:
    """Per-frame sigma-clipped fits over a flattened (frame, source) batch.

    ``xy``, ``uv`` (N, 2), ``frame_id`` (N,) the frame of each point,
    ``wxy`` (N,) nonnegative weights (None = uniform). Moments are taken
    per frame through a one-hot contraction, summed over ``group`` (a
    ``torch.distributed`` process group over which the N points are
    split; None = this process holds them all) and solved per frame, so
    the clipping is global. Each frame is centred on its initial weighted
    centroid before any moment is taken, and un-centred at the end.
    Returns a :class:`LinearFitResult` whose fields have a leading
    (n_frames,) axis; ``weights`` stays per point (this rank's).
    """
    xy = xy.to(torch.float32)
    uv = uv.to(torch.float32)
    dev = xy.device
    w0 = (torch.ones(xy.shape[0], dtype=torch.float32, device=dev)
          if wxy is None else torch.clamp(wxy.to(torch.float32), min=0.0))
    reduce_sum = _reducer(group)
    E = int(n_frames)
    fid = frame_id.to(device=dev, dtype=torch.int64)
    onehot = (fid[:, None] == torch.arange(E, device=dev)[None]).to(
        torch.float32)                                          # (N, E)

    # one all_reduce per group of sums: each sum is reduced on its own,
    # so packing them changes no value
    we0 = onehot * w0[:, None]
    red = reduce_sum(torch.cat([we0.sum(0)[:, None],
                                torch.einsum("ne,ni->ei", we0, xy)], 1))
    sw0 = torch.clamp(red[:, 0], min=1e-12)
    c = red[:, 1:] / sw0[:, None]                               # (E, 2)
    xy = xy - c[fid]
    uv = uv - c[fid]

    def fit_and_resid(w):
        we = onehot * w[:, None]
        m = reduce_sum(torch.cat([
            we.sum(0)[:, None],
            torch.einsum("ne,ni->ei", we, xy),
            torch.einsum("ne,ni->ei", we, uv),
            torch.einsum("ne,ni,nj->eij", we, xy, xy).reshape(E, 4),
            torch.einsum("ne,ni,nj->eij", we, uv, xy).reshape(E, 4)], 1))
        M, t = _solve_from_moments(m[:, 0], m[:, 1:3], m[:, 3:5],
                                   m[:, 5:9].reshape(E, 2, 2),
                                   m[:, 9:13].reshape(E, 2, 2), fitgeom)
        resid = uv - (torch.einsum("nij,nj->ni", M[fid], xy) + t[fid])
        return M, t, resid, (resid * resid).sum(-1)

    w = w0
    for _ in range(nclip):
        _, _, _, r2 = fit_and_resid(w)
        we = onehot * w[:, None]
        red = reduce_sum(torch.stack([we.sum(0), (we * r2[:, None]).sum(0)]))
        wsum = torch.clamp(red[0], min=1e-12)
        thr = (sigma * sigma) * torch.clamp(red[1] / wsum, min=1e-24)
        w_new = torch.where(r2 <= thr[fid], w, torch.zeros_like(w))
        counts = reduce_sum((onehot * (w_new > 0)[:, None]).sum(0))
        w = torch.where((counts >= 3)[fid], w_new, w)
    M, t, resid, r2 = fit_and_resid(w)

    we = onehot * w[:, None]
    red = reduce_sum(torch.cat([
        we.sum(0)[:, None], torch.einsum("ne,ni->ei", we, resid * resid),
        (we * r2[:, None]).sum(0)[:, None],
        (we * torch.sqrt(r2)[:, None]).sum(0)[:, None],
        (onehot * (w > 0)[:, None]).sum(0)[:, None]], 1))       # (E, 6)
    wsum = torch.clamp(red[:, 0], min=1e-12)
    t = t + c - torch.einsum("eij,ej->ei", M, c)
    return LinearFitResult(
        matrix=M, shift=t, rms=torch.sqrt(red[:, 1:3] / wsum[:, None]),
        rmse=torch.sqrt(red[:, 3] / wsum), mae=red[:, 4] / wsum,
        nmatches=red[:, 5].to(torch.int32), weights=w)


def iter_linear_fit_sharded(xy: torch.Tensor, uv: torch.Tensor,
                            wxy: torch.Tensor | None, group=None,
                            fitgeom: str = "general", nclip: int = 3,
                            sigma: float = 3.0) -> LinearFitResult:
    """One sigma-clipped fit whose (N, 2) points are split over the ranks
    of ``group`` (None = this process holds them all): the one-frame
    case of :func:`iter_linear_fit_frames`. Equal to the one-process fit
    up to the order of the sums."""
    fid = torch.zeros(xy.shape[0], dtype=torch.int64, device=xy.device)
    f = iter_linear_fit_frames(xy, uv, fid, 1, wxy=wxy, fitgeom=fitgeom,
                               nclip=nclip, sigma=sigma, group=group)
    return LinearFitResult(*(v[0] for v in f[:-1]), f.weights)
