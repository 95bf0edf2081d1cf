"""Separable image interpolation (the blot gather) — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/interp.py`` and the plain version of
kernel B2 (:mod:`subpixal_tpu_torch.kernels.blot`): sampling of an image
at arbitrary (x, y) coordinates with the interpolants ``nearest / linear
/ poly3 / poly5 / spline3 / sinc`` as ``taps x taps`` separable gathers
with per-axis weight vectors. Out-of-image samples return ``fill`` with a
False validity mask.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sample_image", "bspline3_prefilter", "INTERP_TAPS",
           "INTERP_OFFSETS"]

#: integer tap offsets of each separable interpolant (consecutive); shared
#: with the CUDA gather in :mod:`subpixal_tpu_torch.kernels.blot`
INTERP_OFFSETS = {
    "nearest": (0,),
    "linear": (0, 1),
    "poly3": (-1, 0, 1, 2),
    "spline3": (-1, 0, 1, 2),
    "poly5": (-2, -1, 0, 1, 2, 3),
    "sinc": (-2, -1, 0, 1, 2, 3),
}

INTERP_TAPS = {k: len(v) for k, v in INTERP_OFFSETS.items()}

#: pole of the cubic B-spline direct filter (Unser 1993): sqrt(3) - 2
_BSPLINE3_POLE = -0.26794919243112270647

#: truncation horizon for the mirror-boundary causal init:
#: |pole|^18 < 5e-11 — far below f32 resolution
_BSPLINE3_HORIZON = 18


def _lagrange_weights(t: torch.Tensor, offsets) -> torch.Tensor:
    """Lagrange basis weights at fractional ``t`` for integer ``offsets``;
    shape ``t.shape + (len(offsets),)``."""
    ws = []
    for i, oi in enumerate(offsets):
        w = torch.ones_like(t)
        for j, oj in enumerate(offsets):
            if i != j:
                w = w * (t - oj) / (oi - oj)
        ws.append(w)
    return torch.stack(ws, dim=-1)


def _bspline3_weights(t: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis at fractional ``t`` for offsets (-1,0,1,2)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([
        (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0,
        (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,
        (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0,
        t3 / 6.0,
    ], dim=-1)


def _bspline3_prefilter_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact cubic B-spline coefficients along ``axis``: the causal and
    anticausal first-order recursions (pole ``z``, gain 6, mirror
    boundaries), run as the plain sequential loop the JAX package writes
    as a log-depth associative scan."""
    z = _BSPLINE3_POLE
    x = torch.movedim(x, axis, -1)
    N = x.shape[-1]
    if N < 4:  # degenerate axis: B-spline == the samples themselves
        return torch.movedim(x, -1, axis)
    x = x * 6.0
    K = min(N, _BSPLINE3_HORIZON)
    zk = torch.tensor([z ** k for k in range(K)], dtype=x.dtype,
                      device=x.device)
    cp = torch.empty_like(x)
    cp[..., 0] = x[..., :K] @ zk
    for n in range(1, N):
        cp[..., n] = z * cp[..., n - 1] + x[..., n]
    cm = torch.empty_like(x)
    cm[..., -1] = (z / (z * z - 1.0)) * (cp[..., -1] + z * cp[..., -2])
    for n in range(N - 2, -1, -1):
        cm[..., n] = z * cm[..., n + 1] + (-z) * cp[..., n]
    return torch.movedim(cm, -1, axis)


def bspline3_prefilter(image: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficient image (both axes, mirror boundaries);
    matches ``scipy.ndimage.spline_filter(order=3, mode='mirror')``."""
    image = image.to(torch.float32)
    return _bspline3_prefilter_axis(_bspline3_prefilter_axis(image, 0), 1)


def _lanczos_weights(t: torch.Tensor, offsets, a: int = 3,
                     sinscl: float = 1.0) -> torch.Tensor:
    """Windowed-sinc weights normalised over the taps; ``sinscl`` scales
    the sinc's argument (reference ``do_blot(..., sinscl=)``)."""

    def lanczos(x):
        xs = x / sinscl
        pxs = math.pi * xs
        pw = math.pi * x / a
        small_s = xs.abs() < 1e-7
        small_w = x.abs() < 1e-7
        one = torch.ones_like(x)
        sinc_main = torch.where(
            small_s, one, torch.sin(pxs) / torch.where(small_s, one, pxs))
        sinc_win = torch.where(
            small_w, one, torch.sin(pw) / torch.where(small_w, one, pw))
        return torch.where(x.abs() >= a, torch.zeros_like(x),
                           sinc_main * sinc_win)

    ws = torch.stack([lanczos(t - o) for o in offsets], dim=-1)
    s = ws.sum(dim=-1, keepdim=True)
    # taps summing to ~0 (possible for sinscl < 1) would normalise to
    # NaN: fall back to bilinear weights there
    i0 = offsets.index(0)
    lin = torch.zeros_like(ws)
    lin[..., i0] = 1.0 - t
    lin[..., i0 + 1] = t
    bad = s.abs() < 1e-3
    return torch.where(bad, lin, ws / torch.where(bad, torch.ones_like(s), s))


def _axis_weights(t: torch.Tensor, interp: str, sinscl: float = 1.0):
    """Per-axis tap weights for the fractional coordinate part ``t``."""
    if interp not in INTERP_OFFSETS:
        raise ValueError(
            f"unknown interp: {interp!r} "
            f"(expected one of {sorted(INTERP_TAPS)})")
    offs = INTERP_OFFSETS[interp]
    if interp == "nearest":
        return torch.ones(t.shape + (1,), dtype=t.dtype, device=t.device), offs
    if interp == "linear":
        return torch.stack([1.0 - t, t], dim=-1), offs
    if interp == "sinc":
        return _lanczos_weights(t, offs, sinscl=sinscl), offs
    if interp == "spline3":
        return _bspline3_weights(t), offs
    return _lagrange_weights(t, offs), offs


def sample_image(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 interp: str = "poly5", fill: float = 0.0,
                 sinscl: float = 1.0, prefiltered: bool = False):
    """Sample ``image`` at float coordinates (x, y) (0-based, x=column).

    Returns ``(values, valid)`` with the shapes of ``x``; ``valid`` is
    False where the interpolation footprint left the image (those values
    are ``fill``). ``interp='spline3'`` prefilters ``image`` first unless
    ``prefiltered``.
    """
    H, W = image.shape
    if interp == "spline3" and not prefiltered:
        image = bspline3_prefilter(image)
    flat = image.to(torch.float32).reshape(-1)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    fill_t = torch.tensor(fill, dtype=torch.float32, device=x.device)

    if interp == "nearest":
        # floor(x+0.5): the reference's (int)(x+0.5), not banker's rounding
        xi = torch.floor(x + 0.5).to(torch.int64)
        yi = torch.floor(y + 0.5).to(torch.int64)
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(valid, vals, fill_t), valid

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, offs = _axis_weights(x - x0, interp, sinscl=sinscl)
    wy, _ = _axis_weights(y - y0, interp, sinscl=sinscl)
    xi0 = x0.to(torch.int64)
    yi0 = y0.to(torch.int64)
    lo, hi = offs[0], offs[-1]
    valid = ((xi0 + lo >= 0) & (xi0 + hi < W)
             & (yi0 + lo >= 0) & (yi0 + hi < H))

    acc = torch.zeros_like(x)
    for i, oy in enumerate(offs):
        row = (yi0 + oy).clamp(0, H - 1) * W
        row_acc = torch.zeros_like(x)
        for j, ox in enumerate(offs):
            row_acc = row_acc + wx[..., j] * flat[row + (xi0 + ox).clamp(0, W - 1)]
        acc = acc + wy[..., i] * row_acc
    return torch.where(valid, acc, fill_t), valid
