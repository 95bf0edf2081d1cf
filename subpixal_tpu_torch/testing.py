"""Synthetic dithered star-field stacks with planted pointing errors.

Counterpart of ``subpixal_tpu/testing.py`` (its host renderer, with the
same numpy random draws, so both packages build the same scene from one
seed) and ``pairwise_shift_errors``, used by the tests and by
``chip_smoke.py`` to assert alignment accuracy against ground truth.
"""

from __future__ import annotations

import numpy as np

from .resample import Exposure
from .wcs import TanWCS

__all__ = ["simulate_stack", "pairwise_shift_errors"]


def simulate_stack(
    n_exp: int = 4,
    shape: tuple[int, int] = (512, 512),
    n_stars: int = 30,
    seed: int = 42,
    amp: float = 25.0,
    sigma: float = 1.8,
    noise: float = 0.01,
    shift_scale: float = 0.5,
    pscale_as: float = 0.05,
) -> tuple[list[Exposure], list[tuple[float, float]]]:
    """Dithered exposures whose DATA carry true sub-pixel offsets the
    header WCS does not know about (the alignment problem).

    Stars are painted patch-wise (a full-frame radius test per star
    costs minutes at 2k+ scales), at least 40 px from every edge.

    Returns ``(exposures, planted)`` with ``planted[e] = (dx, dy)`` the
    true per-exposure pointing error in pixels; only pairwise
    DIFFERENCES are recoverable (alignment is relative).
    """
    rng = np.random.default_rng(seed)
    H, W = shape
    cd = (pscale_as / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(40, W - 40, n_stars),
                      rng.uniform(40, H - 40, n_stars)], 1)
    R = max(int(np.ceil(4.5 * sigma)) + 2, 9)
    pyy, pxx = np.mgrid[-R:R + 1, -R:R + 1].astype(np.float32)
    r_cut = (R - 1) ** 2
    exps, planted = [], []
    shifts = [tuple(rng.uniform(-shift_scale, shift_scale, 2))
              for _ in range(n_exp)]
    for e in range(n_exp):
        dx, dy = shifts[e]
        planted.append((float(dx), float(dy)))
        img = rng.normal(0, noise, shape).astype(np.float32)
        for x0, y0 in stars:
            cx, cy = int(round(x0)), int(round(y0))
            r2 = (pxx + cx - x0 - dx) ** 2 + (pyy + cy - y0 - dy) ** 2
            img[cy - R:cy + R + 1, cx - R:cx + R + 1] += np.where(
                r2 < r_cut, amp * np.exp(-r2 / (2 * sigma * sigma)),
                0.0)
        wcs = TanWCS(crpix=np.array([W / 2, H / 2]),
                     crval=np.array([150.0, 2.0]), cd=cd)
        exps.append(Exposure(img, wcs, name=f"sim{e}"))
    return exps, planted


def pairwise_shift_errors(shifts, planted) -> float:
    """Max pairwise |fitted - planted| relative shift error in pixels.

    ``shifts``: the (E, 2) fitted corrections from ``AlignResult``;
    ``planted``: the true per-exposure (dx, dy) errors from
    :func:`simulate_stack`. Only frame DIFFERENCES are compared —
    alignment is gauge-free (a common shift of all frames is
    unobservable).
    """
    sh = np.asarray(shifts)
    errs = []
    for i in range(len(planted)):
        for j in range(len(planted)):
            got = sh[i] - sh[j]
            want = (planted[j][0] - planted[i][0],
                    planted[j][1] - planted[i][1])
            errs.append(float(np.hypot(got[0] - want[0],
                                       got[1] - want[1])))
    return max(errs)
