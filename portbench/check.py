"""The numbers that decide ``correct``: the program's alignment states held
to the plain reference's, and its answers held to the planted truth.

Both are taken at five test points of each exposure (its corners and its
center, on the reference grid), pairwise over the exposures, because an
alignment is relative: a shift common to every exposure is not
observable. A state maps a predicted reference-grid position ``q`` to
``M q + t``.

* ``state_mpix``: the largest pairwise gap, in milli-pixels, between the
  program's state after an iteration and the reference's after the same
  iteration, over every iteration of every call and the answer each call
  returned. The program's states are composed from its per-iteration fit
  records; the reference's grid may sit a whole pixel from the program's
  (``delta``, from the two grids' crpix), and is moved onto it.
* ``truth_mpix``: the largest pairwise gap between the correction each
  call returned and the planted pointing errors (a planted error ``p``
  is undone by ``t = -p``), as ``testing.pairwise_shift_errors`` counts
  it, at the five points.
"""

from __future__ import annotations

import numpy as np


def test_points(shape, to_grid) -> np.ndarray:
    """(5, 2) grid positions of an (H, W) exposure's corners and center,
    through ``to_grid(x, y) -> (gx, gy)``."""
    H, W = shape
    x = np.array([0.0, W - 1.0, 0.0, W - 1.0, (W - 1) / 2.0])
    y = np.array([0.0, 0.0, H - 1.0, H - 1.0, (H - 1) / 2.0])
    gx, gy = to_grid(x, y)
    return np.stack([np.asarray(gx), np.asarray(gy)], 1)


def _apply(M, t, q):
    """(E, P, 2) images of points q (P, 2) under each state (M, t)."""
    return np.einsum("eij,pj->epi", M, q) + t[:, None, :]


def pairwise_mpix(d) -> float:
    """Largest |d_i - d_j| over exposure pairs and points, milli-pixels,
    for displacements d (E, P, 2)."""
    diff = d[:, None] - d[None, :]
    return 1e3 * float(np.sqrt((diff ** 2).sum(-1)).max())


def composed_states(GM, Gt):
    """States after each iteration from per-iteration fits (n, E, 2, 2)
    and (n, E, 2), starting from the identity: M' = G M, t' = G t + g."""
    E = GM.shape[1]
    M = np.tile(np.eye(2), (E, 1, 1))
    t = np.zeros((E, 2))
    out = []
    for G, g in zip(GM, Gt):
        t = np.einsum("eij,ej->ei", G, t) + g
        M = np.einsum("eij,ejk->eik", G, M)
        out.append((M, t))
    return out


def state_gap(states, final, crpix, ref, q) -> float:
    """``state_mpix`` of a run of the alignment, on a grid whose crpix is
    ``crpix``, against the reference result ``ref`` of its visit, at
    points ``q`` (P, 2) on that grid: each state (M, t) after an iteration
    against the reference's after the same iteration, and the answer
    ``final`` returned against the reference's after the last one."""
    delta = np.asarray(crpix, np.float64) - np.asarray(ref.crpix)
    pairs = list(zip(states, ref.states)) + [
        (final, ref.states[len(states) - 1])]
    worst = 0.0
    for (M, t), (Mr, tr) in pairs:
        d = _apply(M, t, q) - (_apply(Mr, tr, q - delta) + delta)
        worst = max(worst, pairwise_mpix(d))
    return worst


def truth_gap(final, planted, q) -> float:
    """``truth_mpix`` of an answer (M, t) against the planted errors
    (E, 2)."""
    M, t = final
    d = _apply(M, t, q) - q[None] + np.asarray(planted)[:, None, :]
    return pairwise_mpix(d)
