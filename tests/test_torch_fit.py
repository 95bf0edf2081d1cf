"""Port parity: ops.fit.iter_linear_fit vs subpixal_tpu.

Seeded point sets with a planted affine, noise and gross outliers go
through both fits (shift, rscale, general, with sigma clipping). The
fitted matrix and shift agree to float32 rounding of the moment sums;
the clipping selects the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.ops.fit import iter_linear_fit as j_fit
from subpixal_tpu_torch.ops.fit import apply_affine, iter_linear_fit

torch.set_num_threads(2)


def _points(seed, n=60, far=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (n, 2))
    if far:  # catalog far from the origin: tests the centring
        xy += 3500.0
    th = np.deg2rad(0.05)
    M = 1.0002 * np.array([[np.cos(th), -np.sin(th)],
                           [np.sin(th), np.cos(th)]])
    M[0, 1] += 2e-4
    uv = xy @ M.T + np.array([0.7, -0.35]) + rng.normal(0, 0.02, (n, 2))
    uv[:4] += rng.uniform(3, 6, (4, 2))  # outliers for the clipping
    w = rng.uniform(0.2, 1.0, n)
    w[7] = 0.0
    return xy.astype(np.float32), uv.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("fitgeom", ["shift", "rscale", "general"])
@pytest.mark.parametrize("nclip", [0, 3])
@pytest.mark.parametrize("far", [False, True])
def test_iter_linear_fit_matches_jax(fitgeom, nclip, far):
    xy, uv, w = _points(1, far=far)
    j = j_fit(jnp.asarray(xy), jnp.asarray(uv), wxy=jnp.asarray(w),
              fitgeom=fitgeom, nclip=nclip, sigma=3.0)
    t = iter_linear_fit(torch.from_numpy(xy), torch.from_numpy(uv),
                        torch.from_numpy(w), fitgeom=fitgeom, nclip=nclip,
                        sigma=3.0)
    np.testing.assert_array_equal(t.weights.numpy() > 0,
                                  np.asarray(j.weights) > 0)
    assert int(t.nmatches) == int(j.nmatches)
    np.testing.assert_allclose(t.matrix.numpy(), np.asarray(j.matrix),
                               atol=2e-6)
    np.testing.assert_allclose(t.shift.numpy(), np.asarray(j.shift),
                               atol=2e-3 if far else 2e-4)
    for f in ("rms", "rmse", "mae"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=2e-3,
                                   atol=1e-5)
    if nclip:
        assert (t.weights[:4] == 0).all()  # the outliers were clipped


def test_batched_fit_equals_per_frame_fits():
    """Leading batch axes replace the JAX package's vmap over frames."""
    sets = [_points(s) for s in (2, 3, 4)]
    xy, uv, w = (torch.from_numpy(np.stack(a)) for a in zip(*sets))
    tb = iter_linear_fit(xy, uv, w, fitgeom="general")
    jv = jax.vmap(lambda a, b, c: j_fit(a, b, wxy=c, fitgeom="general"))(
        *(jnp.asarray(a.numpy()) for a in (xy, uv, w)))
    np.testing.assert_allclose(tb.matrix.numpy(), np.asarray(jv.matrix),
                               atol=2e-6)
    np.testing.assert_allclose(tb.shift.numpy(), np.asarray(jv.shift),
                               atol=2e-4)
    for e in range(3):
        te = iter_linear_fit(xy[e], uv[e], w[e], fitgeom="general")
        np.testing.assert_allclose(te.shift.numpy(), tb.shift[e].numpy(),
                                   atol=1e-5)


def test_dead_frame_keeps_identity():
    xy, uv, w = _points(5)
    t = iter_linear_fit(torch.from_numpy(xy), torch.from_numpy(uv),
                        torch.zeros(len(w)), fitgeom="general")
    np.testing.assert_array_equal(t.matrix.numpy(), np.eye(2))
    np.testing.assert_array_equal(t.shift.numpy(), 0.0)


def test_apply_affine():
    xy = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    M = torch.tensor([[0.0, -1.0], [1.0, 0.0]])
    out = apply_affine(xy, M, torch.tensor([0.5, 0.25]))
    np.testing.assert_allclose(out.numpy(), [[-1.5, 1.25], [1.5, 3.25]])
