"""Port parity: ops.drizzle, the deposit kernel B1 and Drizzle vs subpixal_tpu.

The same numpy inputs go through the JAX package's XLA deposit (on the
CPU) and the port's. Accumulators agree to ``ATOL`` (float32 evaluations
of the same per-cell formulas; scatter sums may be taken in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.ops.drizzle import drizzle_combine as j_combine
from subpixal_tpu.ops.drizzle import drizzle_deposit as j_deposit
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.kernels.drizzle import drizzle_deposit as k_deposit
from subpixal_tpu_torch.ops.drizzle import (DRIZZLE_KERNELS, drizzle_combine,
                                            drizzle_deposit)
from subpixal_tpu_torch.resample import Drizzle

torch.set_num_threads(2)

#: accumulators hold O(10) values: a few float32 ulps of the cell sums
ATOL = 2e-5


def _scene(ratio, seed=0, H=20, W=24):
    """Data, weights (some zero) and a rotated, scaled, offset pixmap."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    wht = rng.uniform(0.5, 1.5, (H, W)).astype(np.float32)
    wht[rng.random((H, W)) < 0.15] = 0.0
    th = np.deg2rad(7.0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xo = ratio * (np.cos(th) * xx - np.sin(th) * yy) + 4.37
    yo = ratio * (np.sin(th) * xx + np.cos(th) * yy) + 3.81
    oshape = (int(ratio * (H + W)) + 10, int(ratio * (H + W)) + 10)
    return data, wht, xo.astype(np.float32), yo.astype(np.float32), oshape


@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
@pytest.mark.parametrize("pixfrac", [1.0, 0.6])
@pytest.mark.parametrize("ratio", [1.0, 0.5, 2.0])
def test_deposit_matches_jax(kernel, pixfrac, ratio):
    data, wht, xo, yo, oshape = _scene(ratio)
    kw = dict(pixfrac=pixfrac, pscale_ratio=ratio, kernel=kernel)
    js, jw = j_deposit(jnp.asarray(data), jnp.asarray(wht), jnp.asarray(xo),
                       jnp.asarray(yo), oshape, **kw)
    ts, tw = drizzle_deposit(*(torch.from_numpy(a)
                               for a in (data, wht, xo, yo)), oshape, **kw)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    assert float(tw.sum()) > 0
    np.testing.assert_allclose(
        drizzle_combine(ts, tw, fill=-1.0).numpy(),
        np.asarray(j_combine(js, jw, fill=-1.0)), rtol=1e-5, atol=ATOL)


def test_zero_weight_pixels_deposit_nothing():
    data, wht, xo, yo, oshape = _scene(1.0)
    wht[:] = 0.0
    wht[5, 7] = 2.0
    s, w = drizzle_deposit(*(torch.from_numpy(a) for a in (data, wht, xo, yo)),
                           oshape)
    np.testing.assert_allclose(float(w.sum()), 2.0, rtol=1e-6)
    np.testing.assert_allclose(float(s.sum()), 2.0 * data[5, 7], rtol=1e-6)


@pytest.mark.parametrize("kernel", ["square", "tophat"])
def test_kernel_wrapper_cpu_plain_and_escaped_zero(kernel):
    """The B1 wrapper on CPU tensors is the plain version; ``escaped`` is
    0 by construction (the CUDA kernel has no static tile)."""
    t = [torch.from_numpy(a) for a in _scene(1.0)[:4]]
    oshape = _scene(1.0)[4]
    s, w, esc = k_deposit(t[0], t[1], t[2], t[3], oshape, kernel=kernel)
    ps, pw = drizzle_deposit(t[0], t[1], t[2], t[3], oshape, kernel=kernel)
    assert torch.equal(s, ps) and torch.equal(w, pw)
    assert esc.dtype == torch.int32 and int(esc) == 0
    with pytest.raises(ValueError):
        k_deposit(t[0], t[1], t[2], t[3], oshape, kernel="boxcar")


def _jax_exposures():
    rng = np.random.default_rng(4)
    s = 0.05 / 3600.0
    exps = []
    for e, (dx, dy, rot) in enumerate([(0, 0, 0.0), (3.3, -2.1, 0.4),
                                       (-1.7, 4.2, -0.3)]):
        th = np.deg2rad(rot)
        cd = s * np.array([[-np.cos(th), np.sin(th)],
                           [np.sin(th), np.cos(th)]])
        wcs = JTanWCS(crpix=np.array([20.0 + dx, 16.0 + dy]),
                      crval=np.array([150.0, 2.0]), cd=cd)
        data = rng.normal(5.0, 1.0, (32, 40)).astype(np.float32)
        weight = (rng.random((32, 40)) > 0.1).astype(np.float32)
        exps.append(JExposure(data, wcs, weight=weight,
                              exptime=100.0 + 50 * e, name=f"x{e}"))
    return exps


@pytest.mark.parametrize("kernel", ["square", "gaussian"])
def test_drizzle_execute_output_sci_matches_jax(kernel):
    jexps = _jax_exposures()
    jd = JDrizzle(jexps, pixfrac=0.8, kernel=kernel, use_pallas=False)
    td = Drizzle(exposures_from_reference(jexps), pixfrac=0.8,
                 kernel=kernel, device="cpu")
    assert td.output_shape == tuple(jd.output_shape)
    np.testing.assert_allclose(td.output_sci, np.asarray(jd.output_sci),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(td.output_wht, np.asarray(jd.output_wht),
                               rtol=1e-5, atol=1e-3)


def test_drizzle_left_out_branches_raise():
    d = Drizzle(exposures_from_reference(_jax_exposures()), device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        d.fast_add_image(d.exposures[0])
    with pytest.raises(NotImplementedError, match="A10"):
        d.fast_drop_image("x0")
    with pytest.raises(NotImplementedError, match="A16"):
        Drizzle([], spatial_mesh=object(), device="cpu")
