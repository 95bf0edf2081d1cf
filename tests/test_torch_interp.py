"""Port parity: ops.interp and the blot gather (kernel B2) vs subpixal_tpu.

The same numpy inputs, made from a seed, go through the JAX package's
``sample_image`` (XLA on the CPU) and the port's. Values agree to
``ATOL`` (both are float32 evaluations of the same formulas; the order of
the tap sums and the libm differ), validity masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from subpixal_tpu.ops.interp import bspline3_prefilter as j_prefilter
from subpixal_tpu.ops.interp import sample_image as j_sample
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.ops.interp import (INTERP_OFFSETS, INTERP_TAPS,
                                           bspline3_prefilter)
from subpixal_tpu_torch.ops.interp import sample_image as t_sample

torch.set_num_threads(2)

#: values are O(1): a few float32 ulps of the tap sums
ATOL = 2e-5

INTERPS = sorted(INTERP_TAPS)


def _field(h=48, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.normal(size=(h, w)), 2.0).astype(
        np.float32) * 10


def _coords(shape, n=(5, 12, 12), seed=1):
    """(B, h, w) grids reaching past every edge, so validity is mixed."""
    rng = np.random.default_rng(seed)
    H, W = shape
    x = rng.uniform(-4, W + 4, n).astype(np.float32)
    y = rng.uniform(-4, H + 4, n).astype(np.float32)
    # a few exact integer and half-integer positions
    x[0, 0, :6] = [0.0, 1.0, 2.5, W - 3.0, W - 3.5, 10.0]
    return x, y


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("fill", [0.0, -7.5])
def test_sample_image_matches_jax(interp, fill):
    img = _field()
    x, y = _coords(img.shape)
    jv, jok = j_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                       interp=interp, fill=fill)
    tv, tok = t_sample(torch.from_numpy(img), torch.from_numpy(x),
                       torch.from_numpy(y), interp=interp, fill=fill)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < tok.float().mean() < 1  # both valid and invalid samples
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    assert np.all(tv.numpy()[~tok.numpy()] == np.float32(fill))


def test_bspline3_prefilter_matches_jax_and_scipy():
    img = _field(40, 33, seed=3)
    c = bspline3_prefilter(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(c, np.asarray(j_prefilter(img)), atol=ATOL)
    ref = ndimage.spline_filter(img.astype(np.float64), order=3,
                                mode="mirror")
    np.testing.assert_allclose(c, ref, atol=1e-4)


@pytest.mark.parametrize("interp", INTERPS)
def test_sample_cutouts_cpu_takes_plain_version(interp):
    """On a CPU tensor the B2 wrapper is the plain version, with zero
    escape counts (the CUDA kernel has no tiles to escape)."""
    img = torch.from_numpy(_field())
    x, y = (torch.from_numpy(a) for a in _coords(tuple(img.shape)))
    v, ok, esc = sample_cutouts(img, x, y, interp=interp, fill=1.5)
    pv, pok = t_sample(img, x, y, interp=interp, fill=1.5)
    assert torch.equal(v, pv) and torch.equal(ok, pok)
    assert esc.shape == (x.shape[0],) and esc.dtype == torch.int32
    assert int(esc.abs().sum()) == 0


def test_sample_cutouts_rejects_bad_shapes():
    img = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        sample_cutouts(img, torch.zeros(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        sample_cutouts(img, torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
                       interp="cubic")


@pytest.mark.parametrize("interp", INTERPS)
def test_band_row0_sampling_equals_whole_plane(interp):
    """A band of a plane sampled at the plane's coordinates with
    ``row0`` (the band's first row; B2's wrapper, plain on the CPU) gives
    the whole plane's values bit for bit where the footprint lies in the
    band, and validity exactly where it does: the row origin is taken in
    integers, so no fraction is rounded. Rows near 1024, where a float
    shift by the band's offset would round the fraction, are among them."""
    rng = np.random.default_rng(4)
    plane = torch.tensor(rng.uniform(0.0, 4.0, (1100, 40)),
                         dtype=torch.float32)
    if interp == "spline3":
        plane = bspline3_prefilter(plane)
    r0, r1 = 1000, 1060
    band = plane[r0:r1].contiguous()
    x = torch.tensor(rng.uniform(-3, 43, (8, 6, 7)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(r0 - 4, r1 + 4, (8, 6, 7)),
                     dtype=torch.float32)
    kw = dict(interp=interp, fill=-3.0, prefiltered=True)
    want, wok = t_sample(plane, x, y, **kw)
    got, ok, _ = sample_cutouts(band, x, y, row0=r0, **kw)
    offs = INTERP_OFFSETS[interp]
    fy = torch.floor(y + 0.5 if interp == "nearest" else y).long()
    inside = (fy + offs[0] >= r0) & (fy + offs[-1] < r1)
    assert torch.equal(ok, wok & inside) and bool(ok.any())
    assert torch.equal(got[ok], want[ok])
    assert bool((got[~ok] == -3.0).all())
