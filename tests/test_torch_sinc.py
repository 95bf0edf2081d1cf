"""Port parity: the windowed sinc at any ``sinscl`` vs the JAX package.

``blot_cutout``, ``blot_image`` and kernel B2's wrapper
``kernels.blot.sample_cutouts`` with ``interp='sinc'`` and ``sinscl`` other
than 1 run their plain versions on CPU tensors (on CUDA tensors the same
calls launch B2, held to those plain versions in ``test_torch_cuda.py``),
and are held here to the JAX package's ``blot_cutout`` / ``blot_image`` /
``ops.interp.sample_image`` on the same numpy inputs: values within
``REL_TOL`` of the largest value (at least 1), validity equal. At
``sinscl`` 0.5 the sinc's taps sum to ~0 near fraction 0.5, where both
packages take bilinear weights; one test asserts that its queries reach
that guard.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu import blot as JB
from subpixal_tpu.cutout import Cutout as JCutout
from subpixal_tpu.ops.interp import sample_image as j_sample
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import blot as TB
from subpixal_tpu_torch.convert import wcs_from_reference
from subpixal_tpu_torch.cutout import Cutout
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.ops.interp import INTERP_OFFSETS

torch.set_num_threads(2)

REL_TOL = 1e-5


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) <= REL_TOL * scale


def _stars(shape=(80, 96), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    img = rng.normal(0, 0.05, shape)
    for cx, cy in rng.uniform(8, 72, (6, 2)):
        img += 5.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 5.0)
    return img.astype(np.float32)


def _tap_sum(t, sinscl):
    """The sinc's raw tap sum per axis at fractions ``t`` (the quantity
    the bilinear guard tests), in float64."""
    total = np.zeros_like(t, np.float64)
    for o in INTERP_OFFSETS["sinc"]:
        x = t.astype(np.float64) - o
        main = np.sinc(x / sinscl)
        win = np.sinc(x / 3.0)
        total += np.where(np.abs(x) >= 3.0, 0.0, main * win)
    return total


@pytest.mark.parametrize("sinscl", [0.5, 1.5, 2.0])
def test_blot_cutout_sinc_sinscl_matches_jax(sinscl):
    """blot_cutout(interp='sinc', sinscl=s) onto a grid offset by a
    fraction of a pixel, against the JAX package's."""
    img = _stars()
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    jsrc_wcs = JTanWCS(crpix=np.array([48.0, 40.0]),
                       crval=np.array([150.0, 2.0]), cd=cd)
    jimg_wcs = jsrc_wcs.with_shifted_crpix(10.3, 7.6)
    jsrc = JCutout(img, jsrc_wcs, exptime=100.0)
    jimg = JCutout(np.zeros((40, 36), np.float32), jimg_wcs, blc=(7, 10),
                   exptime=300.0)
    tsrc = Cutout(img, wcs_from_reference(jsrc_wcs), exptime=100.0)
    timg = Cutout(np.zeros((40, 36), np.float32),
                  wcs_from_reference(jimg_wcs), blc=(7, 10), exptime=300.0)
    jo = JB.blot_cutout(jsrc, jimg, interp="sinc", sinscl=sinscl)
    to = TB.blot_cutout(tsrc, timg, interp="sinc", sinscl=sinscl,
                        device="cpu")
    np.testing.assert_array_equal(to.mask, np.asarray(jo.mask))
    assert _close(to.data, jo.data)
    # the scale is honoured: not the sinscl = 1 values
    one = TB.blot_cutout(tsrc, timg, interp="sinc", device="cpu")
    assert not _close(to.data, one.data)


def test_blot_image_sinc_half_scale_reaches_bilinear_guard():
    """blot_image at sinscl 0.5 on a pixmap whose fractions sit on, near
    and across the guard's band around 0.5 (where the taps sum to ~0),
    against the JAX package's."""
    img = _stars()
    rng = np.random.default_rng(3)
    fx = np.concatenate([np.full(40, 0.5), 0.5 + rng.uniform(-0.02, 0.02, 160),
                         rng.uniform(0, 1, 400)])
    fy = np.concatenate([rng.uniform(0, 1, 200), np.full(40, 0.5),
                         0.5 + rng.uniform(-0.02, 0.02, 360)])
    px = (rng.integers(-3, 97, 600) + fx).astype(np.float32).reshape(20, 30)
    py = (rng.integers(-3, 81, 600) + fy).astype(np.float32).reshape(20, 30)
    guard = (np.abs(_tap_sum(px - np.floor(px), 0.5)) < 1e-3) | (
        np.abs(_tap_sum(py - np.floor(py), 0.5)) < 1e-3)
    assert guard.sum() >= 100 and (~guard).sum() >= 100
    jv, jok = JB.blot_image(img, px, py, interp="sinc", expout=2.5,
                            fill=-1.0, sinscl=0.5)
    tv, tok = TB.blot_image(img, px, py, interp="sinc", expout=2.5,
                            fill=-1.0, sinscl=0.5, device="cpu")
    assert tuple(tv.shape) == (20, 30)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < tok.numel() and bool(tok[torch.from_numpy(
        guard)].any())
    assert _close(tv.numpy(), jv)


@pytest.mark.parametrize("sinscl", [0.5, 1.5, 2.0])
def test_sample_cutouts_sinc_sinscl_matches_jax(sinscl):
    """Kernel B2's wrapper on CPU tensors: (B, h, w) cutout grids, rotated
    and reaching past the image's edges, against the JAX sample_image."""
    img = _stars(seed=1)
    rng = np.random.default_rng(int(10 * sinscl))
    B, n = 12, 9
    th = math.radians(0.7)
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float64)
    cen = rng.uniform(-4, 100, (B, 2))
    x = (math.cos(th) * gx - math.sin(th) * gy)[None] + cen[:, 0, None, None]
    y = (math.sin(th) * gx + math.cos(th) * gy)[None] + cen[:, 1, None, None]
    x, y = x.astype(np.float32), y.astype(np.float32)
    jv, jok = j_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                       interp="sinc", fill=-2.5, sinscl=sinscl)
    tv, tok, esc = sample_cutouts(torch.from_numpy(img), torch.from_numpy(x),
                                  torch.from_numpy(y), interp="sinc",
                                  fill=-2.5, sinscl=sinscl)
    assert tv.shape == (B, n, n) and int(esc.abs().sum()) == 0
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < tok.numel()
    assert _close(tv.numpy(), jv)
    assert bool((tv[~tok] == -2.5).all())
