"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so
without one every test here skips. The file imports neither ``jax`` nor
``subpixal_tpu`` (the card's machine has no JAX), and runs there with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernels and plain versions evaluate the same float32 formulas; B1's
atomics sum in an order that changes from run to run and both kernels
fuse multiply-adds, so values agree to ``REL_TOL`` relative to the
largest plain value (at least 1), and validity and escape counts exactly.
"""

import numpy as np
import pytest
import torch

from subpixal_tpu_torch import align_images, kernels
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.kernels.drizzle import drizzle_deposit
from subpixal_tpu_torch.ops.drizzle import DRIZZLE_KERNELS
from subpixal_tpu_torch.ops.drizzle import drizzle_deposit as plain_deposit
from subpixal_tpu_torch.ops.interp import INTERP_TAPS, sample_image
from subpixal_tpu_torch.testing import pairwise_shift_errors, simulate_stack

torch.set_num_threads(2)

REL_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= REL_TOL * scale


def _deposit_scene(dev, H=200, W=240, ratio=1.3, seed=0):
    """Data, weights (15 % zero) and a rotated, scaled, offset pixmap."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(7.0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    planes = dict(
        data=rng.uniform(0.5, 3.0, (H, W)),
        wht=rng.uniform(0.5, 1.5, (H, W)) * (rng.random((H, W)) > 0.15),
        x=ratio * (np.cos(th) * xx - np.sin(th) * yy) + 4.37,
        y=ratio * (np.sin(th) * xx + np.cos(th) * yy) + 3.81)
    oshape = (int(ratio * (H + W)) + 10,) * 2
    return ({k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in planes.items()}, oshape)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
def test_deposit_kernel_matches_plain(card, kernel):
    t, oshape = _deposit_scene(card)
    kw = dict(pixfrac=0.8, pscale_ratio=1.3, kernel=kernel)
    for wht in (t["wht"], None):  # per-pixel and unit weights
        before = kernels.LAUNCHES["drizzle_deposit"]
        s, w, esc = drizzle_deposit(t["data"], wht, t["x"], t["y"], oshape,
                                    **kw)
        ps, pw = plain_deposit(t["data"], wht, t["x"], t["y"], oshape, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["drizzle_deposit"] == before + 1
        assert float(pw.sum()) > 0
        assert _close(s, ps) and _close(w, pw)
        assert esc.device.type == "cuda" and int(esc) == 0


def _cutout_grids(dev, shape=(256, 300), n=(64, 32, 32), seed=1):
    """An image and (B, h, w) grids reaching past every edge."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    img = rng.normal(0.0, 0.1, shape)
    for cx, cy in rng.uniform(0, W, (40, 2)):
        img += 10.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.0)
    x = rng.uniform(-4, W + 4, n)
    y = rng.uniform(-4, H + 4, n)
    return (torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (img, x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("interp", sorted(INTERP_TAPS))
def test_gather_kernel_matches_plain(card, interp):
    img, x, y = _cutout_grids(card)
    before = kernels.LAUNCHES["blot_gather"]
    v, ok, esc = sample_cutouts(img, x, y, interp=interp, fill=-2.5)
    pv, pok = sample_image(img, x, y, interp=interp, fill=-2.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blot_gather"] == before + 1
    assert torch.equal(ok, pok) and 0 < float(ok.float().mean()) < 1
    assert _close(v, pv)
    assert bool((v[~ok] == -2.5).all())
    assert esc.shape == (x.shape[0],) and int(esc.abs().sum()) == 0


@pytest.mark.cuda
def test_kernels_raise_on_inputs_they_do_not_take(card):
    """A CUDA tensor takes the kernel or raises: no plain fallback."""
    t, oshape = _deposit_scene(card, H=16, W=20)
    with pytest.raises(ValueError):
        drizzle_deposit(t["data"].double(), t["wht"], t["x"], t["y"], oshape)
    with pytest.raises(ValueError):
        drizzle_deposit(t["data"].t(), None, t["x"].t(), t["y"].t(), oshape)
    img, x, y = _cutout_grids(card, shape=(32, 32), n=(2, 8, 8))
    with pytest.raises(ValueError):
        sample_cutouts(img, x.double(), y.double())
    with pytest.raises(ValueError):
        sample_cutouts(img.t(), x, y)


@pytest.mark.cuda
def test_align_goes_through_kernels(card):
    """On the card the loop launches both kernels, recovers the planted
    shifts, and its first iteration equals the CPU run's."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kernels.reset_launch_counts()
    res = align_images(exposures=exps, device="cuda", max_iterations=6)
    assert kernels.LAUNCHES["drizzle_deposit"] > 0
    assert kernels.LAUNCHES["blot_gather"] > 0
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(exposures=exps, device="cpu", max_iterations=1)
    for a, b in zip(res.history[0], cpu.history[0]):
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3
