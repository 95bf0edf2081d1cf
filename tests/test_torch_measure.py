"""Port parity: the windowed measurement (the plain version of kernel B3)
vs the JAX package's fused kernel.

``subpixal_tpu_torch.ops.correlate.measure_window`` is held to
``subpixal_tpu.kernels.measure.measure_displacement_rank3`` run in
interpret mode on the CPU, on the cases of
``tests/test_pallas_kernels.py`` (masked and unmasked NCC, CC with a
ragged batch, ZNCC with a shared mask): the coarse shifts ``s0`` must be
equal and the window ``C2`` within ``5e-4 * max|C2|``, the bar the JAX
package holds its kernel to against its own XLA path. ``find_displacement``
(which takes ``measure_window`` here) must give the kernel pipeline's
shifts within 1e-5 px. Batches stay small: interpret mode is slow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.kernels.measure import measure_displacement_rank3
from subpixal_tpu.ops.peaks import find_peak as j_find_peak
import subpixal_tpu_torch
from subpixal_tpu_torch import kernels
from subpixal_tpu_torch.kernels import measure as kmeasure
from subpixal_tpu_torch.ops import correlate as OC
from subpixal_tpu_torch.ops.peaks import normalize_search_box

torch.set_num_threads(2)

#: window bar relative to the largest |C2| (the JAX kernel's own bar)
C2_TOL = 5e-4
#: end-to-end shift bar (px)
SHIFT_TOL = 1e-5


def _star_pairs(B, H, W, seed, shift=2.0, noise=1e-3):
    """Gaussian star cutouts and copies shifted by up to ``shift`` px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx = rng.uniform(-shift, shift, B)[:, None, None]
    dy = rng.uniform(-shift, shift, B)[:, None, None]
    refs = (np.exp(-((xx[None] - W / 2) ** 2 + (yy[None] - H / 2) ** 2)
                   / 8.0) + rng.normal(0, noise, (B, H, W)))
    imgs = (np.exp(-((xx[None] - W / 2 - dx) ** 2
                     + (yy[None] - H / 2 - dy) ** 2) / 8.0)
            + rng.normal(0, noise, (B, H, W)))
    return refs.astype(np.float32), imgs.astype(np.float32), rng


def _noise_pairs(B, H, W, seed, roll):
    rng = np.random.default_rng(seed)
    refs = rng.normal(size=(B, H, W)).astype(np.float32)
    imgs = (np.roll(refs, roll, axis=(1, 2))
            + rng.normal(0, 1e-3, (B, H, W))).astype(np.float32)
    return refs, imgs, rng


def _both(refs, imgs, rmask, imask, cc_type, usfac, nwin, bounds):
    jm = [None if m is None else jnp.asarray(m) for m in (rmask, imask)]
    C2j, syj, sxj = measure_displacement_rank3(
        jnp.asarray(refs), jnp.asarray(imgs), *jm, cc_type=cc_type,
        usfac=usfac, nwin=nwin, bounds=bounds, interpret=True)
    tm = [None if m is None else torch.from_numpy(m) for m in (rmask, imask)]
    if rmask is not None and rmask is imask:
        tm[1] = tm[0]
    C2t, syt, sxt = OC.measure_window(
        torch.from_numpy(refs), torch.from_numpy(imgs), *tm,
        cc_type=cc_type, usfac=usfac, nwin=nwin, bounds=bounds)
    return (np.asarray(C2j), np.asarray(syj), np.asarray(sxj),
            C2t.numpy(), syt.numpy(), sxt.numpy())


def _assert_window_parity(j, t):
    (C2j, syj, sxj), (C2t, syt, sxt) = j, t
    np.testing.assert_array_equal(syt, syj)
    np.testing.assert_array_equal(sxt, sxj)
    assert syt.dtype == np.int32 and sxt.dtype == np.int32
    scale = float(np.abs(C2j).max())
    np.testing.assert_allclose(C2t, C2j, rtol=0, atol=C2_TOL * scale)


@pytest.mark.parametrize("masked", [False, True])
def test_measure_window_ncc_matches_jax_kernel(masked):
    B, H, W = 13, 64, 64
    refs, imgs, rng = _star_pairs(B, H, W, seed=7)
    rmask = imask = None
    if masked:
        rmask = (rng.uniform(size=(B, H, W)) > 0.05).astype(np.float32)
        imask = (rng.uniform(size=(B, H, W)) > 0.05).astype(np.float32)
    usfac, pfb = 10, 5
    bounds = normalize_search_box(7, H, W, pfb)  # covers the ±2 px shifts
    nwin = -(-(usfac + pfb + 1) // 8) * 8
    out = _both(refs, imgs, rmask, imask, "NCC", usfac, nwin, bounds)
    _assert_window_parity(out[:3], out[3:])
    assert out[5].min() < 0 < out[5].max()  # lags on both sides of zero


def test_measure_window_cc_ragged_batch_matches_jax_kernel():
    """CC on a batch that is no multiple of the JAX kernel's block, on a
    non-square shape."""
    refs, imgs, _ = _noise_pairs(5, 32, 48, seed=3, roll=(1, -2))
    bounds = normalize_search_box(7, 32, 48, 5)
    out = _both(refs, imgs, None, None, "CC", 8, 16, bounds)
    _assert_window_parity(out[:3], out[3:])
    assert (out[4] == 1).all() and (out[5] == -2).all()


def test_measure_window_zncc_shared_mask_matches_jax_kernel():
    refs, imgs, rng = _noise_pairs(9, 32, 32, seed=11, roll=(-1, 2))
    m = (rng.uniform(size=(9, 32, 32)) > 0.2).astype(np.float32)
    bounds = normalize_search_box(7, 32, 32, 5)
    out = _both(refs, imgs, m, m, "ZNCC", 10, 16, bounds)
    _assert_window_parity(out[:3], out[3:])


@pytest.mark.parametrize("H,W", [(48, 48), (80, 80), (96, 96), (128, 128),
                                 (48, 80)])
@pytest.mark.parametrize("cc_type,masked", [("NCC", True), ("NCC", False),
                                            ("CC", True)])
def test_measure_window_mixed_radix_shapes_match_jax_kernel(H, W, cc_type,
                                                            masked):
    """The shapes the CUDA port measures with its mixed-radix kernel (the
    auto-sizing's 48, 80, 96, 128 and a non-square one), at usfac 8 with
    the align loop's search box."""
    B = 3
    refs, imgs, rng = _star_pairs(B, H, W, seed=H + W, shift=0.45)
    m = ((rng.uniform(size=(B, H, W)) > 0.05).astype(np.float32)
         if masked else None)
    bounds = normalize_search_box("fitbox", H, W, 5)
    out = _both(refs, imgs, m, m, cc_type, 8, 16, bounds)
    _assert_window_parity(out[:3], out[3:])


def test_measure_window_rejects_unknown_cc_type():
    a = torch.zeros((2, 16, 16))
    for fn in (OC.measure_window, kmeasure.measure_window):
        with pytest.raises(ValueError, match="cc_type"):
            fn(a, a, cc_type="nope", usfac=4, nwin=8, bounds=(4, 12, 4, 12))


@pytest.mark.parametrize("kernel", ["fft", "mixed_radix"])
def test_measure_window_kernel_choice_on_cpu_matches_jax_kernel(kernel):
    """Asking for either CUDA kernel on CPU tensors still takes the plain
    version, which matches the JAX kernel; an unknown kernel raises."""
    refs, imgs, rng = _star_pairs(4, 32, 32, seed=5, shift=0.45)
    m = (rng.uniform(size=(4, 32, 32)) > 0.05).astype(np.float32)
    bounds = normalize_search_box("fitbox", 32, 32, 5)
    out = _both(refs, imgs, m, m, "NCC", 8, 16, bounds)
    tm = torch.from_numpy(m)
    got = kmeasure.measure_window(
        torch.from_numpy(refs), torch.from_numpy(imgs), tm, tm,
        cc_type="NCC", usfac=8, nwin=16, bounds=bounds, kernel=kernel)
    _assert_window_parity(out[:3], [g.numpy() for g in got])
    with pytest.raises(ValueError, match="kernel"):
        kmeasure.measure_window(
            torch.from_numpy(refs), torch.from_numpy(imgs), cc_type="NCC",
            usfac=8, nwin=16, bounds=bounds, kernel="cufft")


def test_find_displacement_shifts_match_jax_kernel_pipeline():
    """find_displacement through the windowed measurement gives the JAX
    kernel pipeline's subpixel shifts (kernel window + JAX peak fit)."""
    B, H, W = 9, 64, 64
    refs, imgs, _ = _star_pairs(B, H, W, seed=21, shift=0.5)
    usfac, pfb = 10, 5
    bounds = normalize_search_box("fitbox", H, W, pfb)
    nwin = -(-(usfac + pfb + 1) // 8) * 8
    C2, s0y, s0x = measure_displacement_rank3(
        jnp.asarray(refs), jnp.asarray(imgs), cc_type="NCC", usfac=usfac,
        nwin=nwin, bounds=bounds, interpret=True)
    pk = j_find_peak(C2, peak_fit_box=pfb, fit_type="gaussian")
    half = (nwin // 2) / usfac
    dxj = np.asarray(s0x, np.float32) - half + np.asarray(pk.x) / usfac
    dyj = np.asarray(s0y, np.float32) - half + np.asarray(pk.y) / usfac
    before = kernels.LAUNCHES["measure_displacement"]
    d = OC.find_displacement(torch.from_numpy(refs), torch.from_numpy(imgs),
                             cc_type="NCC", usfac=usfac, peak_fit_box=pfb,
                             fit_type="gaussian")
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert kernels.LAUNCHES["measure_displacement"] == before
    assert np.abs(d.dx.numpy() - dxj).max() < SHIFT_TOL
    assert np.abs(d.dy.numpy() - dyj).max() < SHIFT_TOL
    assert bool(d.fit_ok.all())


def test_find_displacement_routes_windowed_upsampling_through_b3(monkeypatch):
    """The package's find_displacement sends usfac > 1 under a small search
    box through the B3 wrapper, once per batch; usfac 1 and a full-surface
    search do not. The plain one takes its measurement as an argument."""
    calls = []
    real = kmeasure.measure_window

    def spy(*a, **k):
        calls.append(k["bounds"])
        return real(*a, **k)

    monkeypatch.setattr(kmeasure, "measure_window", spy)
    refs, imgs, _ = _star_pairs(4, 32, 32, seed=2, shift=0.4)
    r, i = torch.from_numpy(refs), torch.from_numpy(imgs)
    m = torch.ones((4, 32, 32), dtype=torch.bool)
    assert subpixal_tpu_torch.find_displacement is kmeasure.find_displacement
    d = kmeasure.find_displacement(r, i, usfac=8, fit_type="gaussian",
                                   ref_mask=m, img_mask=m)
    box = normalize_search_box("fitbox", 32, 32, 5)
    assert calls == [box]
    kmeasure.find_displacement(r, i, usfac=1)
    kmeasure.find_displacement(r, i, usfac=8, peak_search_box=None)
    assert len(calls) == 1
    dp = OC.find_displacement(r, i, usfac=8, fit_type="gaussian",
                              ref_mask=m, img_mask=m)
    assert len(calls) == 1  # the plain default
    OC.find_displacement(r, i, usfac=8, fit_type="gaussian", ref_mask=m,
                         img_mask=m, measure=spy)
    assert calls == [box, box]
    assert torch.equal(d.dx, dp.dx) and torch.equal(d.dy, dp.dy)
