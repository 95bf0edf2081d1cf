"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so
without one every test here skips. The file imports neither ``jax`` nor
``subpixal_tpu`` (the card's machine has no JAX), and runs there with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

B1 and B2 evaluate the same float32 formulas as their plain versions;
B1's atomics sum in an order that changes from run to run, B1 factors its
weights by axis and both kernels fuse multiply-adds, so values agree to
``REL_TOL`` relative to the largest plain value (at least 1), and
validity and escape counts exactly. B3's two kernels sum their own FFTs
or direct DFTs where the plain version runs ``torch.fft``, so the window
agrees to ``C2_TOL`` of its largest value (the JAX package's bar for its
own fused kernel) and the coarse shifts exactly.
"""

import numpy as np
import pytest
import torch

from subpixal_tpu_torch import align_images, find_displacement, kernels
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.align import _compact_blocks
from subpixal_tpu_torch.kernels.drizzle import (_deposit_stack,
                                                drizzle_deposit,
                                                drizzle_deposit_stack)
from subpixal_tpu_torch.kernels.measure import measure_window, uses_fft_kernel
from subpixal_tpu_torch.ops.drizzle import DRIZZLE_KERNELS
from subpixal_tpu_torch.ops.drizzle import drizzle_deposit as plain_deposit
from subpixal_tpu_torch.ops.drizzle import \
    drizzle_deposit_stack as plain_deposit_stack
from subpixal_tpu_torch.ops.correlate import \
    find_displacement as plain_find_displacement
from subpixal_tpu_torch.ops.correlate import measure_window as plain_measure
from subpixal_tpu_torch.ops.interp import INTERP_TAPS, sample_image
from subpixal_tpu_torch.ops.peaks import normalize_search_box
from subpixal_tpu_torch.resample import Exposure
from subpixal_tpu_torch.wcs import TanWCS
from subpixal_tpu_torch.testing import pairwise_shift_errors, simulate_stack

torch.set_num_threads(2)

REL_TOL = 1e-5
C2_TOL = 5e-4


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


def _stack_scene(dev, ratios, H=160, W=256, rot=0.3, seed=0):
    """(E, H, W) data, weights (15 % zero) and pixmaps, one ratio each,
    with a rotation of ``rot`` degrees and fractional offsets."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rot)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    E = len(ratios)
    planes = dict(
        data=rng.uniform(0.5, 3.0, (E, H, W)),
        wht=rng.uniform(0.5, 1.5, (E, H, W)) * (rng.random((E, H, W)) > 0.15),
        x=np.stack([r * (np.cos(th) * xx - np.sin(th) * yy) + 4.37 + 0.3 * e
                    for e, r in enumerate(ratios)]),
        y=np.stack([r * (np.sin(th) * xx + np.cos(th) * yy) + 3.81 - 0.2 * e
                    for e, r in enumerate(ratios)]))
    n = int(max(ratios) * (H + W) * 1.2) + 16
    return ({k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in planes.items()}, (n, n))


def _check_stack(t, oshape, ratios, kernel, pixfrac):
    """Kernel vs plain stack; returns how many strips took the direct
    global-atomics path."""
    n_direct = torch.zeros(1, dtype=torch.int32, device=t["data"].device)
    before = kernels.LAUNCHES["drizzle_deposit"]
    s, w, esc = _deposit_stack(t["data"], t["wht"], t["x"], t["y"], oshape,
                               pixfrac, ratios, kernel, n_direct)
    ps, pw = plain_deposit_stack(t["data"], t["wht"], t["x"], t["y"],
                                 oshape, pixfrac=pixfrac,
                                 pscale_ratio=ratios, kernel=kernel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["drizzle_deposit"] == before + 1
    assert float(pw.sum()) > 0
    assert _close(s, ps) and _close(w, pw)
    assert esc.shape == (len(ratios),) and int(esc.abs().sum()) == 0
    return int(n_direct)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
@pytest.mark.parametrize("pixfrac", [1.0, 0.8])
def test_tiled_deposit_matches_plain(card, kernel, pixfrac):
    """A small rotation at ratio 1: every strip deposits through its
    shared-memory window."""
    t, oshape = _stack_scene(card, (1.0,))
    assert _check_stack(t, oshape, (1.0,), kernel, pixfrac) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,ratio,rot", [("square", 1.0, 30.0),
                                              ("lanczos3", 4.0, 0.3)])
def test_deposit_direct_path_matches_plain(card, kernel, ratio, rot):
    """Windows too large for shared memory (a 30° rotation; lanczos3 at
    ratio 4) take the kernel's direct global-atomics path."""
    t, oshape = _stack_scene(card, (ratio,), H=64, rot=rot, seed=2)
    assert _check_stack(t, oshape, (ratio,), kernel, 1.0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
def test_stacked_deposit_mixed_ratios_matches_plain(card, kernel):
    """One launch for 8 planes at ratios 1.0, 0.5 and 2.0."""
    ratios = (1.0, 0.5, 2.0, 1.0, 0.5, 2.0, 1.0, 1.0)
    t, oshape = _stack_scene(card, ratios, H=48, W=200, seed=3)
    _check_stack(t, oshape, ratios, kernel, 0.9)


@pytest.mark.cuda
def test_deposit_on_compacted_blocks_matches_plain(card):
    """The sparse deposit's (E, L·16, 128) block columns, padded entries
    at weight 0, deposit as the frames they came from."""
    ratios = (1.0,) * 3
    t, oshape = _stack_scene(card, ratios, H=160, W=256, seed=4)
    rng = np.random.default_rng(4)
    nb = (160 // 16) * (256 // 128)
    idx = torch.tensor(np.stack([np.sort(rng.permutation(nb)[:8])
                                 for _ in ratios]), device=card)
    valid = torch.ones(idx.shape, dtype=torch.bool, device=card)
    valid[:, -2:] = False
    c = _compact_blocks(t["data"], t["wht"], t["x"], t["y"], idx, valid)
    tc = {k: v.contiguous() for k, v in zip(("data", "wht", "x", "y"), c)}
    assert tc["data"].shape == (3, 8 * 16, 128)
    assert _check_stack(tc, oshape, ratios, "square", 1.0) == 0


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
    st = {k: v[None].expand(2, -1, -1).contiguous() for k, v in t.items()}
    with pytest.raises(ValueError):  # one ratio for two planes
        drizzle_deposit_stack(st["data"], st["wht"], st["x"], st["y"],
                              oshape, pscale_ratio=(1.0,))
    img, x, y = _cutout_grids(card, shape=(32, 32), n=(2, 8, 8))
    with pytest.raises(ValueError):
        sample_cutouts(img, x.double(), y.double())
    with pytest.raises(ValueError):
        sample_cutouts(img.t(), x, y)
    ref, im, _ = _pairs(card, 4, 16, 0.4, masked=False)
    kw = dict(usfac=4, nwin=8, bounds=(6, 11, 6, 11))
    with pytest.raises(ValueError):
        measure_window(ref.double(), im.double(), **kw)
    with pytest.raises(ValueError):
        measure_window(ref.transpose(1, 2), im, **kw)
    with pytest.raises(ValueError):
        measure_window(ref, im[:2], **kw)


def _pairs(dev, B, n, shift, masked, seed=0, sigma=1.6):
    """Star cutout pairs (img shifted by up to ``shift`` px), with a
    shared bool mask as the align loop passes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    dx = rng.uniform(-shift, shift, B)[:, None, None]
    dy = rng.uniform(-shift, shift, B)[:, None, None]

    def star(ox, oy):
        return np.exp(-((xx - n / 2 - ox) ** 2 + (yy - n / 2 - oy) ** 2)
                      / (2 * sigma ** 2))

    ref = star(0.0, 0.0)[None] + rng.normal(0, 1e-3, (B, n, n))
    img = star(dx, dy) + rng.normal(0, 1e-3, (B, n, n))
    mask = (torch.tensor(rng.random((B, n, n)) > 0.05, device=dev)
            if masked else None)
    return (torch.tensor(ref, dtype=torch.float32, device=dev),
            torch.tensor(img, dtype=torch.float32, device=dev), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,usfac,cc_type,masked,search,fft", [
    (512, 32, 8, "NCC", True, "fitbox", True),     # the new path's shape
    (500, 64, 10, "NCC", False, "fitbox", True),   # bench.py's batch
    (16, 256, 8, "NCC", True, "fitbox", False),    # the bucket's cap
    (37, 48, 8, "CC", True, 7, False),
    (37, 32, 10, "ZNCC", False, 9, True),
    (45, 32, 8, "CC", True, "fitbox", True),
    (33, 64, 8, "NCC", True, 9, True),
    (40, 64, 10, "CC", False, "fitbox", True),
    (20, 16, 8, "NCC", True, 7, True),
])
def test_measure_kernel_matches_plain(card, B, n, usfac, cc_type, masked,
                                      search, fft):
    ref, img, m = _pairs(card, B, n, 0.45 if search == "fitbox" else 2.5,
                         masked, seed=n)
    bounds = normalize_search_box(search, n, n, 5)
    nwin = -(-(usfac + 5 + 1) // 8) * 8
    assert uses_fft_kernel(n, n, nwin, bounds[1] - bounds[0]) == fft
    kw = dict(cc_type=cc_type, usfac=usfac, nwin=nwin, bounds=bounds)
    before = kernels.LAUNCHES["measure_displacement"]
    c2, sy, sx = measure_window(ref, img, m, m, **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["measure_displacement"] == before + 1
    assert c2.shape == (B, nwin, nwin) and sy.dtype == torch.int32
    assert torch.equal(sy, psy) and torch.equal(sx, psx)
    scale = float(pc2.abs().max())
    assert float((c2 - pc2).abs().max()) <= C2_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,masks", [(32, "bool"), (64, "float"),
                                     (24, "bool")])
def test_measure_kernel_ties_nan_and_mask_types(card, n, masks):
    """All-zero pairs (every lag ties: the first wins) and a pair with a
    NaN (every lag NaN: the first wins) give the plain version's shifts;
    float masks and a mask on one side only take the same kernels."""
    ref, img, m = _pairs(card, 12, n, 2.0, True, seed=n + 1)
    ref[3] = 0.0
    img[3] = 0.0
    img[7, 5, 6] = float("nan")
    if masks == "float":
        m = m.float()
    bounds = normalize_search_box(7, n, n, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    for rm, im in ((m, m), (m, None)):
        c2, sy, sx = measure_window(ref, img, rm, im, **kw)
        pc2, psy, psx = plain_measure(ref, img, rm, im, **kw)
        torch.cuda.synchronize()
        assert torch.equal(sy, psy) and torch.equal(sx, psx)
        assert torch.equal(torch.isnan(c2), torch.isnan(pc2))
        ok = ~torch.isnan(pc2)
        scale = float(pc2[ok].abs().max())
        assert float((c2[ok] - pc2[ok]).abs().max()) <= C2_TOL * scale


@pytest.mark.cuda
def test_measure_kernel_one_block_at_24_by_40(card):
    """A shape that is not a square power of two takes the one-block
    kernel."""
    rng = np.random.default_rng(8)
    ref = torch.tensor(rng.normal(size=(9, 24, 40)), dtype=torch.float32,
                       device=card)
    img = torch.roll(ref, (1, -2), (1, 2)) + 0.01
    m = torch.tensor(rng.random((9, 24, 40)) > 0.05, device=card)
    bounds = normalize_search_box("fitbox", 24, 40, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    assert not uses_fft_kernel(24, 40, 16, bounds[1] - bounds[0])
    c2, sy, sx = measure_window(ref, img, m, m, **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sy, psy) and torch.equal(sx, psx)
    assert float((c2 - pc2).abs().max()) <= C2_TOL * float(pc2.abs().max())


@pytest.mark.cuda
def test_find_displacement_launches_measure_kernel(card):
    """The package's find_displacement runs the windowed usfac > 1
    measurement through B3 (one launch); the plain one, with its default
    measurement, launches nothing and gives the same shifts."""
    ref, img, m = _pairs(card, 64, 32, 0.45, True, seed=4)
    kw = dict(usfac=8, fit_type="gaussian", ref_mask=m, img_mask=m)
    before = kernels.LAUNCHES["measure_displacement"]
    d = find_displacement(ref, img, **kw)
    assert kernels.LAUNCHES["measure_displacement"] == before + 1
    dp = plain_find_displacement(ref, img, **kw)
    assert kernels.LAUNCHES["measure_displacement"] == before + 1
    assert float((d.dx - dp.dx).abs().max()) < 1e-3
    assert float((d.dy - dp.dy).abs().max()) < 1e-3


@pytest.mark.cuda
def test_align_goes_through_kernels(card):
    """On the card the loop launches both kernels, recovers the planted
    shifts, and its first iteration equals the CPU run's."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kernels.reset_launch_counts()
    res = align_images(exposures=exps, device="cuda", max_iterations=6)
    # B1: one launch per exposure for the initial drizzle, then the whole
    # stack in one launch per iteration
    assert kernels.LAUNCHES["drizzle_deposit"] == len(exps) + res.n_iterations
    assert kernels.LAUNCHES["blot_gather"] > 0
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(exposures=exps, device="cpu", max_iterations=1)
    for a, b in zip(res.history[0], cpu.history[0]):
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


@pytest.mark.cuda
def test_new_path_goes_through_all_kernels(card):
    """The JAX package's align configuration on the card: device pixmaps,
    the sparse deposit, and all three kernels; its first iteration equals
    the CPU run's (host pixmaps, dense deposit, plain versions)."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kw = dict(exposures=exps, fitgeom="shift", usfac=8, fit_type="gaussian")
    kernels.reset_launch_counts()
    res = align_images(device="cuda", max_iterations=6, **kw)
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert kernels.LAUNCHES["drizzle_deposit"] == 3 + res.n_iterations
    assert "cutout_pixmaps" in res.setup_breakdown
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(device="cpu", max_iterations=1, **kw)
    for a, b in zip(res.history[0], cpu.history[0]):
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


def _wide_scene(E=2, shape=(512, 1024), ns=8, seed=13):
    """A wide frame with sources in its left part only, so the sparse
    deposit's live set leaves most input blocks out."""
    rng = np.random.default_rng(seed)
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(60, 380, ns),
                      rng.uniform(60, shape[0] - 60, ns)], 1)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    exps = []
    for e in range(E):
        dx = rng.uniform(-0.3, 0.3)
        img = rng.normal(0, 0.01, shape).astype(np.float32)
        for sx, sy in stars:
            r2 = (xx - sx - dx) ** 2 + (yy - sy) ** 2
            img += np.where(r2 < 64.0, 20.0 * np.exp(-r2 / (2 * 1.6 ** 2)),
                            0.0).astype(np.float32)
        exps.append(Exposure(img, TanWCS(
            crpix=np.array([shape[1] / 2, shape[0] / 2]),
            crval=np.array([150.0, 2.0]), cd=cd), name=f"s{e}"))
    return exps


@pytest.mark.cuda
def test_sparse_deposit_on_card(card):
    """The compacted (L*16, 128) block pseudo-images go through B1 on the
    card; every iteration equals the CPU run of the same configuration."""
    kw = dict(exposures=_wide_scene(), fitgeom="shift", usfac=8,
              fit_type="gaussian", cutout_shape=(64, 64), min_sources=3,
              max_iterations=4, sparse_deposit=True,
              cutout_pixmaps="device")
    kernels.reset_launch_counts()
    res = align_images(device="cuda", **kw)
    assert res.setup_breakdown["sparse_live_frac"] < 0.85
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    cpu = align_images(device="cpu", **kw)
    assert res.n_iterations == cpu.n_iterations
    for ra, rb in zip(res.history, cpu.history):
        for a, b in zip(ra, rb):
            assert a.nmatches == b.nmatches
            assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3
