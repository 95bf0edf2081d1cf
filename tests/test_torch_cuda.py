"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so
without one every test here skips. The file imports neither ``jax`` nor
``subpixal_tpu`` (the card's machine has no JAX), and runs there with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

B1 and B2 evaluate the same float32 formulas as their plain versions;
B1's atomics sum in an order that changes from run to run, B1 factors its
weights by axis, B2 takes its Lagrange weights in product form and both
kernels fuse multiply-adds, so values agree to ``REL_TOL`` relative to
the largest plain value (at least 1), and validity and escape counts
exactly. B3's two kernels sum their own FFTs where the plain version runs
``torch.fft``, so the window agrees to ``C2_TOL`` of its largest value
(the JAX package's bar for its own fused kernel) and the coarse shifts
exactly.
"""

import re

import numpy as np
import pytest
import torch

from subpixal_tpu_torch import align as align_mod
from subpixal_tpu_torch import align_images, find_displacement, kernels
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.align import _compact_blocks
from subpixal_tpu_torch.kernels.drizzle import (_deposit_stack,
                                                drizzle_deposit,
                                                drizzle_deposit_stack)
from subpixal_tpu_torch.kernels.measure import kernel_route, measure_window
from subpixal_tpu_torch.ops.drizzle import DRIZZLE_KERNELS
from subpixal_tpu_torch.ops.drizzle import drizzle_deposit as plain_deposit
from subpixal_tpu_torch.ops.drizzle import \
    drizzle_deposit_stack as plain_deposit_stack
from subpixal_tpu_torch.ops.correlate import \
    find_displacement as plain_find_displacement
from subpixal_tpu_torch.ops.correlate import measure_window as plain_measure
from subpixal_tpu_torch.ops.correlate import window_fits
from subpixal_tpu_torch.ops.interp import (INTERP_OFFSETS, INTERP_TAPS,
                                           sample_image)
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


def _sinc_tap_sum(t, sinscl):
    """The sinc's raw tap sum per axis at fractions ``t`` (what the
    bilinear guard tests), in float64."""
    t = t.double()
    total = torch.zeros_like(t)
    for o in INTERP_OFFSETS["sinc"]:
        x = t - o
        total += torch.where(x.abs() >= 3.0, 0.0,
                             torch.sinc(x / sinscl) * torch.sinc(x / 3.0))
    return total


@pytest.mark.cuda
@pytest.mark.parametrize("sinscl", [0.5, 1.5, 2.0])
@pytest.mark.parametrize("grids", ["512 x 32²", "whole plane"])
def test_gather_sinc_sinscl_matches_plain(card, grids, sinscl):
    """B2's sinc at another scale (a run-time argument of the kernel):
    512 rotated cutout grids of 32² over a star field, and
    test_gather_kernel_matches_plain's grids; a quarter of the queries
    sit on or near fraction 0.5, where at sinscl 0.5 the taps sum to ~0
    and both take bilinear weights."""
    if grids == "whole plane":
        img, x, y = _cutout_grids(card)
    else:
        img, x, y = _star_grids(card, 512, 32, 0.2, seed=5)
    g = torch.Generator(device="cpu").manual_seed(int(10 * sinscl))
    near = 0.5 + 0.02 * (torch.rand(x[:, ::4].shape, generator=g) - 0.5)
    x[:, ::4] = torch.floor(x[:, ::4]) + near.to(card)
    before = kernels.LAUNCHES["blot_gather"]
    v, ok, _ = sample_cutouts(img, x, y, interp="sinc", fill=-2.5,
                              sinscl=sinscl)
    pv, pok = sample_image(img, x, y, interp="sinc", fill=-2.5,
                           sinscl=sinscl)
    one, _, _ = sample_cutouts(img, x, y, interp="sinc", fill=-2.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blot_gather"] == before + 2
    assert torch.equal(ok, pok) and 0 < float(ok.float().mean()) < 1
    assert _close(v, pv)
    assert not _close(v, one)  # the scale is honoured
    guard = (_sinc_tap_sum(x - torch.floor(x), sinscl).abs() < 1e-3) & ok
    assert bool(guard.any()) == (sinscl < 1)


@pytest.mark.cuda
@pytest.mark.parametrize("interp", sorted(INTERP_TAPS))
def test_gather_band_row0_equals_whole_plane(card, interp):
    """B2 on a band of a plane at the plane's coordinates, the band's
    first row given as ``row0`` (as sample_spatial launches it on a halo-
    extended band): the whole plane's B2 values bit for bit where the
    footprint lies in the band, and validity exactly there, at rows near
    1024, where a float shift of y would round its fraction."""
    rng = np.random.default_rng(4)
    plane = torch.tensor(rng.uniform(0.0, 4.0, (1100, 40)),
                         dtype=torch.float32, device=card)
    r0, r1 = 1000, 1060
    band = plane[r0:r1].contiguous()
    x = torch.tensor(rng.uniform(-3, 43, (8, 6, 7)), dtype=torch.float32,
                     device=card)
    y = torch.tensor(rng.uniform(r0 - 4, r1 + 4, (8, 6, 7)),
                     dtype=torch.float32, device=card)
    kw = dict(interp=interp, fill=-3.0, prefiltered=True, sinscl=0.5)
    want, wok, _ = sample_cutouts(plane, x, y, **kw)
    got, ok, _ = sample_cutouts(band, x, y, row0=r0, **kw)
    torch.cuda.synchronize()
    offs = INTERP_OFFSETS[interp]
    fy = torch.floor(y + 0.5 if interp == "nearest" else y).long()
    inside = (fy + offs[0] >= r0) & (fy + offs[-1] < r1)
    assert torch.equal(ok, wok & inside) and bool(ok.any())
    assert torch.equal(got[ok], want[ok])
    assert bool((got[~ok] == -3.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sinscl", [0.5, 1.5, 2.0])
def test_blot_image_and_cutout_sinc_sinscl_on_card(card, sinscl):
    """blot_image and blot_cutout with interp='sinc' at another scale go
    through B2 on the card (one launch each) and match the plain version
    (blot_image) and the CPU run (blot_cutout) within REL_TOL."""
    from subpixal_tpu_torch.blot import blot_cutout, blot_image
    from subpixal_tpu_torch.cutout import Cutout

    img, _, _ = _cutout_grids(card)
    rng = np.random.default_rng(int(10 * sinscl))
    th = np.deg2rad(0.4)
    yy, xx = np.mgrid[0:200, 0:240].astype(np.float64)
    px = np.cos(th) * xx - np.sin(th) * yy + rng.uniform(50, 70)
    py = np.sin(th) * xx + np.cos(th) * yy + rng.uniform(50, 70)
    px[::3] = np.floor(px[::3]) + 0.5  # on the sinc-0.5 guard
    px = torch.tensor(px, dtype=torch.float32, device=card)
    py = torch.tensor(py, dtype=torch.float32, device=card)
    before = kernels.LAUNCHES["blot_gather"]
    v, ok = blot_image(img, px, py, interp="sinc", expout=2.5, fill=-1.0,
                       sinscl=sinscl)
    pv, pok = sample_image(img, px, py, interp="sinc", fill=-1.0,
                           sinscl=sinscl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blot_gather"] == before + 1
    assert v.shape == px.shape and torch.equal(ok, pok)
    assert 0 < float(ok.float().mean()) < 1
    assert _close(v[ok], 2.5 * pv[ok])
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    w = TanWCS(crpix=np.array([150.0, 128.0]), crval=np.array([150.0, 2.0]),
               cd=cd)
    src = Cutout(img.cpu().numpy(), w, exptime=100.0)
    dst = Cutout(np.zeros((40, 36), np.float32),
                 w.with_shifted_crpix(10.3, 7.6), blc=(7, 10),
                 exptime=300.0)
    before = kernels.LAUNCHES["blot_gather"]
    got = blot_cutout(src, dst, interp="sinc", sinscl=sinscl, device=card)
    assert kernels.LAUNCHES["blot_gather"] == before + 1
    want = blot_cutout(src, dst, interp="sinc", sinscl=sinscl, device="cpu")
    np.testing.assert_array_equal(got.mask, want.mask)
    assert _close(torch.tensor(got.data), torch.tensor(want.data))


def _star_grids(dev, B, n, rot, seed, shape=(1024, 1024)):
    """An image of stars and B (n, n) cutout grids rotated by ``rot``
    degrees, at fractional centers spread over the frame (edge cutouts go
    partly invalid)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    img = rng.normal(0.0, 0.01, shape)
    for cx, cy in rng.uniform(0, W, (80, 2)):
        img += 25.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.48)
    th = np.deg2rad(rot)
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float64) - n / 2
    cen = rng.uniform(-8, W + 8, (B, 2)) + rng.uniform(-0.5, 0.5, (B, 2))
    x = (np.cos(th) * gx - np.sin(th) * gy)[None] + cen[:, 0, None, None]
    y = (np.sin(th) * gx + np.cos(th) * gy)[None] + cen[:, 1, None, None]
    return (torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (img, x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("interp", sorted(INTERP_TAPS))
@pytest.mark.parametrize("B,n,rot", [
    (64, 32, 0.2),    # the align path's 32² cutouts
    (64, 48, 0.2),    # the 48² path's
    (16, 128, 30.0),  # a 30° rotation
    (16, 256, 0.2),   # the oversized bucket
    (4, 256, 30.0),   # a skewed bucket grid
])
def test_gather_cutout_grids_match_plain(card, interp, B, n, rot):
    """Rotated cutout grids over a star field, some reaching past the
    frame's edges, at the align loop's shapes."""
    img, x, y = _star_grids(card, B, n, rot, seed=n)
    before = kernels.LAUNCHES["blot_gather"]
    v, ok, esc = sample_cutouts(img, x, y, interp=interp, fill=-2.5)
    pv, pok = sample_image(img, x, y, interp=interp, fill=-2.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blot_gather"] == before + 1
    assert torch.equal(ok, pok) and 0 < float(ok.float().mean()) < 1
    assert _close(v, pv)
    assert int(esc.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["linear", "poly5"])
def test_gather_wide_rows_match_plain(card, interp):
    """Grids of long rows, as blot_image passes a whole frame as one
    cutout."""
    img, _, _ = _star_grids(card, 1, 8, 0.0, seed=3)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-4, 1028, (2, 3, 2500)), dtype=torch.float32,
                     device=card)
    y = torch.tensor(rng.uniform(100, 140, (2, 3, 2500)), dtype=torch.float32,
                     device=card)
    v, ok, _ = sample_cutouts(img, x, y, interp=interp, fill=-2.5)
    pv, pok = sample_image(img, x, y, interp=interp, fill=-2.5)
    torch.cuda.synchronize()
    assert torch.equal(ok, pok) and 0 < float(ok.float().mean()) < 1
    assert _close(v, pv)


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
    """Star cutout pairs of n x n (or an (H, W) pair: n), img shifted by
    up to ``shift`` px, with a shared bool mask as the align loop
    passes."""
    H, W = (n, n) if np.ndim(n) == 0 else n
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx = rng.uniform(-shift, shift, B)[:, None, None]
    dy = rng.uniform(-shift, shift, B)[:, None, None]

    def star(ox, oy):
        return np.exp(-((xx - W / 2 - ox) ** 2 + (yy - H / 2 - oy) ** 2)
                      / (2 * sigma ** 2))

    ref = star(0.0, 0.0)[None] + rng.normal(0, 1e-3, (B, H, W))
    img = star(dx, dy) + rng.normal(0, 1e-3, (B, H, W))
    mask = (torch.tensor(rng.random((B, H, W)) > 0.05, device=dev)
            if masked else None)
    return (torch.tensor(ref, dtype=torch.float32, device=dev),
            torch.tensor(img, dtype=torch.float32, device=dev), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,usfac,cc_type,masked,search,fft", [
    (512, 32, 8, "NCC", True, "fitbox", "fft"),     # the new path's shape
    (500, 64, 10, "NCC", False, "fitbox", "fft"),   # bench.py's batch
    (16, 256, 8, "NCC", True, "fitbox", "mixed_radix"),  # the bucket's cap
    (37, 48, 8, "CC", True, 7, "mixed_radix"),
    (37, 32, 10, "ZNCC", False, 9, "fft"),
    (45, 32, 8, "CC", True, "fitbox", "fft"),
    (33, 64, 8, "NCC", True, 9, "fft"),
    (40, 64, 10, "CC", False, "fitbox", "fft"),
    (20, 16, 8, "NCC", True, 7, "fft"),
])
def test_measure_kernel_matches_plain(card, B, n, usfac, cc_type, masked,
                                      search, fft):
    ref, img, m = _pairs(card, B, n, 0.45 if search == "fitbox" else 2.5,
                         masked, seed=n)
    bounds = normalize_search_box(search, n, n, 5)
    nwin = -(-(usfac + 5 + 1) // 8) * 8
    assert kernel_route(B, n, n, nwin, bounds).kernel == fft
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
@pytest.mark.parametrize("n,masks", [
    (32, "bool"), (64, "float"), (24, "bool"),
    (48, "none"), (48, "bool"), (48, "float"),
    (256, "none"), (256, "bool"), (256, "float")])
def test_measure_kernel_ties_nan_and_mask_types(card, n, masks):
    """All-zero pairs (every lag ties: the first wins) and a pair with a
    NaN (every lag NaN: the first wins) give the plain version's shifts;
    no masks, float masks and a mask on one side only take the same
    kernels."""
    ref, img, m = _pairs(card, 12, n, 2.0, True, seed=n + 1)
    ref[3] = 0.0
    img[3] = 0.0
    img[7, 5, 6] = float("nan")
    if masks == "float":
        m = m.float()
    bounds = normalize_search_box(7, n, n, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    sides = ((None, None),) if masks == "none" else ((m, m), (m, None))
    for rm, im in sides:
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
    """A shape that is not a square power of two takes the mixed-radix
    kernel (24 = 8 x 3, 40 = 8 x 5)."""
    rng = np.random.default_rng(8)
    ref = torch.tensor(rng.normal(size=(9, 24, 40)), dtype=torch.float32,
                       device=card)
    img = torch.roll(ref, (1, -2), (1, 2)) + 0.01
    m = torch.tensor(rng.random((9, 24, 40)) > 0.05, device=card)
    bounds = normalize_search_box("fitbox", 24, 40, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    assert kernel_route(9, 24, 40, 16, bounds).kernel == "mixed_radix"
    c2, sy, sx = measure_window(ref, img, m, m, **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sy, psy) and torch.equal(sx, psx)
    assert float((c2 - pc2).abs().max()) <= C2_TOL * float(pc2.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,workspace", [
    (5, 45, 51, False),    # odd lengths: the length-m DFT pass alone
    (2, 384, 384, True),   # too large for a cluster's shared memory
])
def test_measure_kernel_odd_and_oversized_shapes(card, B, H, W, workspace):
    """Shapes outside the align loop's auto-sizing, from a user-given
    cutout_shape: odd lengths, and buffers kept in a global workspace."""
    rng = np.random.default_rng(H)
    ref = torch.tensor(rng.normal(size=(B, H, W)), dtype=torch.float32,
                       device=card)
    img = torch.roll(ref, (1, -2), (1, 2)) + 0.01
    m = torch.tensor(rng.random((B, H, W)) > 0.05, device=card)
    bounds = normalize_search_box("fitbox", H, W, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    route = kernel_route(B, H, W, 16, bounds)
    assert route.kernel == "mixed_radix" and route.workspace == workspace
    c2, sy, sx = measure_window(ref, img, m, m, **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sy, psy) and torch.equal(sx, psx)
    assert float((c2 - pc2).abs().max()) <= C2_TOL * float(pc2.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(16, 257, 16))
def test_measure_kernel_every_multiple_of_16(card, n):
    """Every cutout size the align loop's auto-sizing can pick (multiples
    of 16 up to the bucket's 256): 16, 32, 64 take the FFT kernel, the
    rest the mixed-radix kernel, and all match the plain version."""
    B = 6
    ref, img, m = _pairs(card, B, n, 0.45, True, seed=n + 2)
    bounds = normalize_search_box("fitbox", n, n, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    route = kernel_route(B, n, n, 16, bounds)
    assert route.kernel == ("fft" if n in (16, 32, 64) else "mixed_radix")
    c2, sy, sx = measure_window(ref, img, m, m, **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sy, psy) and torch.equal(sx, psx)
    assert float((c2 - pc2).abs().max()) <= C2_TOL * float(pc2.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,masked", [(16, True), (32, True), (32, False),
                                      (64, True), (64, False)])
def test_measure_mixed_kernel_asked_for_at_fft_shapes(card, n, masked):
    """The mixed-radix kernel takes the FFT kernel's shapes too when asked
    for (as chip_smoke.py times them side by side) and matches the plain
    version; the FFT kernel asked for where it does not fit raises."""
    ref, img, m = _pairs(card, 40, n, 0.45, masked, seed=n + 3)
    bounds = normalize_search_box("fitbox", n, n, 5)
    kw = dict(cc_type="NCC", usfac=8, nwin=16, bounds=bounds)
    assert kernel_route(40, n, n, 16, bounds).kernel == "fft"
    assert kernel_route(40, n, n, 16, bounds,
                        kernel="mixed_radix").kernel == "mixed_radix"
    before = kernels.LAUNCHES["measure_displacement"]
    c2, sy, sx = measure_window(ref, img, m, m, kernel="mixed_radix", **kw)
    fc2, fsy, fsx = measure_window(ref, img, m, m, kernel="fft", **kw)
    pc2, psy, psx = plain_measure(ref, img, m, m, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["measure_displacement"] == before + 2
    scale = float(pc2.abs().max())
    for a, y, x in ((c2, sy, sx), (fc2, fsy, fsx)):
        assert torch.equal(y, psy) and torch.equal(x, psx)
        assert float((a - pc2).abs().max()) <= C2_TOL * scale
    r48, i48, m48 = _pairs(card, 3, 48, 0.45, True)
    with pytest.raises(ValueError, match="fft kernel"):
        measure_window(r48, i48, m48, m48, kernel="fft", cc_type="NCC",
                       usfac=8, nwin=16,
                       bounds=normalize_search_box("fitbox", 48, 48, 5))


#: cutout sides of the B3 sweep, up to 512: the FFT kernel's, multiples
#: of 16, large prime factors (7·16, 2·127, 127, 509) and odd sides
SWEEP_SIDES = (16, 24, 32, 45, 48, 64, 96, 112, 127, 128, 200, 254, 256,
               384, 509, 512)
#: upsampling factors of the sweep (nwin 16, 16, 32, 56, 112)
SWEEP_USFAC = (8, 10, 20, 50, 100)


def _nwin(usfac, peak_fit_box=5):
    return -(-(usfac + peak_fit_box + 1) // 8) * 8


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 512])
def test_measure_plan_refuses_what_window_fits_refuses(card, B):
    """B3's host plan (measure_window_plan) against the shape rule that
    find_displacement routes by, on every pair of SWEEP_SIDES at every
    SWEEP_USFAC under 'fitbox' (5 x 5) and a 17 x 17 box: the plan takes
    a shape exactly where window_fits does."""
    from subpixal_tpu_torch.kernels.measure import _PLAN, _lib

    plan_fn = _lib().measure_window_plan
    refused = []
    for H in SWEEP_SIDES:
        for W in SWEEP_SIDES:
            for usfac in SWEEP_USFAC:
                for box in (5, 17):
                    nwin = _nwin(usfac)
                    plan = _PLAN()
                    nws = plan_fn(B, H, W, nwin, box, box, -1, plan)
                    assert (nws >= 0) == window_fits(H, W, nwin, box, box), \
                        (B, H, W, nwin, box)
                    if nws < 0:
                        refused.append((H, W, nwin))
    # none at the align paths' usfac 8 and 10 (nwin 16)
    assert refused and min(nwin for _, _, nwin in refused) >= 56


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,usfac,masked", [
    (6, 112, 112, 8, True),      # 7·16
    (4, 254, 254, 10, False),    # 2·127
    (3, 112, 254, 10, True),     # non-square
    (3, 509, 384, 8, True),      # a prime side
    (2, 512, 512, 10, False),
    (2, 512, 512, 42, True),     # the largest usfac 512² takes (nwin 48)
    (2, 512, 512, 50, True),     # refused: nwin 56
    (2, 256, 256, 100, False),   # refused: nwin 112
    (3, 254, 112, 100, True),    # refused, non-square
])
def test_find_displacement_every_shape_on_card(card, B, H, W, usfac,
                                               masked):
    """The package's find_displacement returns a result at every shape:
    through B3 (one launch) where window_fits takes the shape, through the
    full-surface chain (no launch) where it does not; both within 1e-3 px
    of the plain find_displacement on the card."""
    ref, img, m = _pairs(card, B, (H, W), 0.45, masked, seed=H + W,
                         sigma=2.0)
    kw = dict(usfac=usfac, fit_type="gaussian", ref_mask=m, img_mask=m)
    fits = window_fits(H, W, _nwin(usfac), 5, 5)
    route = kernel_route(B, H, W, _nwin(usfac),
                         normalize_search_box("fitbox", H, W, 5))
    assert (route is not None) == fits
    before = kernels.LAUNCHES["measure_displacement"]
    d = find_displacement(ref, img, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["measure_displacement"] == before + int(fits)
    dp = plain_find_displacement(ref, img, **kw)
    assert bool(torch.isfinite(d.dx).all() and torch.isfinite(d.dy).all())
    assert bool(d.fit_ok.all())
    assert float((d.dx - dp.dx).abs().max()) < 1e-3
    assert float((d.dy - dp.dy).abs().max()) < 1e-3


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
    # B1: one launch for the initial drizzle (the stacked execute keeps
    # each exposure's planes), then the whole stack once per step of the
    # loop: its iterations, and the replays after convergence up to the
    # loop's next read of the host, which change nothing
    steps = res.setup_breakdown["loop_steps"]
    assert res.n_iterations <= steps <= res.n_iterations + 3
    assert kernels.LAUNCHES["drizzle_deposit"] == 1 + steps
    assert kernels.LAUNCHES["blot_gather"] > 0
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    # the CPU run takes the device finder too ('auto' takes it on CUDA)
    cpu = align_images(exposures=exps, device="cpu", max_iterations=1,
                       device_catalog="device")
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
    # once per step of the loop, as test_align_goes_through_kernels
    steps = res.setup_breakdown["loop_steps"]
    assert res.n_iterations <= steps <= res.n_iterations + 3
    assert kernels.LAUNCHES["drizzle_deposit"] == 1 + steps
    assert "cutout_pixmaps" in res.setup_breakdown
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(device="cpu", max_iterations=1,
                       device_catalog="device", **kw)
    for a, b in zip(res.history[0], cpu.history[0]):
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda", 0)],
                         ids=["cuda", "cuda:0", "device(cuda, 0)"])
def test_align_copies_the_frames_once_however_the_card_is_named(
        card, monkeypatch, device):
    """However the card is named, align stages the rate stack that
    Drizzle.execute just copied (``stack_inputs.reused`` 1): one stack of
    the rate planes a call (no exposure carries a weight plane, so the
    weights take none), and the first iteration equals the CPU run's."""
    from subpixal_tpu_torch import resample as R

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    stacks = []

    def counted(real):
        def wrapper(planes, shape, dev):
            if all(np.ndim(p) == 2 for p in planes):
                stacks.append(shape)
            return real(planes, shape, dev)
        return wrapper

    monkeypatch.setattr(R, "_stack_planes", counted(R._stack_planes))
    monkeypatch.setattr(align_mod, "_stack_planes",
                        counted(align_mod._stack_planes))
    res = align_images(exposures=exps, device=device, max_iterations=6)
    assert res.setup_breakdown["stack_inputs.reused"] == 1
    assert stacks == [(256, 256)]
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(exposures=exps, device="cpu", max_iterations=1,
                       device_catalog="device")
    for a, b in zip(res.history[0], cpu.history[0]):
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


_GRAPH_PATHS = {"defaults": dict(),
                "new": dict(fitgeom="shift", usfac=8, fit_type="gaussian"),
                "otf": dict(fitgeom="shift", usfac=8, fit_type="gaussian",
                            wcsupdate="otf")}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(_GRAPH_PATHS))
def test_graph_loop_matches_host_loop_on_card(card, path):
    """The device loop on one card captures the step once and replays it:
    n_iterations − 1 replays, B1 1 + per-iteration × n_iterations (the
    capture's own wrapper calls left out, each replay's added), at most
    ⌈n/4⌉ + 1 host reads, ``loop_compile`` in the breakdown. A second
    call of the same shapes replays the cached graph n_iterations times
    under the same rule. Every iteration of both within 1e-4 px of the
    host loop at equal n_iterations."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    # eps_shift 0 never passes: every call runs its 6 iterations
    kw = dict(exposures=exps, device="cuda", max_iterations=6,
              eps_shift=0.0, **_GRAPH_PATHS[path])
    per_iter = 3 if path == "otf" else 1
    align_mod._LOOP_CACHE.clear()
    runs = []
    for call in ("capture", "cached"):
        kernels.reset_launch_counts()
        res = align_images(**kw)
        launches = dict(kernels.LAUNCHES)
        bd = res.setup_breakdown
        n = res.n_iterations
        assert n == 6 and not res.converged
        if call == "capture":  # the first iteration eager, then replays
            assert bd["loop_graphs"] == 1 and bd["loop_graph_hits"] == 0
            assert bd["loop_replays"] == n - 1
            assert bd["loop_compile"] > 0
        else:  # the cached graph replayed for every iteration
            assert bd["loop_graphs"] == 0 and bd["loop_graph_hits"] == 1
            assert bd["loop_replays"] == n
        assert bd["loop_steps"] == n
        assert bd["loop_host_reads"] <= -(-n // 4) + 1
        assert launches["drizzle_deposit"] == 1 + per_iter * n
        assert launches["blot_gather"] == per_iter * n
        assert launches["measure_displacement"] == (
            0 if path == "defaults" else per_iter * n)
        assert pairwise_shift_errors(res.shifts, planted) < 0.005
        runs.append(res)
    host = align_images(device_loop=False, **kw)
    assert host.n_iterations == n and "loop_graphs" not in \
        host.setup_breakdown
    for res in runs:
        for ra, rb in zip(res.history, host.history):
            for a, b in zip(ra, rb):
                assert a.nmatches == b.nmatches
                assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-4


@pytest.mark.cuda
def test_graph_loop_on_sparse_deposit_and_use_pallas_false(card):
    """The compacted deposit and the plain versions (``use_pallas=False``,
    no launch) are captured too; both follow the host loop within 1e-4
    px."""
    for kw in (dict(exposures=_wide_scene(), fitgeom="shift", usfac=8,
                    fit_type="gaussian", cutout_shape=(64, 64),
                    min_sources=3, sparse_deposit=True),
               dict(exposures=simulate_stack(n_exp=3, shape=(256, 256),
                                             n_stars=12, seed=5)[0],
                    use_pallas=False, **_MESH_KW)):
        kw = dict(kw, device="cuda", max_iterations=4, eps_shift=0.0)
        align_mod._LOOP_CACHE.clear()
        kernels.reset_launch_counts()
        res = align_images(**kw)
        launches = dict(kernels.LAUNCHES)
        assert res.setup_breakdown["loop_replays"] == 3
        if kw.get("use_pallas") is False:
            assert not any(launches.values()), launches
        else:
            assert res.setup_breakdown["sparse_live_frac"] < 0.85
            assert launches["drizzle_deposit"] == 1 + 4
        host = align_images(device_loop=False, **kw)
        for ra, rb in zip(res.history, host.history):
            for a, b in zip(ra, rb):
                assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-4


@pytest.mark.cuda
def test_step_reads_nothing_from_the_host_on_card(card, monkeypatch):
    """Every op of the align step is capturable: one eager step under
    ``torch.cuda.set_sync_debug_mode('error')`` (which raises on any
    synchronising call) on the new path, as the loop's warm-up runs it."""
    real = align_mod._step
    calls = []

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    monkeypatch.setattr(align_mod, "_step", strict)
    align_mod._LOOP_CACHE.clear()  # a cached graph would not call _step
    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    res = align_images(exposures=exps, device="cuda", **_MESH_KW)
    assert calls and res.setup_breakdown["loop_graphs"] == 1


@pytest.mark.cuda
def test_failed_capture_raises_and_runs_nothing_eagerly(card):
    """A step that reads the host runs eagerly once (the warm-up), then
    its capture raises: nothing retries it eagerly or on the CPU, nothing
    is cached, the launch counts keep none of the capture's wrapper
    calls, and the default generator draws again after."""
    from subpixal_tpu_torch.align import _fixed_point

    calls = []

    def step(b, Ms, ts):
        calls.append(torch.cuda.is_current_stream_capturing())
        bad = float(ts.sum().item())  # a host read
        kernels.LAUNCHES["drizzle_deposit"] += 1  # as a wrapper would
        return Ms, ts + bad, dict(max_shift=ts.sum() + 1.0)

    align_mod._LOOP_CACHE.clear()
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError):
        _fixed_point(step, None, torch.eye(2, device=card)[None],
                     torch.zeros(1, 2, device=card), {}, 6, 1e-3, {},
                     ("failing step",))
    torch.cuda.synchronize()
    assert calls == [False, True]
    assert kernels.LAUNCHES["drizzle_deposit"] == 1
    assert not align_mod._LOOP_CACHE
    torch.rand(2, device=card)  # the default generator draws again


@pytest.mark.cuda
def test_loop_converged_in_its_eager_step_captures_nothing(card):
    """A loop whose first (eager) iteration converges reads the host once
    and returns: no capture, no replay, nothing cached."""
    from subpixal_tpu_torch.align import _fixed_point

    calls = []

    def step(b, Ms, ts):
        calls.append(1)
        return Ms, ts + 1.0, dict(max_shift=ts.sum())

    align_mod._LOOP_CACHE.clear()
    bd = {}
    *_, n, done, _, _ = _fixed_point(
        step, None, torch.eye(2, device=card)[None],
        torch.zeros(1, 2, device=card), {}, 6, 1e-3, bd, ("step",))
    assert (n, done, len(calls)) == (1, True, 1)
    assert bd == dict(loop_steps=1, loop_host_reads=1, loop_compile=0.0,
                      loop_graphs=0, loop_graph_hits=0, loop_replays=0)
    assert not align_mod._LOOP_CACHE


@pytest.mark.cuda
def test_replayed_launches_match_the_profiler_on_card(card):
    """The launch counts a cached graph's replays add equal the kernels
    the card ran: over one warm call (every iteration a replay),
    ``torch.profiler`` counts as many B1, B2 and B3 kernels as
    ``kernels.LAUNCHES``."""
    from torch.profiler import ProfilerActivity, profile

    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    kw = dict(exposures=exps, device="cuda", max_iterations=6,
              eps_shift=0.0, **_GRAPH_PATHS["new"])
    align_mod._LOOP_CACHE.clear()
    align_images(**kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = align_images(**kw)
        torch.cuda.synchronize()
    assert res.setup_breakdown["loop_graph_hits"] == 1
    assert res.setup_breakdown["loop_replays"] == 6
    ran = {k: 0 for k in kernels.LAUNCHES}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        for k, pat in _KERNEL_NAMES.items():
            if re.search(pat, e.key):
                ran[k] += e.count
    assert ran == dict(kernels.LAUNCHES), (ran, kernels.LAUNCHES)


#: the CUDA kernel each wrapper launches once a call: a pattern of the
#: profiler's demangled names (PyTorch's own ``vectorized_gather_kernel``
#: is not B2)
_KERNEL_NAMES = {"drizzle_deposit": r"\bdeposit_tiles<",
                 "blot_gather": r"\b(gather_kernel<|nearest_kernel\()",
                 "measure_displacement": r"\bmeasure_(fft|mixed)_kernel<"}


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
    cpu = align_images(device="cpu", device_catalog="device", **kw)
    assert res.n_iterations == cpu.n_iterations
    for ra, rb in zip(res.history, cpu.history):
        for a, b in zip(ra, rb):
            assert a.nmatches == b.nmatches
            assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


def _gauss(H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    return lambda x0, y0, amp, sig: amp * np.exp(
        -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig * sig))


def _finder_scenes(dev):
    """(label, image on ``dev``, finder keywords): the 8 x 1024² stack's
    drizzled reference (the main path's), a crowded deblend field and a
    footprint that escalates the window."""
    from subpixal_tpu_torch.ops.drizzle import drizzle_combine
    from subpixal_tpu_torch.resample import Drizzle

    exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                             seed=11)
    drz = Drizzle(exps, device=dev)
    drz.execute()
    yield "8 x 1024² drizzled", drizzle_combine(drz._sci_acc, drz._wht_acc,
                                                fill=drz.fillval), {}
    rng = np.random.default_rng(9)
    g = _gauss(96, 96)
    crowded = (g(40.0, 48.0, 100.0, 2.0) + g(47.0, 50.0, 55.0, 2.0)
               + g(70.0, 20.0, 80.0, 1.8) + g(70.0, 27.5, 60.0, 1.8)
               + g(20.0, 75.0, 90.0, 2.0) + rng.normal(0, 0.05, (96, 96)))
    yield "crowded deblend", torch.tensor(crowded, dtype=torch.float32,
                                          device=dev), dict(threshold=1.0)
    rng = np.random.default_rng(21)
    g = _gauss(160, 160)
    giant = (g(80.0, 78.0, 100.0, 12.0) + g(30.0, 30.0, 60.0, 1.8)
             + g(130.0, 40.0, 70.0, 1.8) + rng.normal(0, 0.05, (160, 160)))
    yield "window escalation", torch.tensor(
        giant, dtype=torch.float32, device=dev), dict(threshold=1.0,
                                                      deblend_nthresh=1)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["peaks", "ccl"])
def test_device_finder_on_card_matches_cpu(card, method):
    """The device finder on CUDA tensors against the same function on the
    CPU: rows, areas, bboxes and segmentation planes equal, positions
    within 1e-4 px, fluxes within 1e-5 relative."""
    from subpixal_tpu_torch.catalogs_device import find_sources_device

    for label, img, kw in _finder_scenes(card):
        gc, gseg = find_sources_device(img, method=method, **kw)
        cc, cseg = find_sources_device(img.cpu(), method=method, **kw)
        assert gseg.device.type == "cuda" and len(gc) == len(cc) > 0, label
        for col in ("id", "area", "xmin", "xmax", "ymin", "ymax"):
            np.testing.assert_array_equal(gc[col], cc[col], err_msg=label)
        for col in ("x", "y"):
            assert np.abs(gc[col] - cc[col]).max() < 1e-4, (label, col)
        np.testing.assert_allclose(gc["flux"], cc["flux"], rtol=1e-5)
        assert torch.equal(gseg.cpu(), cseg), label


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dict(wcsupdate="otf"),
                                  dict(device_loop=False)])
def test_otf_and_host_loop_on_card(card, mode):
    """'otf' (B1 once per exposure an iteration, once at setup) and the
    host loop on the card: one iteration equals the CPU run (the plain versions) with the
    same finder. otf converges geometrically (every exposure is measured
    against a reference that moved with the earlier ones' updates), so
    both run 6 iterations."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kw = dict(exposures=exps, fitgeom="shift", usfac=8, fit_type="gaussian",
              device_catalog="device", **mode)
    kernels.reset_launch_counts()
    res = align_images(device="cuda", max_iterations=6, eps_shift=1e-9, **kw)
    per_iter = 3 if mode.get("wcsupdate") == "otf" else 1
    assert kernels.LAUNCHES["drizzle_deposit"] == 1 + per_iter * 6
    assert kernels.LAUNCHES["blot_gather"] == per_iter * 6
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(device="cpu", max_iterations=1, **kw)
    for a, b in zip(res.history[0], cpu.history[0]):
        assert a.nmatches == b.nmatches
        assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DRIZZLE_KERNELS)
def test_per_plane_deposit_matches_plain(card, kernel):
    """B1 with per-exposure planes: one launch for 8 × 256² planes at
    ratios 1.0, 0.5 and 2.0, each (Ho, Wo) plane held to the plain
    version's, and the planes' sum to the summed launch."""
    ratios = (1.0, 0.5, 2.0, 1.0, 0.5, 2.0, 1.0, 1.0)
    t, oshape = _stack_scene(card, ratios, H=256, W=256, seed=6)
    args = (t["data"], t["wht"], t["x"], t["y"], oshape)
    before = kernels.LAUNCHES["drizzle_deposit"]
    s, w, esc = drizzle_deposit_stack(*args, pixfrac=0.9,
                                      pscale_ratio=ratios, kernel=kernel,
                                      per_plane=True)
    ps, pw = plain_deposit_stack(*args, pixfrac=0.9, pscale_ratio=ratios,
                                 kernel=kernel, per_plane=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["drizzle_deposit"] == before + 1
    assert tuple(s.shape) == tuple(ps.shape) == (8,) + oshape
    assert int(esc.abs().sum()) == 0 and float(pw.sum()) > 0
    for e in range(8):
        assert _close(s[e], ps[e]) and _close(w[e], pw[e]), e
    ss, sw, _ = drizzle_deposit_stack(*args, pixfrac=0.9,
                                      pscale_ratio=ratios, kernel=kernel)
    assert _close(s.sum(0), ss) and _close(w.sum(0), sw)


def _stage_scene(dev=None, E=4, shape=(96, 104), seed=3):
    """Exposures with sky offsets, half of them counts of other exptimes,
    two dead pixels shared by all and planted CR hits; data as tensors on
    ``dev`` (host arrays when None)."""
    rng = np.random.default_rng(seed)
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    stars = rng.uniform(12, min(shape) - 12, (8, 2))
    hits = [(20, 30), (60, 15), (41, 77)]
    exps = []
    for e in range(E):
        dx, dy = rng.uniform(-2, 2, 2)
        img = rng.normal(0, 0.02, shape) + 0.4 * e - 0.5
        for x0, y0 in stars:
            img += 30.0 * np.exp(-((xx - x0 - dx) ** 2 + (yy - y0 - dy) ** 2)
                                 / (2 * 1.8 ** 2))
        img[7, 9] = img[50, 61] = -5.0
        for k, (y, x) in enumerate(hits):
            if k % E == e:
                img[y, x] += 500.0
        t = 40.0 + 10.0 * e if e % 2 else 1.0
        data = (img * t).astype(np.float32)
        exps.append(Exposure(
            data if dev is None else torch.tensor(data, device=dev),
            TanWCS(crpix=np.array([52.0 + dx, 48.0 + dy]),
                   crval=np.array([150.0, 2.0]), cd=cd),
            exptime=t, data_units="counts" if e % 2 else "rate",
            name=f"s{e}"))
    return exps, hits


@pytest.mark.cuda
def test_stacked_execute_on_card_matches_cpu(card, monkeypatch):
    """Drizzle.execute of a 3 × 256² stack on the card is ONE per-plane
    launch; its planes and sums equal the CPU run of the same stacked
    path (forced there) within 1e-4 of the largest value (each device
    evaluates the f32 pixmaps in its own rounding)."""
    from subpixal_tpu_torch import resample as R

    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    kernels.reset_launch_counts()
    gd = R.Drizzle([e.copy() for e in exps], device=card)
    gd.execute()
    assert kernels.LAUNCHES["drizzle_deposit"] == 1
    assert gd._data_stack.device.type == "cuda"
    monkeypatch.setattr(R, "device_pixmap_min_pixels", lambda device: 1)
    cd = R.Drizzle([e.copy() for e in exps], device="cpu")
    cd.execute()
    for e in exps:
        for a, b in zip(gd._per_exp[e.name], cd._per_exp[e.name]):
            scale = max(1.0, float(b.abs().max()))
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    scale = float(np.abs(cd.output_sci).max())
    assert np.abs(gd.output_sci - cd.output_sci).max() <= 1e-4 * scale
    np.testing.assert_array_equal(gd.output_ctx, cd.output_ctx)


@pytest.mark.cuda
def test_stage_tensor_branches_on_card_match_host(card):
    """match_sky, the static mask and reject_cr on CUDA-tensor exposures
    (the tensor branches, on the card) against the host branches: skies
    within 1e-4, equal masks, planted hits identical, CR totals within 2;
    weights stay on the card and the input tensors are not written."""
    from subpixal_tpu_torch.resample import Drizzle

    host, hits = _stage_scene()
    dev_exps, _ = _stage_scene(card)
    orig = [e.data.clone() for e in dev_exps]
    hd = Drizzle([e.copy() for e in host], device=card)
    gd = Drizzle([e.copy() for e in dev_exps], device=card)
    np.testing.assert_allclose(gd.match_sky(), hd.match_sky(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(gd.apply_static_mask(),
                                  hd.apply_static_mask())
    assert gd.exposures[0].weight.device.type == card.type
    gm, hm = gd.reject_cr(snr=5.0), hd.reject_cr(snr=5.0)
    for k, (y, x) in enumerate(hits):
        assert gm[k % 4][y, x] and hm[k % 4][y, x]
    assert abs(sum(int(m.sum()) for m in gm)
               - sum(int(m.sum()) for m in hm)) <= 2
    for e, o in zip(dev_exps, orig):
        assert torch.equal(e.data, o) and e.weight is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((7,), None), ((8,), None),
                                       ((8, 4096), 0), ((5, 333), 0)])
def test_nanmedian_on_card_matches_numpy(card, shape, dim):
    """The NaN-median helper on the card: NaNs sort last, an even count
    averages its middle pair, an all-NaN slice gives NaN — np.nanmedian
    exactly."""
    import warnings

    from subpixal_tpu_torch.resample import nanmedian

    rng = np.random.default_rng(int(np.prod(shape)))
    x = rng.normal(2.0, 3.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = np.nan
    if dim is not None:
        x[:, 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.nanmedian(x, axis=dim)
    got = nanmedian(torch.tensor(x, device=card), dim=dim)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


#: the JAX package's align configuration, 4 iterations, for the mesh tests
_MESH_KW = dict(fitgeom="shift", usfac=8, fit_type="gaussian",
                max_iterations=4, eps_shift=1e-9)


def _same_as_one_device(res, one):
    """The JAX package's mesh bar (tests/test_mesh_align.py) between a
    mesh run and the one-device run; ``res`` as a dict of lists."""
    assert res["n_iterations"] == one.n_iterations
    assert np.abs(np.asarray(res["shifts"]) - one.shifts).max() < 5e-4
    np.testing.assert_allclose(res["matrices"], one.matrices, atol=5e-5)


@pytest.mark.cuda
def test_mesh_one_nccl_rank_on_card_matches_one_device(card):
    """``mesh=make_mesh(1)``: one NCCL rank on an in-memory store; B1 once
    at setup and once an iteration, B2 and B3 once an iteration."""
    import torch.distributed as dist

    from subpixal_tpu_torch.parallel import make_mesh

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    one = align_images(exposures=exps, device="cuda", **_MESH_KW)
    mesh = make_mesh(1)
    try:
        assert dist.get_backend(mesh.group()) == "nccl"
        kernels.reset_launch_counts()
        res = align_images(exposures=exps, device="cuda", mesh=mesh,
                           **_MESH_KW)
        launches = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    n = res.n_iterations
    assert launches == {"drizzle_deposit": 1 + n, "blot_gather": n,
                        "measure_displacement": n}
    _same_as_one_device(dict(n_iterations=n, shifts=res.shifts,
                             matrices=res.matrices), one)
    assert pairwise_shift_errors(res.shifts, planted) < 0.005


def _eager_loop():
    """The align loop with capture turned off (``_fixed_point``'s private
    ``capture``): under a mesh the masked step run eagerly at the same
    cadence."""
    import functools
    from unittest import mock

    return mock.patch.object(align_mod, "_fixed_point", functools.partial(
        align_mod._fixed_point, capture=False))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mesh", "spatial"])
def test_nccl_loop_captured_cached_and_dropped_with_its_group(card, kind):
    """One NCCL rank (``mesh=make_mesh(1)``) and one NCCL band (a
    ``Drizzle(spatial_mesh=)`` on it): the first call captures the masked
    step with its collectives (1 capture, n − 1 replays), a second call
    replays the cached graph n times, each with at most ⌈n/4⌉ + 1 host
    reads (the ranks' agreement among them) and the launch rule of one
    card, and both follow the same call with capture turned off (the
    eager mesh loop) within 1e-4 px at equal ``nmatches``. Once the group
    is destroyed and a new one made, the next call captures anew: the old
    group's graph never replays and leaves the cache."""
    import torch.distributed as dist

    from subpixal_tpu_torch.parallel import make_mesh
    from subpixal_tpu_torch.resample import Drizzle

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kw = dict(device="cuda", max_iterations=6, eps_shift=0.0,
              **_GRAPH_PATHS["new"])

    def call(mesh):
        if kind == "mesh":
            return align_images(exposures=exps, mesh=mesh, **kw)
        return align_images(resample=Drizzle(exps, spatial_mesh=mesh), **kw)

    align_mod._LOOP_CACHE.clear()
    mesh = make_mesh(1)
    try:
        assert dist.get_backend(mesh.group()) == "nccl"
        runs = []
        for cached in (False, True):
            kernels.reset_launch_counts()
            res = call(mesh)
            launches = dict(kernels.LAUNCHES)
            bd = res.setup_breakdown
            n = res.n_iterations
            assert n == 6 and not res.converged
            assert (bd["loop_graphs"], bd["loop_graph_hits"]) == (
                (0, 1) if cached else (1, 0))
            assert bd["loop_replays"] == n - bd["loop_graphs"]
            assert bd["loop_steps"] == n and bd["loop_compile"] > 0
            assert bd["loop_host_reads"] <= -(-n // 4) + 1
            assert launches == {"drizzle_deposit": 1 + n, "blot_gather": n,
                                "measure_displacement": n}
            assert pairwise_shift_errors(res.shifts, planted) < 0.005
            runs.append(res)
        with _eager_loop():
            eager = call(mesh)
        ebd = eager.setup_breakdown
        assert "loop_graphs" not in ebd and "loop_compile" not in ebd
        assert ebd["loop_host_reads"] <= -(-n // 4) + 1
        for res in runs:
            assert res.n_iterations == eager.n_iterations
            for ra, rb in zip(res.history, eager.history):
                for a, b in zip(ra, rb):
                    assert a.nmatches == b.nmatches
                    assert np.hypot(*np.subtract(a.shift, b.shift)) < 1e-4
        old = [e for e in align_mod._LOOP_CACHE.values() if e.groups]
        assert len(old) == 1
    finally:
        dist.destroy_process_group()
    mesh = make_mesh(1)
    try:
        res = call(mesh)
    finally:
        dist.destroy_process_group()
    bd = res.setup_breakdown
    assert (bd["loop_graphs"], bd["loop_graph_hits"]) == (1, 0)
    assert all(e is not old[0] for e in align_mod._LOOP_CACHE.values())
    assert np.abs(res.shifts - runs[0].shifts).max() < 1e-4


@pytest.mark.cuda
def test_failed_nccl_capture_raises_and_runs_nothing_eagerly(card):
    """Under one NCCL rank a step that reads the host runs its eager
    warm-up (collective and all), then its capture raises: nothing
    retries it eagerly, nothing is cached."""
    import torch.distributed as dist

    from subpixal_tpu_torch.align import _fixed_point
    from subpixal_tpu_torch.parallel import make_mesh

    calls = []

    def step(b, Ms, ts):
        calls.append(torch.cuda.is_current_stream_capturing())
        bad = float(ts.sum().item())  # a host read, before any collective
        s = ts.sum()[None] + bad
        dist.all_reduce(s, group=mesh.group())
        return Ms, ts + s, dict(max_shift=s[0] + 1.0)

    align_mod._LOOP_CACHE.clear()
    mesh = make_mesh(1)
    try:
        with pytest.raises(RuntimeError):
            _fixed_point(step, None, torch.eye(2, device=card)[None],
                         torch.zeros(1, 2, device=card), {}, 6, 1e-3, {},
                         ("failing NCCL step",), mesh=mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert calls == [False, True]
    assert not align_mod._LOOP_CACHE


_TWO_RANKS_ON_ONE_CARD = r"""
import json, sys
import torch
from subpixal_tpu_torch import align_images, kernels
from subpixal_tpu_torch.parallel import init_distributed, make_mesh
from subpixal_tpu_torch.testing import simulate_stack

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh(world, device="cuda:0")
exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
kernels.reset_launch_counts()
res = align_images(exposures=exps, device="cuda", mesh=mesh, **json.loads(
    sys.argv[4]))
print("RESULT " + json.dumps(dict(
    shifts=res.shifts.tolist(), matrices=res.matrices.tolist(),
    n_iterations=res.n_iterations, launches=dict(kernels.LAUNCHES))),
    flush=True)
"""


@pytest.mark.cuda
def test_mesh_two_gloo_ranks_share_one_card(card):
    """Two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    card): 3 frames padded to 4, each rank's B1 once at setup and once an
    iteration on its 2 planes (rank 1's second is a weight-0 pad), B2 and
    B3 once an iteration on its half of the cutout batch."""
    import json

    from subpixal_tpu_torch.testing import SpawnedRanks

    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    one = align_images(exposures=exps, device="cuda", **_MESH_KW)
    outs = SpawnedRanks(_TWO_RANKS_ON_ONE_CARD, 2,
                        args=(json.dumps(_MESH_KW),)).wait(timeout=300)
    recs = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]
    assert recs[0]["shifts"] == recs[1]["shifts"]
    for r in recs:
        n = r["n_iterations"]
        assert r["launches"] == {"drizzle_deposit": 1 + n, "blot_gather": n,
                                 "measure_displacement": n}
        _same_as_one_device(r, one)


@pytest.mark.cuda
def test_use_pallas_false_launches_no_kernel_on_card(card):
    """align_images(use_pallas=False) and Drizzle(use_pallas=False) on the
    card: no kernel launched, shifts within 1e-3 px (the slice's bar) of
    the kernels' run and the planted shifts recovered; the kernels' run
    still launches all three. use_pallas=True takes the kernels too."""
    from subpixal_tpu_torch.resample import Drizzle

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kw = dict(exposures=exps, device="cuda", **_MESH_KW)
    kernels.reset_launch_counts()
    plain = align_images(use_pallas=False, **kw)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    kernels.reset_launch_counts()
    forced = align_images(use_pallas=True, **kw)
    assert all(n > 0 for n in kernels.LAUNCHES.values())
    one = align_images(**kw)
    assert plain.n_iterations == one.n_iterations
    assert np.abs(plain.shifts - one.shifts).max() < 1e-3
    assert np.abs(forced.shifts - one.shifts).max() < 1e-3
    assert pairwise_shift_errors(plain.shifts, planted) < 0.005
    kernels.reset_launch_counts()
    d = Drizzle(exps, device="cuda", use_pallas=False)
    d.execute()
    assert kernels.LAUNCHES["drizzle_deposit"] == 0
    k = Drizzle(exps, device="cuda")
    k.execute()
    assert kernels.LAUNCHES["drizzle_deposit"] == 1
    assert _close(torch.tensor(d.output_sci), torch.tensor(k.output_sci))


@pytest.mark.cuda
def test_simulate_stack_renders_on_card(card):
    """simulate_stack(device='cuda') and device=True: frames as float32
    CUDA tensors, planted equal to the host render's; without noise the
    frames within a few float32 ulps of the star amplitude of the host
    render; the new path aligns the device scene."""
    scene = dict(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    host, hp = simulate_stack(noise=0.0, **scene)
    for device in ("cuda", True):
        dev, dp = simulate_stack(noise=0.0, device=device, **scene)
        assert dp == hp
        for a, b in zip(dev, host):
            assert a.data.is_cuda and a.data.dtype == torch.float32
            assert float(np.abs(a.data.cpu().numpy() - b.data).max()) \
                <= 8 * float(np.spacing(np.float32(25.0)))
    exps, planted = simulate_stack(device="cuda", **scene)
    res = align_images(exposures=exps, device="cuda", **_MESH_KW)
    assert pairwise_shift_errors(res.shifts, planted) < 0.005


_ONE_NCCL_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from subpixal_tpu_torch.parallel import init_distributed

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert init_distributed(addr, world, rank, local_device_ids=[0],
                        backend="nccl")
t = torch.ones(3, device="cuda")
dist.all_reduce(t)
print("RESULT " + json.dumps(dict(
    current=torch.cuda.current_device(), backend=dist.get_backend(),
    sum=t.tolist())), flush=True)
"""


@pytest.mark.cuda
def test_init_distributed_local_device_ids_one_nccl_rank(card):
    """init_distributed(..., local_device_ids=[0]) for one NCCL rank: card
    0 current before the group is set up, and the group reduces on it."""
    import json

    from subpixal_tpu_torch.testing import SpawnedRanks

    out = SpawnedRanks(_ONE_NCCL_RANK, 1).wait(timeout=120)[0]
    rec = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("RESULT "))[7:])
    assert rec == {"current": 0, "backend": "nccl", "sum": [1.0] * 3}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["set", "add"])
def test_insert_cutouts_on_card_matches_cpu(card, mode):
    """Overlapping, partly and wholly off-image, masked cutouts: 'set'
    (one scatter a cutout, in batch order) equals the CPU exactly; 'add'
    is one index_add_, whose atomics sum in any order."""
    from subpixal_tpu_torch.ops.cutouts import insert_cutouts

    rng = np.random.default_rng(3)
    image = torch.tensor(rng.normal(size=(40, 36)), dtype=torch.float32)
    data = torch.tensor(rng.normal(size=(6, 9, 11)), dtype=torch.float32)
    blc = torch.tensor([[3, 4], [6, 8], [5, 5], [-4, 30], [35, -6],
                        [90, 90]], dtype=torch.int32)
    mask = torch.tensor(rng.random(tuple(data.shape)) > 0.25)
    want = insert_cutouts(image, data, blc, mask, mode=mode)
    got = insert_cutouts(*(t.to(card) for t in (image, data, blc, mask)),
                         mode=mode)
    assert got.device.type == "cuda"
    if mode == "set":
        assert torch.equal(got.cpu(), want)
    else:
        assert _close(got.cpu(), want)


# --------------------------------------------------------------------- #
# the spatial mosaics: B1 and B2 on row bands, one or two gloo ranks
# sharing the card
# --------------------------------------------------------------------- #

#: one rank of the band tests: argv[4] the inputs (npz), argv[5] where
#: rank 0 writes the gathered results (npz)
_SPATIAL_KERNELS = r"""
import json, sys
import numpy as np
import torch
from subpixal_tpu_torch import kernels
from subpixal_tpu_torch.parallel import (
    drizzle_deposit_sparse_spatial, drizzle_deposit_spatial, gather_rows,
    init_distributed, make_mesh, sample_spatial, shard_rows)
from subpixal_tpu_torch.resample import Drizzle, Exposure
from subpixal_tpu_torch.wcs import TanWCS

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh(world, axis_name="rows", device="cuda:0")
z = {k: torch.tensor(v, device="cuda:0")
     for k, v in np.load(sys.argv[4]).items()}
Ho, Wo = (int(v) for v in z["oshape"])
ratios = tuple(float(r) for r in z["ratios"])
out, launches = {}, {}


def count(name, fn):
    kernels.reset_launch_counts()
    r = fn()
    torch.cuda.synchronize()
    launches[name] = dict(kernels.LAUNCHES)
    return r


for name, fn in (
        ("dense", lambda: drizzle_deposit_spatial(
            mesh, z["data"][0], z["wht"][0], z["x"][0], z["y"][0],
            (Ho, Wo), pixfrac=0.9, pscale_ratio=ratios[0])),
        ("stacked", lambda: drizzle_deposit_spatial(
            mesh, z["data"], z["wht"], z["x"], z["y"], (Ho, Wo),
            pixfrac=0.9, pscale_ratio=ratios)),
        ("compacted", lambda: drizzle_deposit_sparse_spatial(
            mesh, *(z["c_" + k][None].expand((world,) + z["c_" + k].shape)
                    for k in ("data", "wht", "x", "y")), (Ho, Wo),
            pixfrac=0.9, pscale_ratio=ratios))):
    s, w = count(name, fn)
    out[name + "_sci"] = gather_rows(s, Ho, mesh=mesh)
    out[name + "_wht"] = gather_rows(w, Ho, mesh=mesh)
band = shard_rows(mesh, z["plane"])
H = z["plane"].shape[0]
for interp in ("nearest", "linear", "poly3", "poly5", "spline3", "sinc"):
    v, ok = count(interp, lambda: sample_spatial(
        mesh, band, z["qx"], z["qy"], interp=interp, fill=-7.0,
        logical_rows=H))
    out[interp + "_val"] = v.cpu().numpy()
    out[interp + "_ok"] = ok.cpu().numpy()
for sinscl in (0.5, 1.5, 2.0):
    key = f"sinc{int(10 * sinscl)}"
    v, ok = count(key, lambda: sample_spatial(
        mesh, band, z["qx"], z["qy"], interp="sinc", sinscl=sinscl,
        fill=-7.0, logical_rows=H))
    out[key + "_val"] = v.cpu().numpy()
    out[key + "_ok"] = ok.cpu().numpy()
# use_pallas=False: the plain partials and B1's plain version on the card
v, ok = count("poly5_plain", lambda: sample_spatial(
    mesh, band, z["qx"], z["qy"], fill=-7.0, logical_rows=H,
    use_pallas=False))
out["poly5_plain_val"] = v.cpu().numpy()
out["poly5_plain_ok"] = ok.cpu().numpy()
s, w = count("stacked_plain", lambda: drizzle_deposit_spatial(
    mesh, z["data"], z["wht"], z["x"], z["y"], (Ho, Wo), pixfrac=0.9,
    pscale_ratio=ratios, use_pallas=False))
out["stacked_plain_sci"] = gather_rows(s, Ho, mesh=mesh)
# an 8-row plane: bands of 4 rows on two ranks, thinner than poly5's
# footprint, and spline3 with a spline_halo below its footprint
thin = shard_rows(mesh, z["thin"])
for interp, sh in (("poly5", 32), ("poly3", 32), ("sinc", 32),
                   ("spline3", 2)):
    v, ok = count("thin_" + interp, lambda: sample_spatial(
        mesh, thin, z["tqx"], z["tqy"], interp=interp, fill=-7.0,
        spline_halo=sh))
    out[f"thin_{interp}_val"] = v.cpu().numpy()
    out[f"thin_{interp}_ok"] = ok.cpu().numpy()
    try:
        sample_spatial(mesh, thin, z["tqx"], z["tqy"], interp=interp,
                       spline_halo=sh, use_pallas=True)
        launches["thin_forced_" + interp] = "ran"
    except ValueError as e:
        launches["thin_forced_" + interp] = str(e)
cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
exps = [Exposure(z["exp"][e].cpu().numpy(), TanWCS(
    crpix=np.array([128.3 + 0.4 * e, 128.0 - 0.3 * e]),
    crval=np.array([150.0, 2.0]), cd=cd), exptime=1.0 + e, name=f"s{e}")
    for e in range(z["exp"].shape[0])]
d = Drizzle(exps, spatial_mesh=mesh)
count("execute", d.execute)
out["execute_sci"] = d.output_sci
out["execute_wht"] = d.output_wht
if rank == 0:
    np.savez(sys.argv[5], **out)
print("RESULT " + json.dumps(launches), flush=True)
"""


@pytest.fixture(scope="module")
def spatial_kernels(tmp_path_factory):
    """The band tests' inputs, and the gathered results of one and two
    gloo ranks sharing cuda:0 (run only where there is a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    import json

    from subpixal_tpu_torch.testing import SpawnedRanks

    root = tmp_path_factory.mktemp("spatial_kernels")
    ratios = (1.0, 0.7, 1.3)
    t, (n, _) = _stack_scene("cpu", ratios, H=160, W=256, rot=2.0, seed=8)
    # an output taller than wide: strips wholly outside a band and strips
    # that straddle the bands' boundary
    oshape = (n + 37, n)
    rng = np.random.default_rng(8)
    nb = (160 // 16) * (256 // 128)
    idx = torch.tensor(np.stack([np.sort(rng.permutation(nb)[:8])
                                 for _ in ratios]))
    valid = torch.ones(idx.shape, dtype=torch.bool)
    valid[:, -2:] = False
    comp = _compact_blocks(t["data"], t["wht"], t["x"], t["y"], idx, valid)
    H, W = 203, 150
    plane = rng.uniform(0.0, 4.0, (H, W))
    B, h, w = 24, 12, 12
    gy, gx = np.mgrid[0:h, 0:w]
    # origins inside, across the middle rows (the bands' boundary) and
    # past every edge
    oy = np.concatenate([rng.uniform(-8, H - 4, B - 6),
                         H // 2 - 6 + rng.uniform(-2, 2, 6)])
    ox = rng.uniform(-8, W - 4, B)
    inputs = dict(
        {k: v.numpy() for k, v in t.items()},
        **{"c_" + k: v.numpy() for k, v in zip(("data", "wht", "x", "y"),
                                              comp)},
        oshape=np.asarray(oshape), ratios=np.asarray(ratios), plane=plane,
        qx=gx[None] + ox[:, None, None] + 0.37,
        qy=gy[None] + oy[:, None, None] + 0.61,
        exp=rng.uniform(0.0, 2.0, (3, 256, 256)),
        thin=rng.uniform(0.0, 4.0, (8, 96)),
        tqx=gx[None] + rng.uniform(-4, 88, B)[:, None, None] + 0.37,
        tqy=gy[None] + rng.uniform(-10, 8, B)[:, None, None] + 0.61)
    inputs = {k: np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                            else None) for k, v in inputs.items()}
    path = str(root / "inputs.npz")
    np.savez(path, **inputs)
    runs = {}
    for world in (1, 2):
        res = str(root / f"out{world}.npz")
        outs = SpawnedRanks(_SPATIAL_KERNELS, world,
                            args=(path, res)).wait(timeout=300)
        launches = [json.loads(next(ln for ln in o.splitlines()
                                    if ln.startswith("RESULT "))[7:])
                    for o in outs]
        runs[world] = (dict(np.load(res)), launches)
    return {k: torch.tensor(v) for k, v in inputs.items()}, runs


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kind", ["dense", "stacked", "compacted"])
def test_band_deposits_union_is_whole_plane_b1(card, spatial_kernels, world,
                                               kind):
    """B1 on each rank's band (one launch a rank), the bands gathered:
    the whole plane's B1 deposit, including strips wholly outside a band
    and strips across the bands' boundary."""
    z, runs = spatial_kernels
    out, launches = runs[world]
    ratios = tuple(float(r) for r in z["ratios"])
    src = {"dense": ("data", "wht", "x", "y"),
           "stacked": ("data", "wht", "x", "y"),
           "compacted": ("c_data", "c_wht", "c_x", "c_y")}[kind]
    d, wt, x, y = (z[k].to(card) for k in src)
    if kind == "dense":
        d, wt, x, y, ratios = d[:1], wt[:1], x[:1], y[:1], ratios[:1]
    oshape = tuple(int(v) for v in z["oshape"])
    s, w, _ = drizzle_deposit_stack(d, wt, x, y, oshape, pixfrac=0.9,
                                    pscale_ratio=ratios)
    assert float(w.sum()) > 0
    assert _close(torch.tensor(out[kind + "_sci"]), s.cpu())
    assert _close(torch.tensor(out[kind + "_wht"]), w.cpu())
    assert all(la[kind] == {"drizzle_deposit": 1, "blot_gather": 0,
                            "measure_displacement": 0} for la in launches)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("interp", sorted(INTERP_TAPS))
def test_sample_spatial_b2_matches_whole_plane(card, spatial_kernels, world,
                                               interp):
    """sample_spatial through B2 on each rank's halo-extended band (one
    launch a rank; nearest takes the plain partials), against B2 on the
    whole plane, on cutout grids across the bands' boundary and every
    edge: equal validity, values within REL_TOL."""
    z, runs = spatial_kernels
    out, launches = runs[world]
    want, ok, _ = sample_cutouts(z["plane"].to(card), z["qx"].to(card),
                                 z["qy"].to(card), interp=interp, fill=-7.0)
    assert torch.equal(torch.tensor(out[interp + "_ok"]), ok.cpu())
    assert _close(torch.tensor(out[interp + "_val"]), want.cpu())
    n = 0 if interp == "nearest" else 1
    assert all(la[interp]["blot_gather"] == n for la in launches)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("sinscl", [0.5, 1.5, 2.0])
def test_sample_spatial_sinc_sinscl_matches_plain(card, spatial_kernels,
                                                  world, sinscl):
    """sample_spatial(interp='sinc', sinscl=s) through B2 on each rank's
    band (one launch a rank), against the plain partials (the same call
    on CPU tensors, one band): equal validity, values within REL_TOL."""
    from subpixal_tpu_torch.parallel.sharding import Mesh
    from subpixal_tpu_torch.parallel.spatial import sample_spatial

    z, runs = spatial_kernels
    out, launches = runs[world]
    key = f"sinc{int(10 * sinscl)}"
    mesh = Mesh(None, 0, 1, torch.device("cpu"), ("rows",))
    want, ok = sample_spatial(mesh, z["plane"], z["qx"], z["qy"],
                              interp="sinc", sinscl=sinscl, fill=-7.0)
    assert torch.equal(torch.tensor(out[key + "_ok"]), ok)
    assert _close(torch.tensor(out[key + "_val"]), want)
    assert all(la[key]["blot_gather"] == 1 for la in launches)


#: the thin plane's cases: (interp, spline_halo)
_THIN = (("poly5", 32), ("poly3", 32), ("sinc", 32), ("spline3", 2))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("interp,spline_halo", _THIN)
def test_sample_spatial_thin_bands_on_card(card, spatial_kernels, world,
                                           interp, spline_halo):
    """sample_spatial on an 8-row plane under the default use_pallas:
    where a band holds the interpolant's footprint (and, for spline3, the
    halo covers it) one B2 launch a rank, else the bands' plain partials
    with no launch; either way validity equal to sample_image's on the
    whole plane, and values within REL_TOL of it (spline3 on one band: of
    the same call's CPU run, whose halo of 2 truncates the prefilter
    alike; on two bands validity only). An
    explicit use_pallas=True runs the shapes B2 takes and refuses the
    others, as the JAX package's does."""
    from subpixal_tpu_torch.parallel.sharding import Mesh
    from subpixal_tpu_torch.parallel.spatial import sample_spatial

    z, runs = spatial_kernels
    out, launches = runs[world]
    halo = INTERP_OFFSETS[interp][-1] - INTERP_OFFSETS[interp][0] + 1
    fits = 8 // world >= halo and spline_halo >= halo
    plane, qx, qy = (z[k].to(card) for k in ("thin", "tqx", "tqy"))
    want, ok = sample_image(plane, qx, qy, interp=interp, fill=-7.0)
    assert torch.equal(torch.tensor(out[f"thin_{interp}_ok"]), ok.cpu())
    assert bool(ok.any())
    if interp == "spline3":  # the halo truncates the band prefilter
        one = Mesh(None, 0, 1, torch.device("cpu"), ("rows",))
        want, _ = sample_spatial(one, z["thin"], z["tqx"], z["tqy"],
                                 interp=interp, fill=-7.0, spline_halo=2)
        if world == 2:  # two bands truncate it otherwise than one
            want = None
    if want is not None:
        assert _close(torch.tensor(out[f"thin_{interp}_val"]), want.cpu())
    for la in launches:
        assert la["thin_" + interp]["blot_gather"] == int(fits)
        forced = la["thin_forced_" + interp]
        assert (forced == "ran") == fits, forced
        assert fits or "use_pallas" in forced


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_spatial_use_pallas_false_on_card(card, spatial_kernels, world):
    """use_pallas=False: sample_spatial sums the bands' plain partials and
    drizzle_deposit_spatial deposits by B1's plain version, with no
    launch; both agree with the kernels' runs."""
    z, runs = spatial_kernels
    out, launches = runs[world]
    assert torch.equal(torch.tensor(out["poly5_plain_ok"]),
                       torch.tensor(out["poly5_ok"]))
    assert _close(torch.tensor(out["poly5_plain_val"]),
                  torch.tensor(out["poly5_val"]))
    assert _close(torch.tensor(out["stacked_plain_sci"]),
                  torch.tensor(out["stacked_sci"]))
    for la in launches:
        assert not any(la["poly5_plain"].values())
        assert not any(la["stacked_plain"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_spatial_drizzle_execute_matches_drizzle(card, spatial_kernels,
                                                 world):
    """Drizzle(spatial_mesh=...).execute (one per-plane B1 launch into
    each band) against Drizzle.execute on the whole plane."""
    from subpixal_tpu_torch.resample import Drizzle

    z, runs = spatial_kernels
    out, launches = runs[world]
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    exps = [Exposure(z["exp"][e].numpy(), TanWCS(
        crpix=np.array([128.3 + 0.4 * e, 128.0 - 0.3 * e]),
        crval=np.array([150.0, 2.0]), cd=cd), exptime=1.0 + e,
        name=f"s{e}") for e in range(3)]
    d = Drizzle(exps, device=card)
    d.execute()
    assert _close(torch.tensor(out["execute_sci"]),
                  torch.tensor(d.output_sci))
    assert _close(torch.tensor(out["execute_wht"]),
                  torch.tensor(d.output_wht))
    assert all(la["execute"]["drizzle_deposit"] == 1 for la in launches)


_SPATIAL_ALIGN = r"""
import json, sys
import torch
from subpixal_tpu_torch import align_images, kernels
from subpixal_tpu_torch.parallel import init_distributed, make_mesh2d
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.testing import simulate_stack

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh2d(*json.loads(sys.argv[4]), device="cuda:0")
exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
kernels.reset_launch_counts()
res = align_images(resample=Drizzle(exps, spatial_mesh=mesh), device="cuda",
                   **json.loads(sys.argv[5]))
print("RESULT " + json.dumps(dict(
    shifts=res.shifts.tolist(), n_iterations=res.n_iterations,
    launches=dict(kernels.LAUNCHES))), flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 2), (2, 1)])
def test_spatial_align_on_2d_mesh(card, dims):
    """align_images through a spatial Drizzle on a (1, 2) mesh (two row
    bands) and a (2, 1) mesh (the frames split, one band), two gloo ranks
    on cuda:0: each rank's B1 once at setup and once an iteration, B2 and
    B3 once an iteration; the ranks agree, and within 2e-3 px (the JAX
    package's spatial bar, tests/test_spatial.py) of the run without a
    spatial mesh."""
    import json

    from subpixal_tpu_torch.testing import SpawnedRanks

    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    one = align_images(exposures=exps, device="cuda", **_MESH_KW)
    outs = SpawnedRanks(_SPATIAL_ALIGN, 2, args=(
        json.dumps(dims), json.dumps(_MESH_KW))).wait(timeout=300)
    recs = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]
    assert recs[0]["shifts"] == recs[1]["shifts"]
    for r in recs:
        n = r["n_iterations"]
        assert n == one.n_iterations
        assert r["launches"] == {"drizzle_deposit": 1 + n, "blot_gather": n,
                                 "measure_displacement": n}
        assert np.abs(np.asarray(r["shifts"]) - one.shifts).max() < 2e-3
    assert pairwise_shift_errors(recs[0]["shifts"], planted) < 0.005


# --------------------------------------------------------------------- #
# the setup programs (aot.get_executable): captured, cached, replayed
# --------------------------------------------------------------------- #

#: each program's bar between its replay and its eager run: B1's atomics
#: (deposit_stack) and index_add_'s (render_stack) sum in an order that
#: changes from run to run; the programs that derive the finder's
#: threshold (cat_count, cat_find) take the finder's bar on the card
#: (``_finder_close``): the statistics' float32 prefix sums (cumsum on the
#: card) may round the threshold otherwise from run to run; every other
#: program is exact
_PROGRAM_TOL = {"deposit_stack": REL_TOL, "render_stack": REL_TOL}
_FINDER_BAR = ("cat_count", "cat_find")


def _finder_close(g, w):
    """One output of a finder program against another run's: the packed
    table's flags, areas, bboxes, counts and peak pixels equal, the kept
    sources' positions within 1e-4 px and fluxes and peaks within 1e-5
    relative; a threshold within 1e-5 relative; anything else equal."""
    if g.dim() == 2 and g.shape[0] == 14 and g.is_floating_point():
        exact = [0, 1, 6, 7, 8, 9, 10, 11, 12, 13]
        kept = w[0] > 0
        return (torch.equal(g[exact], w[exact])
                and bool(((g[3:5] - w[3:5])[:, kept].abs() <= 1e-4).all())
                and bool(((g[(2, 5),] - w[(2, 5),])[:, kept].abs()
                          <= 1e-5 * w[(2, 5),][:, kept].abs()).all()))
    if g.is_floating_point() and g.dim() == 0:
        return abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
    return torch.equal(g, w)


def _leaves(tree):
    """The leaves of a program's argument or result tree."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _fresh(tree):
    """``tree`` with each generator a new copy of its state."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fresh(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, torch.Generator):
        g = torch.Generator(device=tree.device)
        g.set_state(tree.get_state())
        return g
    return tree


def _recorded_programs(dev, monkeypatch):
    """Every setup program the new path's setup runs on a 3 x 256² scene
    (rendered on the card), the finder's fused and explicit-threshold
    programs, as (name, fn, args, statics), one a name, shapes and
    statics (the last call of each: warm_compile's zero inputs give way
    to the path's own), collected by a spy on ``get_executable`` where
    each module imports it."""
    from subpixal_tpu_torch import aot, blot, catalogs_device, resample
    from subpixal_tpu_torch import testing

    calls = []
    real = aot.get_executable

    def spy(name, fn, args, *, statics=None, key_extra=(), timings=None):
        calls.append((name, fn, _fresh(args), dict(statics or {})))
        return real(name, fn, args, statics=statics, key_extra=key_extra,
                    timings=timings)

    with monkeypatch.context() as m:
        for mod in (align_mod, blot, catalogs_device, resample, testing):
            m.setattr(mod, "get_executable", spy)
        exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                 seed=5, device=dev)
        res = align_images(exposures=exps, device=dev,
                           **dict(_MESH_KW, max_iterations=1))
        img = res.drizzle.exposures[0].data
        catalogs_device.find_sources_device(img, max_sources=256)
        catalogs_device.find_sources_device(img, threshold=1.0)
    progs = {}
    for name, fn, args, statics in calls:
        sig = tuple((tuple(a.shape), a.dtype) for a in _leaves(args)
                    if isinstance(a, torch.Tensor))
        progs[(name, repr(sorted(statics.items())), sig)] = (
            name, fn, args, statics)
    return list(progs.values())


def _kernels_ran(prof) -> dict:
    """B1, B2 and B3 kernels a profiler run saw, by wrapper name."""
    ran = {k: 0 for k in kernels.LAUNCHES}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        for k, pat in _KERNEL_NAMES.items():
            if re.search(pat, e.key):
                ran[k] += e.count
    return ran


@pytest.mark.cuda
def test_every_setup_program_captures_hits_and_replays_eagerly(
        card, monkeypatch):
    """Each program of the setup (deposit_stack, cutout_pixmaps_stack,
    device_stage, cat_count, cat_count_thr, cat_peaks, cat_find,
    cat_remap, render_stack): the first call runs it eagerly and captures
    it (a ``{name}.compile`` timing, CUDA graphs; the launches it counts
    are the kernels the profiler saw), the second ``get_executable`` is a
    hit (the same executable, no timing), and the replay equals the
    eager function (exactly; B1's and index_add_'s atomics within
    REL_TOL, the derived-threshold programs by the finder's bar). B1
    launches once a deposit_stack replay, counted at the replay."""
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import aot

    progs = _recorded_programs(card, monkeypatch)
    names = {p[0] for p in progs}
    assert names == {"deposit_stack", "cutout_pixmaps_stack", "device_stage",
                     "cat_count", "cat_count_thr", "cat_peaks", "cat_find",
                     "cat_remap", "render_stack"}, names
    for name, fn, args, statics in progs:
        monkeypatch.setattr(aot, "_MEM", {})
        t = {}
        exe = aot.get_executable(name, fn, _fresh(args), statics=statics,
                                 timings=t)
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            exe(*_fresh(args))
            torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == _kernels_ran(prof), name
        assert exe.steps and f"{name}.compile" in t, name
        t.clear()
        assert aot.get_executable(name, fn, _fresh(args), statics=statics,
                                  timings=t) is exe and not t
        kernels.reset_launch_counts()
        got = exe(*_fresh(args))
        assert kernels.LAUNCHES == exe.launches
        want = fn(*_fresh(args), **statics)
        for g, w in zip(_leaves(got), _leaves(want)):
            if name in _PROGRAM_TOL:
                assert _close(g, w), name
            elif name in _FINDER_BAR:
                assert _finder_close(g, w), name
            else:
                assert torch.equal(g, w), name
        if name == "deposit_stack":
            assert exe.launches["drizzle_deposit"] == 1
        else:
            assert not any(exe.launches.values()), name


@pytest.mark.cuda
def test_capturing_call_launches_match_the_profiler_on_card(card,
                                                           monkeypatch):
    """An align call that captures every setup program and the loop from
    empty caches counts as many B1, B2 and B3 launches as the kernels
    ``torch.profiler`` saw the card run: the programs' and the loop's
    first, eager calls count where they launch, their captures not."""
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import aot

    exps, _ = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12, seed=5)
    kw = dict(exposures=exps, device="cuda", max_iterations=6,
              eps_shift=0.0, **_GRAPH_PATHS["new"])
    align_images(**kw)  # builds the kernels
    monkeypatch.setattr(aot, "_MEM", {})
    align_mod._LOOP_CACHE.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = align_images(**kw)
        torch.cuda.synchronize()
    assert res.setup_breakdown["loop_graphs"] == 1
    assert "deposit_stack.compile" in res.setup_breakdown
    assert kernels.LAUNCHES["drizzle_deposit"] == (
        1 + res.setup_breakdown["loop_steps"])
    assert _kernels_ran(prof) == dict(kernels.LAUNCHES), kernels.LAUNCHES


@pytest.mark.cuda
def test_program_call_reads_nothing_from_the_host(card, monkeypatch):
    """A replayed call of a captured program without a flood (copy in,
    replay, copy out) runs under ``set_sync_debug_mode('error')``; the
    finder's detection reads only its floods' flags, one a block."""
    from subpixal_tpu_torch import aot

    monkeypatch.setattr(aot, "_MEM", {})
    for name, fn, args, statics in _recorded_programs(card, monkeypatch):
        exe = aot.get_executable(name, fn, args, statics=statics)
        aot.ensure_captured(exe, *_fresh(args))
        if any(s.done is not None for s in exe.steps):
            reads = exe.host_reads
            exe(*_fresh(args))
            assert exe.host_reads > reads, name
            continue
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            exe(*_fresh(args))
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_program_that_reads_the_host_raises_and_caches_nothing(
        card, monkeypatch):
    """A program with an ``.item()`` inside: its first call runs it
    eagerly, then its capture raises; nothing is cached, nothing runs it
    eagerly instead, and the default generator draws again after."""
    from subpixal_tpu_torch import aot

    monkeypatch.setattr(aot, "_MEM", {})
    calls = []

    def bad(x):
        calls.append(torch.cuda.is_current_stream_capturing())
        return x * float(x.sum().item())

    exe = aot.get_executable("bad", bad, (torch.ones(4, device=card),))
    with pytest.raises(RuntimeError):
        exe(torch.ones(4, device=card))
    torch.cuda.synchronize()
    assert calls == [False, True] and not aot._MEM
    torch.rand(2, device=card)  # the default generator draws again


@pytest.mark.cuda
def test_program_of_new_shapes_captures_anew(card, monkeypatch):
    """A second call of a program with other shapes captures its own
    graphs; both stay cached, each replaying its own shapes."""
    from subpixal_tpu_torch import aot

    monkeypatch.setattr(aot, "_MEM", {})

    def prog(x, *, k):
        return (x * k).sum(0)

    t = {}
    a, b = torch.rand(4, 5, device=card), torch.rand(6, 3, device=card)
    ea = aot.get_executable("prog", prog, (a,), statics={"k": 2.0},
                            timings=t)
    assert torch.equal(ea(a), prog(a, k=2.0))  # eager, then captured
    t.clear()
    eb = aot.get_executable("prog", prog, (b,), statics={"k": 2.0},
                            timings=t)
    assert torch.equal(eb(b), prog(b, k=2.0))
    assert eb is not ea and "prog.compile" in t and len(aot._MEM) == 2
    assert ea.steps and eb.steps
    assert torch.equal(ea(a), prog(a, k=2.0))  # replays
    assert torch.equal(eb(b), prog(b, k=2.0))
    out = ea(a)
    ea(torch.zeros_like(a))
    assert torch.equal(out, prog(a, k=2.0))  # a copy, not the graph's


# --------------------------------------------------------------------- #
# the call's spans: device time from timing events, none in a capture
# --------------------------------------------------------------------- #

#: the device spans of a call with the defaults on the card (the stacked
#: execute, the device finder, the device pixmaps, the sparse deposit)
_DEVICE_SPANS = ("resample.wcs_params", "resample.deposit_stack",
                 "output_sci", "stack_inputs", "cutout_pixmaps",
                 "frame_pixmaps", "device_stage", "stage_args",
                 "sparse_blocks", "align.loop")


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["capture", "cached"])
def test_device_spans_read_their_events_on_card(card, call):
    """Every device span of a call reads a positive device time, and no
    host span reads one; the host syncs hold the staging's synchronize,
    the finder's table read, the loop's reads and the write-back's two."""
    exps, planted = simulate_stack(n_exp=3, shape=(256, 256), n_stars=12,
                                   seed=5)
    kw = dict(exposures=exps, device="cuda", max_iterations=6)
    align_mod._LOOP_CACHE.clear()
    res = align_images(**kw)
    if call == "cached":
        res = align_images(**kw)
    bd = res.setup_breakdown
    for name in _DEVICE_SPANS:
        assert bd[name + ".device"] > 0, name
    assert {k[:-len(".device")] for k in bd
            if k.endswith(".device")} == set(_DEVICE_SPANS)
    assert bd["host_syncs"] >= bd["loop_host_reads"] + 4
    assert pairwise_shift_errors(res.shifts, planted) < 0.005


@pytest.mark.cuda
def test_spans_in_a_capture_record_no_event_on_card(card, monkeypatch):
    """A device span inside a stream capture records its host time and no
    event, and the capture replays as before; a program whose first call
    runs a device span records the eager run's events alone."""
    from subpixal_tpu_torch import aot, tracing

    monkeypatch.setattr(aot, "_MEM", {})
    out = {}
    x = torch.arange(4096, dtype=torch.float32, device=card)

    def prog(a):
        with tracing.span("inside", device=a.device) as s:
            inside.append(s.ev is not None)
            return a * 2.0

    inside = []
    g = torch.cuda.CUDAGraph()
    with tracing.recording(out, device_events=True):
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            prog(x)  # warm
        torch.cuda.current_stream(card).wait_stream(side)
        with torch.cuda.graph(g):
            y = prog(x)
        g.replay()
        exe = aot.get_executable("span_prog", prog, (x,))
        z = exe(x)  # the first call: eager, then captured
        z2 = exe(x + 1.0)  # a replay runs no span
        with tracing.span("eager", device=card):
            w = y + 1.0
        torch.cuda.synchronize(card)
        tracing.read_device()
    assert inside == [True, False, True, False]
    assert torch.equal(y, x * 2.0) and torch.equal(w, x * 2.0 + 1.0)
    assert torch.equal(z, x * 2.0) and torch.equal(z2, (x + 1.0) * 2.0)
    assert out["span_prog.compile"] > 0 and out["eager.device"] > 0
    assert out["inside"] > 0 and out["inside.device"] > 0
