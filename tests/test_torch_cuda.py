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

import numpy as np
import pytest
import torch

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
    # each exposure's planes), then the whole stack once per iteration
    assert kernels.LAUNCHES["drizzle_deposit"] == 1 + res.n_iterations
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
    assert kernels.LAUNCHES["drizzle_deposit"] == 1 + res.n_iterations
    assert "cutout_pixmaps" in res.setup_breakdown
    assert pairwise_shift_errors(res.shifts, planted) < 0.005
    cpu = align_images(device="cpu", max_iterations=1,
                       device_catalog="device", **kw)
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
        assert dist.get_backend(mesh.group) == "nccl"
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
