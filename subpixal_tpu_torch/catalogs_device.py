"""Source detection on the device: stats, threshold, labeling, moments.

Counterpart of ``subpixal_tpu/catalogs/device.py``: the same detection
semantics as the host :func:`subpixal_tpu_torch.catalogs.find_sources`
(threshold = median + nsigma*std from sigma-clipped statistics,
8-connected components, ``area >= npixels``, flux moments on
``image - threshold``), computed on the tensor's device so that the
drizzled mosaic never crosses to the host. Only the KB-class catalog
table is copied back; the segmentation plane stays on the device for the
align loop's mask sampling.

The JAX package has no Pallas kernel here, so this module is plain torch:
``sort``, ``cumsum``, ``searchsorted``, shifts, ``max_pool2d`` dilations
and ``scatter_reduce``. ``lax.top_k`` becomes a stable descending sort,
which keeps its lower-index-first order among equal values. The flood
fills' ``lax.while_loop`` becomes blocks of ``_CHECK_EVERY`` rounds that
set a done flag on the device, read once a block
(:func:`~subpixal_tpu_torch.aot.repeat_until`; a fixed point does not
move under another round, so the result is the same). The ``peaks``
method runs as the JAX package's named programs (``cat_count``,
``cat_count_thr``, ``cat_find``, ``cat_peaks``, ``cat_remap``) through
:func:`~subpixal_tpu_torch.aot.get_executable`: captured once a shape on
a card, where nothing in them reads the host but the floods' flags.
:func:`warm_compile` captures them for a shape ahead of time.

Two methods (``find_sources_device(method=...)``):

``'peaks'`` (default) — local maxima above the threshold, filtered by an
integral-image minarea test, taken brightest first, each measured by a
flood fill in a ``window``-sized window with the SExtractor-style
multi-threshold deblender run in-window and euclidean nearest-seed skirt
assignment; a footprint that touches its window escalates the window
(doubling, up to ``min(H, W, 256)``).

``'ccl'`` — exact connected components by neighbour-min and pointer
jumping, moments by segment reductions; no deblending.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .aot import ensure_captured, get_executable, repeat_until
from .catalogs import ImageCatalog, Table
from .tracing import to_host

__all__ = ["sigma_clipped_stats_device", "label_components_device",
           "find_sources_device", "DeviceSourceCatalog"]

#: rounds between two convergence tests of a fixed-point loop (each test
#: reads one flag back to the host)
_CHECK_EVERY = 4

#: element budget of one batched deblend flood, (levels, B, win, win): the
#: independent threshold levels run in chunks no larger than this
_FLOOD_BUDGET = 1 << 24


def _as_image(image, device):
    """``image`` as a float32 tensor: a tensor stays on its device, an
    array goes to ``device``."""
    if isinstance(image, torch.Tensor):
        return image.to(torch.float32)
    return torch.as_tensor(np.asarray(image, np.float32), device=device)


def sigma_clipped_stats_device(data, sigma: float = 3.0, maxiters: int = 5,
                               device="cuda"):
    """(mean, median, std) with iterative sigma clipping, as 0-d float32
    tensors on ``data``'s device (an array goes to ``device``).

    Same fixed point as the host ``sigma_clipped_stats``: the clip keeps a
    value interval, so on the sorted data every iteration's kept set is a
    contiguous slice — one sort and median-centred prefix sums replace
    ``maxiters`` passes, and each iteration is two binary searches.
    """
    x = _as_image(data, device).reshape(-1)
    finite = torch.isfinite(x)
    m = finite.sum()                                   # finite count
    s = torch.sort(torch.where(finite, x, torch.inf)).values  # finite first
    # (indices are 0-d device tensors: torch.take reads with them on the
    # device, where s[i] would copy i to the host first)
    # prefix sums of MEDIAN-CENTRED values: f32 sums over 10^7 elements
    # would otherwise lose the statistics to cancellation under a large
    # background level
    med0 = torch.take(s, torch.clamp(m // 2, max=s.numel() - 1))
    sz = torch.where(torch.isfinite(s), s - med0, 0.0)
    c1 = torch.cumsum(sz, 0)
    c2 = torch.cumsum(sz * sz, 0)

    def seg_stats(lo, hi):
        cnt = torch.clamp(hi - lo, min=1)
        prev = torch.clamp(lo - 1, min=0)
        s1 = torch.take(c1, hi - 1) - torch.where(lo > 0, torch.take(c1, prev),
                                                  0.0)
        s2 = torch.take(c2, hi - 1) - torch.where(lo > 0, torch.take(c2, prev),
                                                  0.0)
        mean_c = s1 / cnt
        var = torch.clamp(s2 / cnt - mean_c * mean_c, min=0.0)
        # np.median parity: the mean of the two middle order statistics
        med = 0.5 * (torch.take(s, lo + (cnt - 1) // 2)
                     + torch.take(s, lo + cnt // 2))
        return med0 + mean_c, med, torch.sqrt(var)

    def search(v, right):
        return torch.searchsorted(s, v.reshape(1), right=right)[0]

    lo = torch.zeros((), dtype=torch.int64, device=x.device)
    hi = m
    for _ in range(maxiters):
        _, med, std = seg_stats(lo, hi)
        lo = search(med - sigma * std, False)
        hi = torch.minimum(search(med + sigma * std, True), m)
        hi = torch.maximum(hi, lo + 1)
    return seg_stats(lo, hi)


def _shift(a, dy, dx, fill):
    """``a`` moved by (dy, dx) over its last two axes, ``fill`` padding
    (not a roll: wraparound would join a window's opposite edges)."""
    if not dy and not dx:
        return a
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        a[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def _fixed_point(step, x, max_rounds=None):
    """Apply ``step`` to ``x`` until it stops changing or ``max_rounds``
    rounds have run: blocks of ``_CHECK_EVERY`` rounds, ``x`` updated in
    place, each block's last round setting a done flag on the device that
    the host reads once a block (:func:`aot.repeat_until`). A round after
    the fixed point changes nothing, so the rounds a block runs past it do
    not change the result."""
    if max_rounds == 0:
        return x
    # a bound takes blocks that divide it, so that exactly that many run
    n = _CHECK_EVERY if max_rounds is None else next(
        k for k in range(min(_CHECK_EVERY, max_rounds), 0, -1)
        if max_rounds % k == 0)
    x = x.clone()
    done = torch.zeros((), dtype=torch.bool, device=x.device)

    def block():
        for i in range(n):
            nxt = step(x)
            if i == n - 1:
                done.copy_((nxt == x).all())
            x.copy_(nxt)

    repeat_until(block, done, None if max_rounds is None
                 else max_rounds // n)
    return x


def _dilate(g):
    """8-connected dilation of a (N, h, w) boolean batch."""
    return F.max_pool2d(g[:, None].to(torch.float32), 3, 1, 1)[:, 0] > 0


def _flood(seed, mask):
    """8-connected flood fill of ``seed`` inside ``mask`` ((N, h, w)
    booleans) to convergence: exact for any in-window shape."""
    return _fixed_point(lambda g: _dilate(g) & mask, seed & mask)


def label_components_device(det, connectivity: int = 8, max_iters: int = 64):
    """Connected-component labels of a boolean (H, W) mask on its device.

    Returns an int32 (H, W) plane whose foreground value is the flat index
    of the component's root pixel (its row-major minimum) and ``H*W`` on
    the background. Each round takes the neighbourhood minimum (4- or
    8-connected) and pointer-jumps twice (``lab <- lab[lab]``), so
    convergence needs O(log diameter) rounds; at most ``max_iters``.
    """
    H, W = det.shape
    BIG = H * W
    idx = torch.arange(H * W, dtype=torch.int32, device=det.device)
    lab0 = torch.where(det, idx.reshape(H, W), BIG)
    offs = ([(0, 1), (0, -1), (1, 0), (-1, 0)] if connectivity == 4 else
            [(0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1)])

    def jump(f):
        live = f < BIG
        return torch.where(live, f[torch.where(live, f, 0).long()], BIG)

    def body(lab):
        m = lab
        for dy, dx in offs:
            m = torch.minimum(m, _shift(lab, dy, dx, BIG))
        m = torch.where(det, m, BIG)
        return jump(jump(m.reshape(-1))).reshape(H, W)

    return _fixed_point(body, lab0, max_iters)


def _find_sources_core(img, threshold, *, connectivity, max_sources,
                       max_iters=64):
    """Detection, ``ccl`` method: threshold -> labels -> dense ids ->
    moments. Returns (id plane int32 (H, W), table dict of
    (max_sources + 1,) per-id columns, n_components, n_overflow); table
    row ``i`` describes id ``i`` (row 0 is the background)."""
    H, W = img.shape
    dev = img.device
    det = torch.isfinite(img) & (img > threshold)
    lab = label_components_device(det, connectivity=connectivity,
                                  max_iters=max_iters).reshape(-1)
    detf = det.reshape(-1)
    idx = torch.arange(H * W, device=dev)
    is_root = detf & (lab == idx)
    dense = torch.cumsum(is_root.to(torch.int64), 0)   # root -> 1..K
    n_comp = dense[-1]
    ids = torch.where(detf, dense[torch.where(lab < H * W, lab, 0).long()],
                      0)
    n_overflow = torch.clamp(n_comp - max_sources, min=0)
    ids = torch.where(ids <= max_sources, ids, 0)      # cap: drop overflow
    K = max_sources + 1

    data = torch.where(det, img - threshold, 0.0).reshape(-1)
    xs = (idx % W).to(torch.float32)
    ys = (idx // W).to(torch.float32)

    def seg_sum(v):  # float64 sums: atomics order them differently
        return torch.zeros(K, dtype=torch.float64, device=dev).index_add_(
            0, ids, v.to(torch.float64))

    def seg_reduce(v, how, init):
        return torch.full((K,), init, device=dev).scatter_reduce_(
            0, ids, v, how, include_self=True)

    flux = seg_sum(data)
    safe = torch.where(flux > 0, flux, 1.0)
    big = float(H * W)
    table = dict(
        area=seg_sum(detf.to(torch.float32)).to(torch.float32),
        flux=flux.to(torch.float32),
        cx=(seg_sum(data * xs) / safe).to(torch.float32),
        cy=(seg_sum(data * ys) / safe).to(torch.float32),
        peak=seg_reduce(torch.where(detf, data, -torch.inf), "amax",
                        -torch.inf),
        xmin=seg_reduce(torch.where(detf, xs, big), "amin", torch.inf),
        xmax=seg_reduce(torch.where(detf, xs, -1.0), "amax", -torch.inf),
        ymin=seg_reduce(torch.where(detf, ys, big), "amin", torch.inf),
        ymax=seg_reduce(torch.where(detf, ys, -1.0), "amax", -torch.inf))
    return ids.reshape(H, W).to(torch.int32), table, n_comp, n_overflow


def _apply_keep(seg, keep_lut):
    """Zero rejected ids in the segmentation plane (LUT gather)."""
    return torch.where(keep_lut[seg.long()], seg, 0)


#: raster-order-earlier / -later neighbour offsets: a local maximum is
#: strictly above its raster-earlier neighbours and >= the later ones, so
#: a flat plateau yields exactly one peak (its raster-first pixel)
_EARLIER = ((-1, -1), (-1, 0), (-1, 1), (0, -1))
_LATER = ((0, 1), (1, -1), (1, 0), (1, 1))


def _local_max(x, det):
    """``det`` pixels that are local maxima of ``x`` under the raster tie
    rule; ``x`` holds -inf where not finite."""
    pk = det
    for dy, dx in _EARLIER:
        pk = pk & (x > _shift(x, -dy, -dx, -torch.inf))
    for dy, dx in _LATER:
        pk = pk & (x >= _shift(x, -dy, -dx, -torch.inf))
    return pk


def _candidate_mask(img, threshold, npixels):
    """Local-maximum candidates above ``threshold`` that pass the minarea
    prefilter: the exact candidate set of :func:`_find_sources_peaks_core`,
    shared with the cheap counting pass."""
    H, W = img.shape
    finite = torch.isfinite(img)
    x = torch.where(finite, img, -torch.inf)
    det = finite & (img > threshold)
    # minarea prefilter: a component of area >= npixels holding pixel p
    # has >= min(npixels, r + 1) det pixels within Chebyshev radius r of p
    # (path argument), so with r = npixels - 1 a box count >= npixels is
    # necessary — no false rejects; false accepts fall to the area filter
    r = npixels - 1
    if r > 0:
        dp = F.pad(det.to(torch.int32), (r, r, r, r))
        ii = F.pad(torch.cumsum(torch.cumsum(dp, 0), 1), (1, 0, 1, 0))
        s = 2 * r + 1
        box = (ii[s:s + H, s:s + W] - ii[:H, s:s + W]
               - ii[s:s + H, :W] + ii[:H, :W])
        det = det & (box >= npixels)
    return _local_max(x, det)


def _auto_threshold(img, nsigma):
    """median + nsigma * std of the sigma-clipped statistics (f32; a
    Python float operand is taken as float32, as ``jnp.float32(nsigma)``)."""
    _, med, std = sigma_clipped_stats_device(img)
    return med + std * float(nsigma)


def _count_candidates_auto(img, *, nsigma, npixels):
    """The program ``cat_count``: (candidate count, derived threshold),
    the first stage of the two-stage finder, whose small result sizes the
    second stage's candidate batch."""
    thr = _auto_threshold(img, nsigma)
    return _candidate_mask(img, thr, npixels).sum(), thr


def _count_candidates(img, threshold, *, npixels):
    """The program ``cat_count_thr``: the candidate count at a given
    threshold (a 0-d float32 tensor)."""
    return _candidate_mask(img, threshold, npixels).sum()


def _top(score, k):
    """(values, indices) of the ``k`` largest entries along the last axis,
    equal values lower index first (``lax.top_k``'s order)."""
    srt = torch.sort(score, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def _find_sources_peaks_core(img, threshold, *, max_sources, npixels,
                             window, deblend_nthresh=32,
                             deblend_cont=0.005):
    """Detection, ``peaks`` method (module docstring): the program
    ``cat_peaks``.

    Returns ``(seg_rank int32 (H, W), packed f32 (14, max_sources),
    n_cand)``. ``seg_rank`` holds 1-based brightness ranks (1 brightest,
    0 background); ``packed`` rows are keep, area, flux, cx, cy, peak,
    xmin, xmax, ymin, ymax, n_cand, peak_y, peak_x and the truncation flag
    (the measured bbox touches its window), so the host fetches the table
    in one copy.
    """
    H, W = img.shape
    dev = img.device
    B, win = max_sources, window
    finite = torch.isfinite(img)
    x = torch.where(finite, img, -torch.inf)
    pk = _candidate_mask(img, threshold, npixels)
    n_cand = pk.sum()

    # brightest-first candidate selection
    vals, flat = _top(torch.where(pk, x, -torch.inf).reshape(-1), B)
    valid = vals > -torch.inf
    py = flat // W
    px = flat % W
    y0 = torch.clamp(py - win // 2, 0, max(H - win, 0))
    x0 = torch.clamp(px - win // 2, 0, max(W - win, 0))

    # one batched window gather; det and local maxima recomputed from it
    ar = torch.arange(win, device=dev)
    rows = y0[:, None] + ar[None, :]                     # (B, win)
    cols = x0[:, None] + ar[None, :]
    wimg = img[rows[:, :, None], cols[:, None, :]]       # (B, win, win)
    wfin = torch.isfinite(wimg)
    wdet = wfin & (wimg > threshold)
    wx = torch.where(wfin, wimg, -torch.inf)
    above = wimg - threshold

    # flood fill (8-connected) from the peak over the in-window det mask
    seed = ((ar[None, :, None] == (py - y0)[:, None, None])
            & (ar[None, None, :] == (px - x0)[:, None, None]))
    grow = _flood(seed, wdet)

    # dedup: a peak whose in-window component holds a strictly brighter
    # pixel belongs to that brighter bump's source (unless the deblender
    # below separates it); equal twin peaks keep only the raster-first
    own = vals[:, None, None]
    brighter = (grow & (wx > own)).any((1, 2))
    wpk = _local_max(wx, wdet)
    wflat = rows[:, :, None] * W + cols[:, None, :]
    eq_twin = (grow & wpk & (wx == own)
               & (wflat < flat[:, None, None])).any((1, 2))

    # --- window-scale multi-threshold deblending ----------------------- #
    # the host deblender's exponential ladder between the threshold and
    # the component peak: a merged candidate becomes its own source at the
    # lowest level where its flood region (a) holds no other in-component
    # local maximum and (b) it and the rest of the component both carry
    # > deblend_cont of the component's flux; it is measured on that
    # region. The levels' floods are independent, so they run batched and
    # "the lowest level where it holds" is read off afterwards.
    base_flux = torch.where(grow, above, 0.0).sum((1, 2))
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    region = grow
    if deblend_nthresh > 1 and deblend_cont < 1.0:
        oth_core = torch.zeros_like(grow)
        others = grow & wpk & (wflat != flat[:, None, None])
        comp_peak = torch.where(grow, wx, -torch.inf).amax((1, 2))
        tot_safe = torch.where(base_flux > 0, base_flux, 1.0)
        pos = threshold > 0
        ratio = torch.where(pos, comp_peak / torch.where(pos, threshold, 1.0),
                            1.0)
        K = int(deblend_nthresh)
        levs = []
        for k in range(1, K):
            s_k = k / K
            frac_k = float(np.expm1(4.0 * s_k) / np.expm1(4.0))
            # geometric ladder for positive thresholds (SExtractor),
            # additive-exponential otherwise (host deblender parity)
            levs.append(torch.where(
                pos, threshold * torch.pow(torch.clamp(ratio, min=1e-20), s_k),
                threshold + (comp_peak - threshold) * frac_k))
        levs = torch.stack(levs)                         # (K-1, B)
        chunk = max(1, _FLOOD_BUDGET // (B * win * win))
        ib = torch.arange(B, device=dev)
        for k0 in range(0, K - 1, chunk):
            lev = levs[k0:k0 + chunk]
            L = lev.shape[0]
            mask = grow[None] & (wx[None] > lev[:, :, None, None])
            R = _flood(seed.expand(L, -1, -1, -1).reshape(L * B, win, win),
                       mask.reshape(L * B, win, win)).reshape(mask.shape)
            sep = ~(R & others).any((2, 3)) & R.any((2, 3))
            f_self = torch.where(R, above, 0.0).sum((2, 3)) / tot_safe
            f_other = torch.where(mask & ~R, above, 0.0).sum(
                (2, 3)) / tot_safe
            ok = sep & (f_self > deblend_cont) & (f_other > deblend_cont)
            new = ok & ~found
            hit = new.any(0)
            first = new.to(torch.float32).argmax(0)      # lowest such level
            Rf = R[first, ib]
            region = torch.where(hit[:, None, None], Rf, region)
            oth_core = torch.where(hit[:, None, None], mask[first, ib] & ~Rf,
                                   oth_core)
            found = found | ok.any(0)

        # euclidean nearest-seed skirt assignment (host parity): every
        # component pixel joins the child whose seed is nearest. This
        # candidate's seed is its separated core's flux-weighted centroid;
        # the other children's seeds are the other in-component local
        # maxima above the split level, refined by a 3x3 flux-weighted
        # centroid
        rf = ar.to(torch.float32)
        rowy = rf[None, :, None] + torch.zeros((1, 1, win), device=dev)
        colx = rf[None, None, :] + torch.zeros((1, win, 1), device=dev)
        selfw = torch.where(region, above, 0.0)
        sf = selfw.sum((1, 2))
        sf = torch.where(sf > 0, sf, 1.0)
        scy = (selfw * rowy).sum((1, 2)) / sf
        scx = (selfw * colx).sum((1, 2)) / sf
        dy_ = rowy - scy[:, None, None]
        dx_ = colx - scx[:, None, None]
        d2self = dy_ * dy_ + dx_ * dx_
        oseed = others & oth_core
        w3 = torch.where(wdet, above, 0.0)
        ny3 = w3 * rowy
        nx3 = w3 * colx
        s3, sy3, sx3 = w3, ny3, nx3
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    s3 = s3 + _shift(w3, dy, dx, 0.0)
                    sy3 = sy3 + _shift(ny3, dy, dx, 0.0)
                    sx3 = sx3 + _shift(nx3, dy, dx, 0.0)
        s3s = torch.where(s3 > 0, s3, 1.0)
        # up to S other seeds per window, brightest first
        S = min(8, win * win)
        ovals, oflat = _top(torch.where(oseed, wx, -torch.inf).reshape(B, -1),
                            S)
        ohas = ovals > -torch.inf
        seedy = torch.where(ohas, torch.gather((sy3 / s3s).reshape(B, -1), 1,
                                               oflat), 0.0)
        seedx = torch.where(ohas, torch.gather((sx3 / s3s).reshape(B, -1), 1,
                                               oflat), 0.0)
        d2o = torch.full_like(d2self, 1e9)
        for j in range(S):
            ey = rowy - seedy[:, j, None, None]
            ex = colx - seedx[:, j, None, None]
            d2o = torch.minimum(d2o, torch.where(ohas[:, j, None, None],
                                                 ey * ey + ex * ex, 1e9))
        region = torch.where(found[:, None, None], grow & (d2self <= d2o),
                             region)

    # the moments sum in float64 (the JAX package sums in float32): a
    # centroid then does not depend on the device's summation order, to
    # the float32 rounding of the result
    data = torch.where(region, above, 0.0).to(torch.float64)
    absy = rows[:, :, None].to(torch.float32) + torch.zeros((1, 1, win),
                                                            device=dev)
    absx = cols[:, None, :].to(torch.float32) + torch.zeros((1, win, 1),
                                                            device=dev)
    area = region.sum((1, 2)).to(torch.float32)
    flux = data.sum((1, 2))
    safe = torch.where(flux > 0, flux, 1.0)
    cx = ((data * absx).sum((1, 2)) / safe).to(torch.float32)
    cy = ((data * absy).sum((1, 2)) / safe).to(torch.float32)
    flux = flux.to(torch.float32)
    big = float(H * W)
    xmin = torch.where(region, absx, big).amin((1, 2))
    ymin = torch.where(region, absy, big).amin((1, 2))
    xmax = torch.where(region, absx, -1.0).amax((1, 2))
    ymax = torch.where(region, absy, -1.0).amax((1, 2))

    keep = valid & (area >= npixels) & (~brighter | found) & ~eq_twin

    # segmentation plane: 1-based brightness ranks scattered over each
    # kept source's final region, the brighter (smaller rank) winning
    # overlaps — a windowed scatter-min
    rank = torch.arange(1, B + 1, dtype=torch.int32, device=dev)
    BIGI = B + 2
    upd = torch.where(region & keep[:, None, None], rank[:, None, None],
                      BIGI)
    seg = torch.full((H * W,), BIGI, dtype=torch.int32, device=dev)
    seg.scatter_reduce_(0, wflat.reshape(-1), upd.reshape(-1), "amin",
                        include_self=True)
    seg = torch.where(seg == BIGI, 0, seg).reshape(H, W)

    # truncation flag: the measured bbox touches its window border, so the
    # footprint may continue outside (drives the window escalation)
    y0f = y0.to(torch.float32)
    x0f = x0.to(torch.float32)
    touch = ((xmin <= x0f) | (xmax >= x0f + win - 1)
             | (ymin <= y0f) | (ymax >= y0f + win - 1))
    packed = torch.stack([
        keep.to(torch.float32), area, flux, cx, cy, vals - threshold,
        xmin, xmax, ymin, ymax,
        n_cand.to(torch.float32).expand(B),
        py.to(torch.float32), px.to(torch.float32), touch.to(torch.float32),
    ])
    return seg, packed, n_cand


def _find_sources_peaks_fused(img, *, nsigma, max_sources, npixels, window,
                              deblend_nthresh=32, deblend_cont=0.005):
    """The program ``cat_find``: the sigma-clipped threshold and the peaks
    detection in one program, the threshold never read by the host.
    Returns (seg_rank, packed, n_cand, threshold)."""
    thr = _auto_threshold(img, nsigma)
    seg, packed, n_cand = _find_sources_peaks_core(
        img, thr, max_sources=max_sources, npixels=npixels, window=window,
        deblend_nthresh=deblend_nthresh, deblend_cont=deblend_cont)
    return seg, packed, n_cand, thr


def _remap_ranks(seg, lut):
    """The program ``cat_remap``: rank plane -> catalog-id plane (0 stays
    the background)."""
    return lut[seg.long()]


def _peaks_dims(shape, max_sources, window):
    """(B, win) actually run for an (H, W) image."""
    H, W = shape
    return int(min(max_sources, H * W)), max(2, min(window, H, W))


def _core_statics(shape, max_sources, npixels, window, deblend_nthresh,
                  deblend_cont) -> dict:
    """The statics of ``cat_peaks`` (and, with ``nsigma``, ``cat_find``)
    for an (H, W) image: the batch and window actually run."""
    B, win = _peaks_dims(shape, max_sources, window)
    return dict(max_sources=B, npixels=int(npixels), window=win,
                deblend_nthresh=int(deblend_nthresh),
                deblend_cont=float(deblend_cont))


def _warm(name, fn, args, statics=None):
    """The executable of program ``name`` for ``args``, captured on a card
    by a first call on ``args`` (:func:`aot.ensure_captured`)."""
    exe = get_executable(name, fn, args, statics=statics)
    ensure_captured(exe, *args)
    return exe


def _peaks_executables(shape, *, nsigma: float, npixels: int, window: int,
                       max_sources: int, deblend_nthresh: int,
                       deblend_cont: float, want_fused: bool = True,
                       device="cuda"):
    """The (fused, peaks, remap) executables for an (H, W) image on
    ``device`` (``fused`` None unless ``want_fused``): the programs
    ``cat_find`` (the threshold derived inside), ``cat_peaks`` (an
    explicit threshold) and ``cat_remap``, from
    :func:`~subpixal_tpu_torch.aot.get_executable`, each captured on a
    card by a first call on zero inputs of the shape."""
    H, W = shape
    core = _core_statics(shape, max_sources, npixels, window,
                         deblend_nthresh, deblend_cont)
    img = torch.zeros((H, W), dtype=torch.float32, device=device)
    thr = torch.zeros((), dtype=torch.float32, device=device)
    fused = None
    if want_fused:
        fused = _warm("cat_find", _find_sources_peaks_fused, (img,),
                      dict(nsigma=float(nsigma), **core))
    peaks = _warm("cat_peaks", _find_sources_peaks_core, (img, thr), core)
    remap = _warm(
        "cat_remap", _remap_ranks,
        (torch.zeros((H, W), dtype=torch.int32, device=device),
         torch.zeros(core["max_sources"] + 1, dtype=torch.int32,
                     device=device)))
    return fused, peaks, remap


def warm_compile(shape, *, nsigma: float = 3.0, npixels: int = 5,
                 window: int = 32, max_sources: int = 8192,
                 deblend_nthresh: int = 32, deblend_cont: float = 0.005,
                 device="cuda") -> None:
    """Capture the ``peaks`` finder's programs for an (H, W) image on
    ``device`` ahead of its first call, as the JAX package compiles them:
    with more than 256 candidate slots, the counting program and the
    second stage at the 128 and 256 buckets (what a scene of up to ~250
    candidates takes); else the programs at ``max_sources``. Each is
    captured by a first call on zero inputs; a program already captured
    is not run. ``align_images`` calls it before its first deposit. On
    the CPU it only fills the cache with the plain functions."""
    B_full, _ = _peaks_dims(shape, max_sources, window)
    kw = dict(nsigma=nsigma, npixels=npixels, window=window,
              deblend_nthresh=deblend_nthresh, deblend_cont=deblend_cont,
              device=device)
    if B_full > 256:
        _warm("cat_count", _count_candidates_auto,
              (torch.zeros(tuple(shape), dtype=torch.float32,
                           device=device),),
              dict(nsigma=float(nsigma), npixels=int(npixels)))
        for b in (128, 256):
            _peaks_executables(shape, max_sources=b, want_fused=False, **kw)
    else:
        _peaks_executables(shape, max_sources=max_sources, **kw)


def find_sources_device(image, threshold: float | None = None,
                        nsigma: float = 3.0, npixels: int = 5,
                        connectivity: int = 8, max_sources: int = 8192,
                        method: str = "auto", window: int = 32,
                        deblend_nthresh: int = 32,
                        deblend_cont: float = 0.005, device="cuda"):
    """Device analogue of :func:`subpixal_tpu_torch.catalogs.find_sources`.

    ``image`` is a tensor (detection runs on its device) or an array
    (copied to ``device``, the card by default). Returns ``(Table,
    seg_id_plane)``: a host table with the host finder's columns and an
    int32 (H, W) plane of catalog ``id`` values (0 = background) on the
    image's device.

    ``method``: ``'peaks'`` (the default through ``'auto'``) — brightest
    first, windowed measurement with in-window deblending
    (``deblend_nthresh=1`` disables it); a ``max_sources`` overflow drops
    the faintest candidates. ``'ccl'`` — exact component topology.
    """
    if method not in ("auto", "peaks", "ccl"):
        raise ValueError(
            f"method must be 'auto'|'peaks'|'ccl', got {method!r}")
    img = _as_image(image, device)
    dev = img.device
    H, W = img.shape
    if method == "ccl":
        thr = (_auto_threshold(img, nsigma) if threshold is None
               else torch.tensor(threshold, dtype=torch.float32,
                                 device=dev))
        return _find_sources_ccl(img, thr, npixels, connectivity,
                                 max_sources)

    B, win = _peaks_dims((H, W), max_sources, window)
    if B > 256:
        # two-stage sizing: count the candidates (one small copy to the
        # host), then run detection with its batch bucketed to that count
        # rather than max_sources. The result is identical (the batch
        # holds every candidate, at the same threshold); the deblend's
        # (levels, B, win, win) floods stay small
        if threshold is None:
            cnt, thr = get_executable(
                "cat_count", _count_candidates_auto, (img,),
                statics=dict(nsigma=float(nsigma), npixels=int(npixels)))(img)
            n_est, thr_v = to_host(torch.stack([
                cnt.to(torch.float64), thr.to(torch.float64)])).tolist()
            threshold = thr_v        # the f32 value, exactly
        else:
            thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
            n_est = int(to_host(get_executable(
                "cat_count_thr", _count_candidates, (img, thr),
                statics=dict(npixels=int(npixels)))(img, thr)))
        b_eff = 128
        while b_eff < n_est + 8:
            b_eff *= 2
        if b_eff < B:
            max_sources = b_eff
            B, win = _peaks_dims((H, W), max_sources, window)
    # the programs warm_compile captures for this shape, on this image
    core = _core_statics((H, W), max_sources, npixels, window,
                         deblend_nthresh, deblend_cont)
    if threshold is None:  # one program: threshold and detection
        seg_rank, packed, _, _ = get_executable(
            "cat_find", _find_sources_peaks_fused, (img,),
            statics=dict(nsigma=float(nsigma), **core))(img)
    else:
        thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
        seg_rank, packed, _ = get_executable(
            "cat_peaks", _find_sources_peaks_core, (img, thr),
            statics=core)(img, thr)
    arr = to_host(packed).numpy()  # the one device -> host table copy
    keep = arr[0] > 0
    n_cand = int(arr[10, 0])
    if n_cand > B:
        warnings.warn(
            f"device source finder capped at {B} sources; the "
            f"{n_cand - B} FAINTEST candidates were dropped — "
            "raise max_sources to keep them", stacklevel=2)
    sl = np.nonzero(keep)[0]
    # window escalation: a kept source whose bbox touches its window was
    # truncated by it — re-run with the window doubled (an explicit
    # threshold is reused, a derived one recomputed identically) until
    # every footprint fits or the window reaches min(H, W, 256); the
    # candidate count is known, so the batch is capped at it
    win_cap = min(H, W, 256)
    if len(sl) and (arr[13][sl] > 0).any() and win < win_cap:
        b2 = min(max_sources, max(64, -(-(n_cand + 8) // 64) * 64))
        return find_sources_device(
            img, threshold=threshold, nsigma=nsigma, npixels=npixels,
            connectivity=connectivity, max_sources=b2, method=method,
            window=min(2 * win, win_cap), deblend_nthresh=deblend_nthresh,
            deblend_cont=deblend_cont)
    ids = np.arange(1, len(sl) + 1, dtype=np.int32)
    cat = Table({
        "id": ids,
        "x": arr[3][sl].astype(np.float64),
        "y": arr[4][sl].astype(np.float64),
        "flux": arr[2][sl].astype(np.float64),
        "area": arr[1][sl].astype(np.int64),
        "peak": arr[5][sl],
        "xmin": arr[6][sl].astype(np.int64),
        "xmax": arr[7][sl].astype(np.int64),
        "ymin": arr[8][sl].astype(np.int64),
        "ymax": arr[9][sl].astype(np.int64),
    })
    # rank plane -> catalog-id plane (kept ranks only)
    lut = np.zeros(B + 1, np.int32)
    lut[sl + 1] = ids
    lut_t = torch.as_tensor(lut, device=dev)
    return cat, get_executable("cat_remap", _remap_ranks,
                               (seg_rank, lut_t))(seg_rank, lut_t)


def _find_sources_ccl(img, thr, npixels, connectivity, max_sources):
    """The ``ccl`` method's host side: one table copy, filters, ids."""
    seg, table, n_comp, n_overflow = _find_sources_core(
        img, thr, connectivity=connectivity, max_sources=max_sources)
    cols = ("area", "flux", "cx", "cy", "peak", "xmin", "xmax", "ymin",
            "ymax")
    host = dict(zip(cols, to_host(torch.stack([table[k] for k in cols]))
                    .numpy()))
    n_comp, n_over = to_host(torch.stack([n_comp, n_overflow])).tolist()
    if n_over:
        warnings.warn(
            f"device source finder capped at {max_sources} sources "
            f"({n_over} dropped); raise max_sources", stacklevel=3)
    n = min(n_comp, max_sources)
    keep = host["area"][1:n + 1] >= npixels
    ids = np.nonzero(keep)[0].astype(np.int32) + 1   # rows are id-indexed
    cat = Table({
        "id": ids,
        "x": host["cx"][ids],
        "y": host["cy"][ids],
        "flux": host["flux"][ids].astype(np.float64),
        "area": host["area"][ids].astype(np.int64),
        "peak": host["peak"][ids],
        "xmin": host["xmin"][ids].astype(np.int64),
        "xmax": host["xmax"][ids].astype(np.int64),
        "ymin": host["ymin"][ids].astype(np.int64),
        "ymax": host["ymax"][ids].astype(np.int64),
    })
    if not keep.all() or n < n_comp:
        keep_lut = np.zeros(max_sources + 1, bool)
        keep_lut[ids] = True
        seg = _apply_keep(seg, torch.as_tensor(keep_lut, device=img.device))
    return cat, seg


class DeviceSourceCatalog(ImageCatalog):
    """:class:`ImageCatalog` whose finder runs on the device; its
    segmentation plane stays there (``segmentation_device``).

    ``align_images``'s default catalog on CUDA (``catalogs=None``,
    ``device_catalog='auto'``), where the drizzled reference is already on
    the card. ``.segmentation`` copies the plane to the host only when
    asked, once.
    """

    def __init__(self, image, threshold: float | None = None,
                 nsigma: float = 3.0, npixels: int = 5,
                 connectivity: int = 8, max_sources: int = 8192,
                 method: str = "auto", window: int = 32, device="cuda"):
        super().__init__()
        self._image = image
        self.threshold = threshold
        self.nsigma = nsigma
        self.npixels = npixels
        self.connectivity = connectivity
        self.max_sources = max_sources
        self.method = method
        self.window = window
        self.device = device
        self.segmentation_device = None

    def execute(self) -> None:
        cat, seg = find_sources_device(
            self._image, threshold=self.threshold, nsigma=self.nsigma,
            npixels=self.npixels, connectivity=self.connectivity,
            max_sources=self.max_sources, method=self.method,
            window=self.window, device=self.device)
        self._rawcat = cat
        self.segmentation_device = seg
        self._seg_host = None  # the memoized host view is stale

    @property
    def segmentation(self):  # the host view, on demand only
        if getattr(self, "_seg_host", None) is not None:
            return self._seg_host
        if self.segmentation_device is None and self._rawcat is None:
            self.execute()
        if self.segmentation_device is None:
            return None
        self._seg_host = to_host(self.segmentation_device).numpy()
        return self._seg_host

    @segmentation.setter
    def segmentation(self, value):  # the base class's __init__ sets it
        self._seg_host = value
