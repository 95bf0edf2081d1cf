"""Plain reference of ``align_images``: the same alignment, written from its
documented semantics in plain torch (float64 by default, any device).

It imports nothing of the program and takes nothing the program made: it
builds the output grid, the pixmaps, the initial drizzle, the source
catalog, the cutouts and their geometry from the host frames and their
WCS parameters, then runs the fixed point (re-drizzle with the current
corrections, blot at the cutouts, masked NCC, peak fit, sigma-clipped
linear fit per exposure, composition) for a given number of iterations,
recording the state after each.

What it covers is the path the benchmark's cells run: TAN frames, the
square kernel, ``poly5`` blots, NCC, ``peak_search_box='fitbox'``, the
quadratic and Gaussian peak fits, ``usfac`` 1 (surface) and > 1 (matrix
DFT), ``fitgeom`` 'shift' and 'general', ``wcsupdate`` 'batch' and 'otf';
it raises on any other setting that would change the arithmetic
(``match_sky``, ``static_mask``, ``reject_cr`` and the like), and on a
primary footprint larger than the cutout (it has no oversized bucket).
A configuration names its reference by its key ``"reference"`` (this
module without it); another reference is a module under ``portbench/``
with ``Tan``, ``output_grid``, ``DEFAULTS`` and ``align``.
Its catalog is the connected components above the threshold, without
deblending (the program's finder deblends blends; on these scenes that
changes a few sources at most).

Geometry (WCS chains, Jacobians, window origins) is float64 on the host
side, as the program's host geometry; the pixel pipeline runs in
``dtype``. ``dtype=torch.float32`` under TF32 is the control that the
benchmark's comparison has to fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64
D2R = math.pi / 180.0

#: the program's documented ``AlignConfig`` defaults that this reference
#: reads (a cell's traffic file overrides some of them)
DEFAULTS = dict(cc_type="NCC", fitgeom="general", nclip=3, sigma=3.0,
                use_weights=True, combine_seg_mask=True, wcsupdate="batch",
                max_iterations=10, eps_shift=0.004, usfac=1, peak_fit_box=5,
                peak_search_box="fitbox", fit_type="quadratic",
                interp="poly5", max_cut_size=128, pixfrac=1.0,
                kernel="square", catalog_nsigma=3.0, catalog_npixels=5)
#: settings that choose where or how the program computes, not what: the
#: reference takes them and reads none
PLACEMENT = frozenset({"history", "verbose", "use_pallas", "sparse_deposit",
                       "cutout_pixmaps", "device_loop", "device_catalog",
                       "min_sources"})
#: the program's stages this reference does not implement, each taken
#: only where it is off
NOT_IMPLEMENTED = dict(match_sky=False, static_mask=False, reject_cr=False)


def check_settings(settings: dict) -> None:
    """Raise ``ValueError`` on a setting that this reference does not
    implement and that would change what the program computes: a stage
    of :data:`NOT_IMPLEMENTED` switched on, or a key neither in
    :data:`DEFAULTS` nor in :data:`PLACEMENT`."""
    for key, value in settings.items():
        if key in DEFAULTS or key in PLACEMENT or (
                key in NOT_IMPLEMENTED and value == NOT_IMPLEMENTED[key]):
            continue
        raise ValueError(f"the reference does not implement {key}={value!r}")


class Tan:
    """Gnomonic WCS without distortion: 0-based ``crpix``, ``crval``
    (RA, Dec) and ``cd`` in degrees; float64 torch on any device."""

    def __init__(self, crpix, crval, cd):
        self.crpix = np.asarray(crpix, np.float64)
        self.crval = np.asarray(crval, np.float64)
        self.cd = np.asarray(cd, np.float64)

    @property
    def pscale(self) -> float:
        return float(np.sqrt(abs(np.linalg.det(self.cd))) * 3600.0)

    def pix2world(self, x, y):
        u, v = x - self.crpix[0], y - self.crpix[1]
        xi = (self.cd[0, 0] * u + self.cd[0, 1] * v) * D2R
        eta = (self.cd[1, 0] * u + self.cd[1, 1] * v) * D2R
        ra0, dec0 = self.crval * D2R
        den = math.cos(dec0) - eta * math.sin(dec0)
        ra = ra0 + torch.atan2(xi, den)
        dec = torch.atan2(math.sin(dec0) + eta * math.cos(dec0),
                          torch.sqrt(xi * xi + den * den))
        return ra / D2R, dec / D2R

    def world2pix(self, ra, dec):
        ra0, dec0 = self.crval * D2R
        a, d = ra * D2R - ra0, dec * D2R
        den = (torch.sin(d) * math.sin(dec0)
               + torch.cos(d) * math.cos(dec0) * torch.cos(a))
        xi = torch.cos(d) * torch.sin(a) / den / D2R
        eta = (torch.sin(d) * math.cos(dec0)
               - torch.cos(d) * math.sin(dec0) * torch.cos(a)) / den / D2R
        inv = np.linalg.inv(self.cd)
        return (inv[0, 0] * xi + inv[0, 1] * eta + self.crpix[0],
                inv[1, 0] * xi + inv[1, 1] * eta + self.crpix[1])


def output_grid(frames_wcs, shapes):
    """North-up TAN grid at the mean sky position covering every frame,
    at the frames' mean pixel scale, one pixel of margin: (Tan, (H, W))."""
    c = np.radians(np.array([w.crval for w in frames_wcs]))
    vec = np.stack([np.cos(c[:, 1]) * np.cos(c[:, 0]),
                    np.cos(c[:, 1]) * np.sin(c[:, 0]),
                    np.sin(c[:, 1])], 1).mean(0)
    vec /= np.linalg.norm(vec)
    crval = np.array([np.degrees(np.arctan2(vec[1], vec[0])) % 360.0,
                      np.degrees(np.arcsin(vec[2]))])
    s = float(np.mean([w.pscale for w in frames_wcs])) / 3600.0
    grid = Tan(np.zeros(2), crval, [[-s, 0.0], [0.0, s]])
    xs, ys = [], []
    for w, (H, W) in zip(frames_wcs, shapes):
        cx = torch.tensor([0.0, W - 1.0, 0.0, W - 1.0], dtype=F64)
        cy = torch.tensor([0.0, 0.0, H - 1.0, H - 1.0], dtype=F64)
        px, py = grid.world2pix(*w.pix2world(cx, cy))
        xs.append(px)
        ys.append(py)
    xs, ys = torch.cat(xs), torch.cat(ys)
    x0, x1 = math.floor(xs.min()) - 1, math.ceil(xs.max()) + 1
    y0, y1 = math.floor(ys.min()) - 1, math.ceil(ys.max()) + 1
    return (Tan(np.array([-x0, -y0], np.float64), crval, grid.cd),
            (int(y1 - y0 + 1), int(x1 - x0 + 1)))


def deposit(data, weight, px, py, out_shape, pixfrac=1.0, ratio=1.0):
    """Square-kernel drizzle of (E, H, W) frames whose pixel centers land
    at (px, py) on the grid: each pixel a square of side pixfrac·ratio
    centered there, its flux and weight (``weight`` (E,) per frame)
    shared by area over the cells it overlaps. Returns the summed
    (sci·wht, wht) accumulators (Ho, Wo)."""
    Ho, Wo = out_shape
    dt, dev = data.dtype, data.device
    half = 0.5 * pixfrac * ratio
    K = int(math.ceil(2.0 * half)) + 1
    sci = torch.zeros(Ho * Wo + 1, dtype=dt, device=dev)
    wht = torch.zeros(Ho * Wo + 1, dtype=dt, device=dev)
    w = weight.to(dt)[:, None, None].expand_as(data)
    c0x = torch.floor(px - half + 0.5)
    c0y = torch.floor(py - half + 0.5)
    for dy in range(K):
        cy = c0y + dy
        oy = (torch.minimum(py + half, cy + 0.5)
              - torch.maximum(py - half, cy - 0.5)).clamp(min=0)
        for dx in range(K):
            cx = c0x + dx
            ox = (torch.minimum(px + half, cx + 0.5)
                  - torch.maximum(px - half, cx - 0.5)).clamp(min=0)
            a = w * ox * oy / (4.0 * half * half)
            ok = (cx >= 0) & (cx < Wo) & (cy >= 0) & (cy < Ho)
            idx = torch.where(ok, cy * Wo + cx,
                              torch.full_like(cx, Ho * Wo)).long()
            a = torch.where(ok, a, torch.zeros_like(a))
            sci.index_add_(0, idx.reshape(-1), (a * data).reshape(-1))
            wht.index_add_(0, idx.reshape(-1), a.reshape(-1))
    return sci[:-1].reshape(Ho, Wo), wht[:-1].reshape(Ho, Wo)


def combine(sci, wht):
    good = wht > 0
    return torch.where(good, sci / torch.where(good, wht, 1.0), 0.0)


def clipped_stats(img, sigma=3.0, maxiters=5):
    """(mean, median, std) of the finite pixels, clipped ``maxiters``
    times to median +- sigma·std (float64)."""
    x = img[torch.isfinite(img)].to(F64).reshape(-1)
    s = torch.sort(x).values
    lo, hi = 0, s.numel()

    def stats(lo, hi):
        seg = s[lo:hi]
        n = seg.numel()
        med = 0.5 * (seg[(n - 1) // 2] + seg[n // 2])
        return seg.mean(), med, seg.std(correction=0)

    for _ in range(maxiters):
        _, med, std = stats(lo, hi)
        lo = int(torch.searchsorted(s, (med - sigma * std).reshape(1))[0])
        hi = min(int(torch.searchsorted(s, (med + sigma * std).reshape(1),
                                        right=True)[0]), s.numel())
        hi = max(hi, lo + 1)
    return tuple(float(v) for v in stats(lo, hi))


#: a pixel's 8 neighbours before and after it in raster order
_EARLIER = ((-1, -1), (-1, 0), (-1, 1), (0, -1))
_LATER = ((0, 1), (1, -1), (1, 0), (1, 1))


def _shifted(a, dy, dx, fill):
    """``a`` with ``out[y, x] = a[y + dy, x + dx]`` (``fill`` outside)."""
    h, w = a.shape
    out = np.full_like(a, fill)
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        a[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def _local_max(x, det):
    """``det`` pixels above their earlier raster neighbours and not below
    their later ones (a plateau keeps its raster-first pixel)."""
    pk = det.copy()
    for dy, dx in _EARLIER:
        pk &= x > _shifted(x, dy, dx, -np.inf)
    for dy, dx in _LATER:
        pk &= x >= _shifted(x, dy, dx, -np.inf)
    return pk


def _flood(seed, mask):
    """8-connected region of ``mask`` holding pixel ``seed`` (y, x)."""
    out = np.zeros_like(mask)
    if not mask[seed]:
        return out
    h, w = mask.shape
    stack = [seed]
    out[seed] = True
    while stack:
        y, x = stack.pop()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                v, u = y + dy, x + dx
                if 0 <= v < h and 0 <= u < w and mask[v, u] and not out[v, u]:
                    out[v, u] = True
                    stack.append((v, u))
    return out


def _labels(det):
    """(H, W) labels of the 8-connected components of ``det`` (a
    component's label: its largest flat index; -1 off ``det``)."""
    H, W = det.shape
    idx = torch.arange(H * W, dtype=F64, device=det.device).reshape(H, W)
    ninf = torch.full_like(idx, -math.inf)
    lab = torch.where(det, idx, ninf)
    while True:
        nxt = lab
        for _ in range(8):
            nxt = torch.where(
                det, F.max_pool2d(nxt[None, None], 3, 1, 1)[0, 0], ninf)
        if torch.equal(nxt, lab):
            return torch.where(det, lab, -1.0).long()
        lab = nxt


def _deblend(x, above, comp, peaks, thr, nthresh=32, cont=0.005):
    """The regions of one component's candidate peaks (SExtractor-style
    multi-threshold deblending): a candidate that is not the component's
    brightest pixel becomes a source only at the lowest level of the
    exponential ladder between the threshold and the component's peak
    where its flood region holds no other local maximum of the component
    and it and the rest each carry more than ``cont`` of the component's
    flux. A separated candidate takes the component pixels nearer its
    core's flux centroid than any other branch's seed. Returns
    [(region or None, separated)] in ``peaks``' order."""
    lmax = _local_max(x, comp)
    total = above[comp].sum()
    cpeak = x[comp].max()
    ratio = cpeak / thr if thr > 0 else 1.0
    h, w = x.shape
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    w3 = np.where(comp, above, 0.0)
    s3 = sum(_shifted(w3, dy, dx, 0.0) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1))
    sy3 = sum(_shifted(w3 * gy, dy, dx, 0.0) for dy in (-1, 0, 1)
              for dx in (-1, 0, 1))
    sx3 = sum(_shifted(w3 * gx, dy, dx, 0.0) for dy in (-1, 0, 1)
              for dx in (-1, 0, 1))
    out = []
    for p in peaks:
        others = lmax.copy()
        others[p] = False
        found = None
        for k in range(1, nthresh):
            s_k = k / nthresh
            lev = (thr * ratio ** s_k if thr > 0 else
                   thr + (cpeak - thr) * np.expm1(4 * s_k) / np.expm1(4.0))
            mask = comp & (x > lev)
            R = _flood(p, mask)
            if not R.any() or (R & others).any():
                continue
            f_self = above[R].sum() / total
            f_other = above[mask & ~R].sum() / total
            if f_self > cont and f_other > cont:
                found = (R, mask & ~R)
                break
        if found is None:
            out.append((None, False))
            continue
        R, oth_core = found
        wR = np.where(R, above, 0.0)
        cy, cx = (wR * gy).sum() / wR.sum(), (wR * gx).sum() / wR.sum()
        d_self = (gy - cy) ** 2 + (gx - cx) ** 2
        seeds = np.nonzero(others & oth_core)
        order = np.argsort(-x[seeds], kind="stable")[:8]
        d_oth = np.full_like(d_self, 1e9)
        for j in order:
            v, u = seeds[0][j], seeds[1][j]
            sy, sx = sy3[v, u] / s3[v, u], sx3[v, u] / s3[v, u]
            d_oth = np.minimum(d_oth, (gy - sy) ** 2 + (gx - sx) ** 2)
        out.append((comp & (d_self <= d_oth), True))
    return out


def find_sources(img, nsigma=3.0, npixels=5):
    """Sources of ``img``: the local maxima above median + nsigma·std of
    the clipped statistics (with at least ``npixels`` detected pixels
    within ``npixels - 1`` of them), each its 8-connected component of
    detected pixels, or its part of it where the deblender separates it
    (:func:`_deblend`); a peak below a brighter pixel of its component
    that is not separated, or a raster-later twin of an equal peak, is
    no source. Regions of fewer than ``npixels`` pixels are dropped;
    overlapping regions go to the brighter peak. Flux moments on image
    - threshold. Returns a dict of numpy columns (id, x, y, flux, xmin,
    xmax, ymin, ymax) and the (H, W) int64 segmentation plane (ids, 0 for
    the background)."""
    H, W = img.shape
    _, med, std = clipped_stats(img)
    thr = med + nsigma * std
    im = img.to(F64)
    det_t = torch.isfinite(im) & (im > thr)
    lab = _labels(det_t).cpu().numpy()
    x = torch.where(torch.isfinite(im), im, -math.inf).cpu().numpy()
    det = det_t.cpu().numpy()
    r = npixels - 1
    ii = np.pad(np.cumsum(np.cumsum(np.pad(det.astype(np.int64), r), 0), 1),
                ((1, 0), (1, 0)))
    s = 2 * r + 1
    box = ii[s:s + H, s:s + W] - ii[:H, s:s + W] - ii[s:s + H, :W] + ii[:H, :W]
    cand = _local_max(x, det & (box >= npixels))
    cy, cx = np.nonzero(cand)
    by_comp: dict = {}
    for v, u in zip(cy.tolist(), cx.tolist()):
        by_comp.setdefault(int(lab[v, u]), []).append((v, u))
    srcs = []  # (peak value, raster index, y0, x0, region, above)
    for L, peaks in by_comp.items():
        ys, xs = _component_pixels(lab, L, peaks[0])
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        comp = lab[y0:y1, x0:x1] == L
        xw = np.where(comp, x[y0:y1, x0:x1], -np.inf)
        above = np.where(comp, x[y0:y1, x0:x1] - thr, 0.0)
        local = [(v - y0, u - x0) for v, u in peaks]
        top = xw.max()
        if len(local) == 1:
            regions = [(comp, False)]
        else:
            regions = _deblend(xw, above, comp, local, thr)
        for (v, u), (reg, sep) in zip(local, regions):
            val = xw[v, u]
            brighter = val < top
            twin = any(xw[a, b] == val and (a, b) < (v, u)
                       for a, b in local if (a, b) != (v, u))
            if brighter and not sep or twin:
                continue
            reg = comp if reg is None else reg
            srcs.append((val, (v + y0) * W + (u + x0), y0, x0, reg, above))
    # brightest first; overlaps go to the brighter
    srcs.sort(key=lambda t: (-t[0], t[1]))
    seg = np.zeros((H, W), np.int64)
    cols = {k: [] for k in ("id", "x", "y", "flux", "xmin", "xmax", "ymin",
                            "ymax")}
    for val, _, y0, x0, reg, above in srcs:
        if reg.sum() < npixels:
            continue
        i = len(cols["id"]) + 1
        ry, rx = np.nonzero(reg)
        a = above[ry, rx]
        view = seg[y0:y0 + reg.shape[0], x0:x0 + reg.shape[1]]
        view[reg & (view == 0)] = i
        cols["id"].append(i)
        cols["flux"].append(a.sum())
        cols["x"].append((a * (rx + x0)).sum() / a.sum())
        cols["y"].append((a * (ry + y0)).sum() / a.sum())
        cols["xmin"].append(rx.min() + x0)
        cols["xmax"].append(rx.max() + x0)
        cols["ymin"].append(ry.min() + y0)
        cols["ymax"].append(ry.max() + y0)
    return ({k: np.asarray(v) for k, v in cols.items()},
            torch.as_tensor(seg, device=img.device))


def _component_pixels(lab, L, peak):
    """Pixels of component ``L`` near ``peak``, from a window around it
    that grows until the component does not touch its border."""
    H, W = lab.shape
    r = 32
    while True:
        y0, x0 = max(peak[0] - r, 0), max(peak[1] - r, 0)
        y1, x1 = min(peak[0] + r + 1, H), min(peak[1] + r + 1, W)
        ys, xs = np.nonzero(lab[y0:y1, x0:x1] == L)
        touch = ((ys.min() == 0 and y0 > 0) or (xs.min() == 0 and x0 > 0)
                 or (ys.max() == y1 - y0 - 1 and y1 < H)
                 or (xs.max() == x1 - x0 - 1 and x1 < W))
        if not touch or r >= max(H, W):
            return ys + y0, xs + x0
        r *= 2


def primary_boxes(cat, out_shape, pad=1, min_box=8, max_box=512):
    """(kept catalog rows, box shapes): each source's footprint box plus
    ``pad``, at least ``min_box`` a side, dropped past ``max_box`` or
    off the grid."""
    Hs, Ws = out_shape
    rows, shapes = [], []
    for k in range(len(cat["id"])):
        fy0, fy1 = int(cat["ymin"][k]), int(cat["ymax"][k])
        fx0, fx1 = int(cat["xmin"][k]), int(cat["xmax"][k])
        y0, x0 = fy0 - pad, fx0 - pad
        h, w = fy1 - y0 + 1 + pad, fx1 - x0 + 1 + pad
        if h < min_box or w < min_box:
            cy, cx = (fy0 + fy1) / 2, (fx0 + fx1) / 2
            h = w = max(h, w, min_box)
            y0 = int(round(cy)) - h // 2
            x0 = int(round(cx)) - w // 2
        if h > max_box or w > max_box:
            continue
        if y0 >= Hs or x0 >= Ws or y0 + h <= 0 or x0 + w <= 0:
            continue
        rows.append(k)
        shapes.append((h, w))
    return rows, shapes


def poly5(image, x, y):
    """``image`` sampled at (x, y) by separable 6-tap Lagrange
    interpolation (offsets -2..3 around floor); ``valid`` False where the
    footprint leaves the image (value 0 there)."""
    H, W = image.shape
    offs = (-2, -1, 0, 1, 2, 3)
    x0, y0 = torch.floor(x), torch.floor(y)

    def weights(t):
        ws = []
        for i, oi in enumerate(offs):
            w = torch.ones_like(t)
            for j, oj in enumerate(offs):
                if i != j:
                    w = w * (t - oj) / (oi - oj)
            ws.append(w)
        return ws

    wx, wy = weights(x - x0), weights(y - y0)
    xi, yi = x0.long(), y0.long()
    valid = (xi - 2 >= 0) & (xi + 3 < W) & (yi - 2 >= 0) & (yi + 3 < H)
    flat = image.reshape(-1)
    acc = torch.zeros_like(x)
    for i, oy in enumerate(offs):
        row = (yi + oy).clamp(0, H - 1) * W
        racc = torch.zeros_like(x)
        for j, ox in enumerate(offs):
            racc = racc + wx[j] * flat[row + (xi + ox).clamp(0, W - 1)]
        acc = acc + wy[i] * racc
    return torch.where(valid, acc, torch.zeros_like(acc)), valid


def _ncc_side(a, m):
    """Masked side of a normalized cross-correlation: the masked mean
    removed, scaled by the masked std and sqrt(N)."""
    a = a * m
    n = m.sum(dim=(-2, -1), keepdim=True).clamp(min=1.0)
    d = (a - a.sum(dim=(-2, -1), keepdim=True) / n) * m
    var = (d * d).sum(dim=(-2, -1), keepdim=True) / n
    return d / (torch.sqrt(var.clamp(min=1e-20)) * torch.sqrt(n))


def peak_fit(surf, k, fit_type, search=None):
    """Sub-pixel peak of each (B, n, m) surface: the first-index argmax
    (inside the ``search`` box (r0, r1, c0, c1) when given), then a
    weighted least-squares quadratic (``'gaussian'``: of the log of the
    box-max-normalised surface, weighted by it) over the k x k box around
    it, solved by its normal equations. Returns (x, y, value, ok)."""
    B, n, m = surf.shape
    dt, dev = surf.dtype, surf.device
    sr = surf
    if search is not None:
        r0, r1, c0, c1 = search
        rr = torch.arange(n, device=dev)[:, None]
        cc = torch.arange(m, device=dev)[None, :]
        inside = (rr >= r0) & (rr < r1) & (cc >= c0) & (cc < c1)
        sr = torch.where(inside, surf, torch.full_like(surf, -math.inf))
    flat = torch.argmax(sr.reshape(B, -1), dim=-1)
    iy, ix = flat // m, flat % m
    peak = sr.reshape(B, -1).amax(-1)
    r0 = torch.clamp(iy - k // 2, 0, n - k)
    c0 = torch.clamp(ix - k // 2, 0, m - k)
    o = torch.arange(k, device=dev)
    rows = (r0[:, None] + o[None])[:, :, None].expand(B, k, k)
    cols = (c0[:, None] + o[None])[:, None, :].expand(B, k, k)
    box = surf[torch.arange(B, device=dev)[:, None, None], rows, cols]
    c = (k - 1) / 2.0
    g = o.to(dt) - c
    gx = g[None, :].expand(k, k).reshape(-1)
    gy = g[:, None].expand(k, k).reshape(-1)
    X = torch.stack([torch.ones_like(gx), gx, gy, gx * gx, gx * gy, gy * gy],
                    1)                                          # (k², 6)
    flatbox = box.reshape(B, k * k)
    if fit_type == "gaussian":
        scale = flatbox.amax(-1, keepdim=True).clamp(min=1e-30)
        ratio = flatbox / scale
        z = torch.log(ratio.clamp(min=1e-8))
        w = ratio.clamp(0.0, 1.0)
    elif fit_type == "quadratic":
        z, w = flatbox, torch.ones_like(flatbox)
    else:
        raise ValueError(f"fit_type {fit_type!r}")
    XW = X[None] * w[:, :, None]                                # (B, k², 6)
    A = torch.einsum("bpi,pj->bij", XW, X) + 1e-8 * torch.eye(
        6, dtype=dt, device=dev)
    rhs = torch.einsum("bpi,bp->bi", XW, z)
    coef = torch.linalg.solve(A, rhs[..., None])[..., 0]
    c0_, c1, c2, c3, c4, c5 = coef.unbind(-1)
    det = 4.0 * c3 * c5 - c4 * c4
    sdet = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    px = (-2.0 * c5 * c1 + c4 * c2) / sdet
    py = (c4 * c1 - 2.0 * c3 * c2) / sdet
    ok = ((det > 0) & (c3 < 0) & (px.abs() <= c + 0.5) & (py.abs() <= c + 0.5)
          & torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(peak))
    v = c0_ + c1 * px + c2 * py + c3 * px * px + c4 * px * py + c5 * py * py
    if fit_type == "gaussian":
        v = torch.exp(v) * scale[:, 0]
    x = torch.where(ok, c0.to(dt) + c + px, ix.to(dt))
    y = torch.where(ok, r0.to(dt) + c + py, iy.to(dt))
    return x, y, torch.where(ok, v, peak), ok


def displacement(ref, img, mask, cfg):
    """(dx, dy, peak, ok) of ``img`` against ``ref`` (B, h, w), both
    masked by ``mask``: NCC cross-spectrum, coarse peak in the fit box
    around zero lag, then the quadratic fit of the surface (``usfac`` 1)
    or the ``usfac``-upsampled matrix-DFT window around the coarse peak
    with its own fit."""
    B, H, W = ref.shape
    dt, dev = ref.dtype, ref.device
    k = int(cfg["peak_fit_box"])
    m = mask.to(dt)
    G = torch.fft.fft2(_ncc_side(img, m)) * torch.conj(
        torch.fft.fft2(_ncc_side(ref, m)))
    cc = torch.fft.fftshift(torch.fft.ifft2(G).real, dim=(-2, -1))
    s = max(min(k, H, W), 1)
    box = (H // 2 - s // 2, H // 2 - s // 2 + s, W // 2 - s // 2,
           W // 2 - s // 2 + s)
    usfac = int(cfg["usfac"])
    if usfac <= 1:
        x, y, v, ok = peak_fit(cc, k, cfg["fit_type"], search=box)
        return x - W // 2, y - H // 2, v, ok
    win = cc[:, box[0]:box[1], box[2]:box[3]].reshape(B, -1)
    flat = torch.argmax(win, dim=-1)
    s0y = (flat // s + box[0] - H // 2).to(dt)
    s0x = (flat % s + box[2] - W // 2).to(dt)
    nwin = -(-(usfac + k + 1) // 8) * 8
    t = (torch.arange(nwin, dtype=dt, device=dev) - nwin // 2) / usfac
    fy = torch.fft.fftfreq(H, d=1.0 / H, dtype=dt, device=dev)
    fx = torch.fft.fftfreq(W, d=1.0 / W, dtype=dt, device=dev)
    ay = 2 * math.pi * (s0y[:, None, None] + t[None, :, None]) * fy / H
    ax = 2 * math.pi * (s0x[:, None, None] + t[None, :, None]) * fx / W
    Gr, Gi = G.real.to(dt), G.imag.to(dt)
    # Re{Ky G Kxᵀ} with Ky = exp(i ay), Kx = exp(i ax), as real products
    Pr = (torch.einsum("bvj,buv->buj", torch.cos(ax).transpose(1, 2), Gr)
          - torch.einsum("bvj,buv->buj", torch.sin(ax).transpose(1, 2), Gi))
    Pi = (torch.einsum("bvj,buv->buj", torch.sin(ax).transpose(1, 2), Gr)
          + torch.einsum("bvj,buv->buj", torch.cos(ax).transpose(1, 2), Gi))
    C = (torch.einsum("biu,buj->bij", torch.cos(ay), Pr)
         - torch.einsum("biu,buj->bij", torch.sin(ay), Pi)) / (H * W)
    x, y, v, ok = peak_fit(C, k, cfg["fit_type"])
    off = (nwin // 2) / usfac
    return s0x - off + x / usfac, s0y - off + y / usfac, v, ok


def linear_fit(xy, uv, fid, E, w0, fitgeom, nclip, sigma):
    """Per-frame sigma-clipped weighted fits of ``uv ≈ M xy + t`` over
    rows of frames ``fid`` (one-hot moment sums, centred on each frame's
    weighted centroid). Returns (M (E,2,2), t (E,2), nmatches (E,))."""
    dt, dev = xy.dtype, xy.device
    oh = (fid[:, None] == torch.arange(E, device=dev)[None]).to(dt)
    eye = torch.eye(2, dtype=dt, device=dev)
    we = oh * w0[:, None]
    sw0 = we.sum(0).clamp(min=1e-12)
    cen = torch.einsum("ne,ni->ei", we, xy) / sw0[:, None]
    xy, uv = xy - cen[fid], uv - cen[fid]

    def solve(w):
        we = oh * w[:, None]
        sw = we.sum(0)
        sx = torch.einsum("ne,ni->ei", we, xy)
        su = torch.einsum("ne,ni->ei", we, uv)
        sxx = torch.einsum("ne,ni,nj->eij", we, xy, xy)
        sux = torch.einsum("ne,ni,nj->eij", we, uv, xy)
        dead = sw <= 1e-8
        sw = sw.clamp(min=1e-12)
        cx, cu = sx / sw[:, None], su / sw[:, None]
        Sxx = sxx - sw[:, None, None] * cx[:, :, None] * cx[:, None, :]
        Sux = sux - sw[:, None, None] * cu[:, :, None] * cx[:, None, :]
        if fitgeom == "shift":
            M = eye.expand(E, 2, 2).clone()
        elif fitgeom == "general":
            tr = Sxx[:, 0, 0] + Sxx[:, 1, 1]
            M = Sux @ torch.linalg.inv(Sxx + (1e-10 * tr)[:, None, None] * eye
                                       + 1e-12 * eye)
        else:
            raise ValueError(f"fitgeom {fitgeom!r}")
        t = cu - torch.einsum("eij,ej->ei", M, cx)
        M = torch.where(dead[:, None, None], eye, M)
        t = torch.where(dead[:, None], torch.zeros_like(t), t)
        r = uv - (torch.einsum("nij,nj->ni", M[fid], xy) + t[fid])
        return M, t, (r * r).sum(-1)

    w = w0
    for _ in range(nclip):
        _, _, r2 = solve(w)
        we = oh * w[:, None]
        rms2 = (we * r2[:, None]).sum(0) / we.sum(0).clamp(min=1e-12)
        thr = sigma * sigma * rms2.clamp(min=1e-24)
        wn = torch.where(r2 <= thr[fid], w, torch.zeros_like(w))
        enough = (oh * (wn > 0)[:, None]).sum(0) >= 3
        w = torch.where(enough[fid], wn, w)
    M, t, _ = solve(w)
    t = t + cen - torch.einsum("eij,ej->ei", M, cen)
    return M, t, (oh * (w > 0)[:, None]).sum(0).long()


@dataclasses.dataclass
class Result:
    """States after each iteration (M (E,2,2), t (E,2) float64 numpy in
    the grid's frame), each iteration's nmatches, the first iteration
    whose motion fell below ``eps_shift`` (None: none did), the grid's
    crpix and shape, the catalog's size and the cutout shape."""

    states: list
    nmatches: list
    converged_at: int | None
    crpix: np.ndarray
    out_shape: tuple
    n_sources: int
    cut_shape: tuple


def align(frames, wcs, settings: dict, iterations: int, device,
          dtype=F64, stop: bool = False) -> Result:
    """The reference alignment of ``frames`` (E host (H, W) arrays, each
    with its ``Tan`` in ``wcs``) under ``settings`` (``DEFAULTS``
    overridden), for ``iterations`` iterations from the identity, or with
    ``stop`` until the first whose motion falls below ``eps_shift``.
    Raises ``ValueError`` on a setting it does not implement
    (:func:`check_settings`)."""
    check_settings(settings)
    cfg = dict(DEFAULTS, **settings)
    if (cfg["cc_type"], cfg["interp"], cfg["kernel"]) != (
            "NCC", "poly5", "square") or cfg["peak_search_box"] != "fitbox":
        raise ValueError("the reference covers NCC, poly5, the square kernel"
                         " and the fit-box search")
    dev = torch.device(device)
    E = len(frames)
    H, W = frames[0].shape
    grid, out_shape = output_grid(wcs, [f.shape for f in frames])
    data = torch.stack([torch.as_tensor(np.asarray(f)) for f in frames]).to(
        device=dev, dtype=dtype)
    weight = torch.ones(E, dtype=dtype, device=dev)   # rate data, exptime 1
    yy, xx = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                            torch.arange(W, dtype=F64, device=dev),
                            indexing="ij")
    dpx, dpy = [], []
    for e in range(E):
        px, py = grid.world2pix(*wcs[e].pix2world(xx, yy))
        dpx.append(px.to(dtype))
        dpy.append(py.to(dtype))
    dpx, dpy = torch.stack(dpx), torch.stack(dpy)
    del xx, yy
    ratios = [wcs[e].pscale / grid.pscale for e in range(E)]
    if max(ratios) - min(ratios) > 1e-9:
        raise ValueError("the reference takes one pixel-scale ratio")
    ratio = ratios[0]

    def redrizzle(M, t):
        px = M[:, 0, 0, None, None] * dpx + M[:, 0, 1, None, None] * dpy \
            + t[:, 0, None, None]
        py = M[:, 1, 0, None, None] * dpx + M[:, 1, 1, None, None] * dpy \
            + t[:, 1, None, None]
        return combine(*deposit(data, weight, px, py, out_shape,
                                cfg["pixfrac"], ratio))

    eyeE = torch.eye(2, dtype=dtype, device=dev).repeat(E, 1, 1)
    zeroE = torch.zeros((E, 2), dtype=dtype, device=dev)
    drz0 = redrizzle(eyeE, zeroE)
    cat, seg = find_sources(drz0, cfg["catalog_nsigma"],
                            cfg["catalog_npixels"])
    rows, boxes = primary_boxes(cat, out_shape)
    if len(rows) < 3:
        raise ValueError(f"only {len(rows)} usable sources")
    mh = max(b[0] for b in boxes)
    mw = max(b[1] for b in boxes)
    s = int(math.ceil(max(mh + 4, mw + 4, 16) / 16) * 16)
    h = w = min(s, cfg["max_cut_size"])
    if mh > h or mw > w:
        raise ValueError("a footprint exceeds the cutout: the reference "
                         "has no oversized bucket")
    n_real = len(rows)
    N = max(-(-n_real // 64) * 64, 64)
    xy_cat = np.full((N, 2), [out_shape[1] / 2.0, out_shape[0] / 2.0])
    xy_cat[:n_real, 0] = cat["x"][rows]
    xy_cat[:n_real, 1] = cat["y"][rows]
    ids = np.full(N, -1, np.int64)
    ids[:n_real] = cat["id"][rows]
    flux = np.zeros(N)
    flux[:n_real] = cat["flux"][rows]
    flux = flux / max(flux.max(), 1e-12)
    real = np.arange(N) < n_real

    # per-exposure windows, pixmaps and Jacobians (float64)
    xyc = torch.as_tensor(xy_cat, device=dev)
    ra, dec = grid.pix2world(xyc[:, 0], xyc[:, 1])
    oy_, ox_ = torch.meshgrid(torch.arange(h, dtype=F64, device=dev),
                              torch.arange(w, dtype=F64, device=dev),
                              indexing="ij")
    cpx, cpy, jac, blc, valid = [], [], [], [], []
    for e in range(E):
        sx, sy = wcs[e].world2pix(ra, dec)
        sxn, syn = sx.cpu().numpy(), sy.cpu().numpy()
        inside = (sxn >= 0) & (sxn < W) & (syn >= 0) & (syn < H) & real
        bx = np.floor(sxn.astype(np.float32) + 0.5).astype(np.int64) - w // 2
        by = np.floor(syn.astype(np.float32) + 0.5).astype(np.int64) - h // 2
        bxt = torch.as_tensor(bx, device=dev, dtype=F64)
        byt = torch.as_tensor(by, device=dev, dtype=F64)
        gx, gy = grid.world2pix(*wcs[e].pix2world(
            bxt[:, None, None] + ox_[None], byt[:, None, None] + oy_[None]))
        cpx.append(gx)
        cpy.append(gy)
        ccx, ccy = bxt + w // 2, byt + h // 2
        rx, ry = grid.world2pix(*wcs[e].pix2world(
            torch.stack([ccx + 1, ccx - 1, ccx, ccx]),
            torch.stack([ccy, ccy, ccy + 1, ccy - 1])))
        jac.append(torch.stack([
            torch.stack([(rx[0] - rx[1]) / 2, (rx[2] - rx[3]) / 2], -1),
            torch.stack([(ry[0] - ry[1]) / 2, (ry[2] - ry[3]) / 2], -1)], -2))
        blc.append((bx, by))
        valid.append(inside)
    cut_px = torch.stack(cpx).to(dtype).reshape(E * N, h, w)
    cut_py = torch.stack(cpy).to(dtype).reshape(E * N, h, w)
    jac = torch.stack(jac).to(dtype).reshape(E * N, 2, 2)
    xy0 = torch.as_tensor(np.tile(xy_cat, (E, 1)), device=dev, dtype=dtype)
    valid_t = torch.as_tensor(np.concatenate(valid), device=dev)
    fw = valid_t.to(dtype)
    if cfg["use_weights"]:
        fw = fw * torch.as_tensor(np.tile(flux, E), device=dev, dtype=dtype)
    fid = torch.arange(E, device=dev).repeat_interleave(N)

    # image cutouts with their in-frame masks, and segmentation masks
    img, msk = [], []
    for e in range(E):
        bx, by = blc[e]
        cx = torch.as_tensor(bx, device=dev)[:, None, None] + ox_[None].long()
        cy = torch.as_tensor(by, device=dev)[:, None, None] + oy_[None].long()
        ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        v = data[e][cy.clamp(0, H - 1), cx.clamp(0, W - 1)]
        img.append(torch.where(ok, v, torch.zeros_like(v)))
        msk.append(ok)
    img = torch.cat(img)
    msk = torch.cat(msk)
    if cfg["combine_seg_mask"]:
        Ho, Wo = out_shape
        xi = torch.floor(cut_px.to(F64) + 0.5).long()
        yi = torch.floor(cut_py.to(F64) + 0.5).long()
        inb = (xi >= 0) & (xi < Wo) & (yi >= 0) & (yi < Ho)
        sv = torch.where(inb, seg[yi.clamp(0, Ho - 1), xi.clamp(0, Wo - 1)],
                         0)
        idt = torch.as_tensor(np.tile(ids, E), device=dev)
        segm = (sv == idt[:, None, None]).to(dtype)
    else:
        segm = torch.ones_like(img)

    def measure(M, t, rows=slice(None)):
        drz = redrizzle(M, t)
        Mi, ti = M[fid[rows]], t[fid[rows]]
        bx = (Mi[:, 0, 0, None, None] * cut_px[rows]
              + Mi[:, 0, 1, None, None] * cut_py[rows] + ti[:, 0, None, None])
        by = (Mi[:, 1, 0, None, None] * cut_px[rows]
              + Mi[:, 1, 1, None, None] * cut_py[rows] + ti[:, 1, None, None])
        vals, ok = poly5(drz, bx, by)
        mk = msk[rows] & ok
        dx, dy, peak, fit_ok = displacement(vals * segm[rows],
                                            img[rows] * segm[rows], mk, cfg)
        good = (fit_ok & (peak > 0)).to(dtype)
        d = torch.stack([dx, dy], -1)
        uv = xy0[rows] + torch.einsum(
            "nij,nj->ni", torch.einsum("nij,njk->nik", Mi, jac[rows]), d)
        return uv, fw[rows] * good

    fit_kw = dict(fitgeom=cfg["fitgeom"], nclip=int(cfg["nclip"]),
                  sigma=float(cfg["sigma"]))
    M, t = eyeE.clone(), zeroE.clone()
    states, nm, conv = [], [], None
    for it in range(int(iterations)):
        if cfg["wcsupdate"] == "otf" and E > 1:
            uv = torch.zeros_like(xy0)
            wgt = torch.zeros_like(fw)
            GM, Gt, NM = [], [], []
            for e in range(E):
                r = slice(e * N, (e + 1) * N)
                uv_e, w_e = measure(M, t, r)
                Me, te, ne = linear_fit(uv_e, xy0[r], fid[r], E, w_e,
                                        **fit_kw)
                M = M.clone()
                t = t.clone()
                t[e] = Me[e] @ t[e] + te[e]
                M[e] = Me[e] @ M[e]
                uv[r], wgt[r] = uv_e, w_e
                GM.append(Me[e])
                Gt.append(te[e])
                NM.append(ne[e])
            GM, Gt, nmat = torch.stack(GM), torch.stack(Gt), torch.stack(NM)
        else:
            uv, wgt = measure(M, t)
            GM, Gt, nmat = linear_fit(uv, xy0, fid, E, wgt, **fit_kw)
            t = torch.einsum("eij,ej->ei", GM, t) + Gt
            M = torch.einsum("eij,ejk->eik", GM, M)
        moved = torch.einsum("nij,nj->ni", GM[fid], uv) + Gt[fid] - uv
        if E > 1:
            moved = moved - (wgt[:, None] * moved).sum(0) / wgt.sum().clamp(
                min=1e-12)
        oh = (fid[:, None] == torch.arange(E, device=dev)[None]).to(dtype)
        rms = torch.sqrt((oh * (wgt * (moved * moved).sum(-1))[:, None]).sum(0)
                         / (oh * wgt[:, None]).sum(0).clamp(min=1e-12))
        if conv is None and float(rms.max()) < cfg["eps_shift"]:
            conv = it
        states.append((M.to(F64).cpu().numpy(), t.to(F64).cpu().numpy()))
        nm.append(nmat.cpu().numpy())
        if stop and conv is not None:
            break
    return Result(states=states, nmatches=nm, converged_at=conv,
                  crpix=grid.crpix, out_shape=out_shape, n_sources=n_real,
                  cut_shape=(h, w))
