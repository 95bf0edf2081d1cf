"""Band-local source detection on a row-sharded mosaic (no gather).

Counterpart of ``subpixal_tpu/catalogs/spatial.py``: the device source
finder of :mod:`subpixal_tpu_torch.catalogs_device` run on each rank's
row band of a ``Drizzle(spatial_mesh=...)`` product, in plain torch (the
JAX package has no Pallas kernel here either):

* global statistics without a gather: the sigma clip keeps a value
  interval, so each round's count, sum and centred sum of squares of the
  kept values are exact ``all_reduce`` sums (counts in int64, moments in
  float64), and the median is a fixed 40-step bisection of the value axis
  on reduced counts;
* detection: each band is extended by ``window`` halo rows
  (:func:`~subpixal_tpu_torch.parallel.halo_exchange`) and the peaks
  finder runs on it; a candidate is OWNED by the band that holds its
  peak pixel, so a source that straddles two bands is kept once,
  measured on its whole (in-window) footprint through the halo;
* merge: only the small per-band tables cross ranks (each rank writes
  its slot of a zero-filled buffer, ``all_reduce``-d), so every rank
  builds the same catalog in the JAX package's order (peak, then band,
  then band-local rank); each band's segmentation plane stays on its
  device, band-local ranks remapped to global ids.

Every function is called by every rank of the mesh (they are
collectives), each with its own band.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .catalogs import Table
from .catalogs_device import (_candidate_mask, _find_sources_peaks_core,
                              _peaks_dims)
from .parallel.spatial import (_agree, _exchange, _psum, _rows_axis,
                               gather_rows, halo_exchange)
from .tracing import to_host

__all__ = ["sigma_clipped_stats_spatial", "find_sources_spatial",
           "SpatialSourceCatalog"]


def _band_geometry(mesh, band, logical_rows):
    """(row0, finite-and-logical mask) of this rank's band."""
    Hl = band.shape[0]
    row0 = mesh.index(_rows_axis(mesh)) * Hl
    rows = row0 + torch.arange(Hl, device=band.device)
    return row0, rows < int(logical_rows)


def sigma_clipped_stats_spatial(mesh, band_plane: torch.Tensor,
                                logical_rows: int, sigma: float = 3.0,
                                maxiters: int = 5):
    """(mean, median, std) of a row-sharded plane, as 0-d float32 tensors
    equal on every rank.

    The fixed point of
    :func:`~subpixal_tpu_torch.catalogs_device.sigma_clipped_stats_device`
    (a value interval, re-centred ``maxiters`` times), with each round's
    statistics the ``all_reduce``-d sums of the bands' partials: counts in
    int64 (a 4096² mosaic holds more pixels than float32 counts exactly),
    the sum and the mean-centred sum of squares in float64, and the median
    located by a fixed 40-step float32 bisection of the value axis on
    reduced counts (as the JAX package), no sort and no gather.
    """
    x = band_plane.to(torch.float32)
    dev = x.device
    rax = _rows_axis(mesh)
    _, in_rows = _band_geometry(mesh, x, logical_rows)
    finite = torch.isfinite(x) & in_rows[:, None]
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    ext = torch.stack([torch.where(finite, x, big).min(),
                       torch.where(finite, -x, big).min()])
    ext = _psum(ext, mesh, rax, dist.ReduceOp.MIN)
    gmin, gmax = ext[0], -ext[1]
    xd = torch.where(finite, x, 0.0).to(torch.float64)

    def interval_stats(vlo, vhi):
        inside = finite & (x >= vlo) & (x <= vhi)
        m1 = _psum(torch.stack([inside.sum().to(torch.float64),
                                torch.where(inside, xd, 0.0).sum()]),
                   mesh, rax)
        cnt = m1[0].to(torch.int64)
        n = torch.clamp(m1[0], min=1.0)
        mean = m1[1] / n
        s2 = _psum(torch.where(inside, (xd - mean) ** 2, 0.0).sum(), mesh,
                   rax)
        var = torch.clamp(s2 / n, min=0.0)
        # median: the value where the count below crosses the middle
        target = (cnt - 1).to(torch.float64) * 0.5
        a = torch.minimum(vlo, gmin)
        b = torch.maximum(vhi, gmax)
        for _ in range(40):
            mid = 0.5 * (a + b)
            below = _psum((inside & (x < mid)).sum(), mesh, rax)
            go = below <= target
            a, b = torch.where(go, mid, a), torch.where(go, b, mid)
        return (mean.to(torch.float32), 0.5 * (a + b),
                torch.sqrt(var).to(torch.float32))

    vlo, vhi = gmin, gmax
    for _ in range(maxiters):
        _, med, std = interval_stats(vlo, vhi)
        vlo = med - sigma * std
        vhi = med + sigma * std
    return interval_stats(vlo, vhi)


def _threshold(mesh, band, logical_rows, nsigma):
    _, med, std = sigma_clipped_stats_spatial(mesh, band, logical_rows)
    return med + np.float32(nsigma) * std


def _extended(mesh, band, logical_rows, halo):
    """The band with its padding rows NaN (they must not detect),
    extended by ``halo`` rows of each neighbour (zeros past the mosaic)."""
    _, in_rows = _band_geometry(mesh, band, logical_rows)
    band = torch.where(in_rows[:, None], band.to(torch.float32), torch.nan)
    return halo_exchange(band, halo, mesh, edge="zero")


def _count_spatial_auto(band_plane, *, mesh, logical_rows, halo, npixels,
                        nsigma):
    """(largest candidate count of any band, the derived threshold): the
    first stage of the two-stage band-local finder, which sizes the
    detection batch from the actual count instead of ``max_sources``."""
    thr = _threshold(mesh, band_plane, logical_rows, nsigma)
    ext = _extended(mesh, band_plane, logical_rows, halo)
    cnt = _candidate_mask(ext, thr, npixels).sum()
    return _psum(cnt, mesh, _rows_axis(mesh), dist.ReduceOp.MAX), thr


def _detect_core(band_plane, thr, *, mesh, logical_rows, halo, B, win,
                 npixels, deblend_nthresh, deblend_cont):
    """Band-local detection at a threshold: (the band's segmentation
    plane of band-local ranks, its (15, B) table). The table's rows are
    :func:`~subpixal_tpu_torch.catalogs_device._find_sources_peaks_core`'s
    with absolute row coordinates, plus an ownership flag (row 14)."""
    Hl = band_plane.shape[0]
    row0, _ = _band_geometry(mesh, band_plane, logical_rows)
    ext = _extended(mesh, band_plane, logical_rows, halo)
    ero0 = float(row0 - halo)               # ext row 0, absolute
    seg_rank, packed, _ = _find_sources_peaks_core(
        ext, thr, max_sources=B, npixels=npixels, window=win,
        deblend_nthresh=deblend_nthresh, deblend_cont=deblend_cont)
    # ownership: the peak pixel lies in this band's own rows. Candidates
    # it does not own stay in the table: the merge finds them again by
    # their peak, so a straddler's pixels in this band take its global id
    py_abs = packed[11] + ero0
    own = ((py_abs >= row0) & (py_abs < min(row0 + Hl, int(logical_rows)))
           & (packed[0] > 0))
    packed = packed.clone()
    for r in (4, 8, 9, 11):                 # cy, ymin, ymax, peak_y
        packed[r] += ero0
    packed = torch.cat([packed, own.to(torch.float32)[None]])
    return seg_rank[halo:halo + Hl], packed


def _tables(packed, mesh) -> np.ndarray:
    """Every band's (15, B) table on every rank, (n_bands, 15, B) host.
    Over a 2-D mesh every rank takes the tables of its frames line's rank
    at frames index 0, so every rank holds the same catalog."""
    tables = _exchange(packed, mesh, _rows_axis(mesh))
    return to_host(_agree(mesh, tables)[0]).numpy()


def find_sources_spatial(mesh, band_plane: torch.Tensor, logical_rows: int,
                         threshold: float | None = None, nsigma: float = 3.0,
                         npixels: int = 5, max_sources: int = 8192,
                         window: int = 32, deblend_nthresh: int = 32,
                         deblend_cont: float = 0.005):
    """Band-local :func:`~subpixal_tpu_torch.catalogs_device.
    find_sources_device` on a row-sharded mosaic (module docstring).

    ``band_plane`` is this rank's ``(band_rows, W)`` band of the science
    plane, ``logical_rows`` the mosaic's unpadded height. Returns
    ``(Table, seg)``: the whole catalog, the same on every rank, and
    ``seg``, this rank's band of the int32 id plane (0: background).
    """
    rax = _rows_axis(mesh)
    Hl, W = band_plane.shape
    dev = band_plane.device
    Ho = int(logical_rows)
    halo = max(2, min(int(window), max(Hl - 1, 1)))
    B, win = _peaks_dims((Hl + 2 * halo, W), max_sources, window)
    core = dict(mesh=mesh, logical_rows=Ho, halo=halo, npixels=npixels,
                deblend_nthresh=int(deblend_nthresh),
                deblend_cont=float(deblend_cont))
    if threshold is None and B > 256:
        # two-stage sizing: count the candidates of every band (one small
        # copy to the host), then detect with the batch bucketed to the
        # largest count rather than max_sources
        cnt, thr_d = _count_spatial_auto(
            band_plane, mesh=mesh, logical_rows=Ho, halo=halo,
            npixels=int(npixels), nsigma=float(nsigma))
        n_est, threshold = to_host(torch.stack([
            cnt.to(torch.float64), thr_d.to(torch.float64)])).tolist()
        b_eff = 128
        while b_eff < int(n_est) + 8:
            b_eff *= 2
        if b_eff < B:
            max_sources = b_eff
            B, win = _peaks_dims((Hl + 2 * halo, W), max_sources, window)
    thr = (_threshold(mesh, band_plane, Ho, nsigma) if threshold is None
           else torch.tensor(threshold, dtype=torch.float32, device=dev))
    seg_local, packed = _detect_core(band_plane, thr, B=B, win=win, **core)
    arr = _tables(packed, mesh)                      # (Nb, 15, B)
    keep = arr[:, 0, :] > 0
    owned = keep & (arr[:, 14, :] > 0)
    # window escalation, band-local: an owned source whose bbox touched
    # its window (row 13) was truncated; re-run with the window doubled
    # while that enlarges the band's effective window
    if (owned & (arr[:, 13, :] > 0)).any():
        cap = min(256, W, Ho)
        win2 = min(2 * window, cap)
        halo2 = max(2, min(int(win2), max(Hl - 1, 1)))
        _, win2_eff = _peaks_dims((Hl + 2 * halo2, W), max_sources, win2)
        if win2_eff > win:
            # the same threshold gives the same candidates: cap the batch
            # at their known count
            n_cand = int(arr[:, 10, 0].max())
            b2 = min(max_sources, max(64, -(-(n_cand + 8) // 64) * 64))
            return find_sources_spatial(
                mesh, band_plane, logical_rows, threshold=threshold,
                nsigma=nsigma, npixels=npixels, max_sources=b2, window=win2,
                deblend_nthresh=deblend_nthresh, deblend_cont=deblend_cont)
    # global ids: brightest peak first, then band, then band-local rank
    order = sorted((float(-arr[bnd, 5, i]), bnd, int(i))
                   for bnd in range(arr.shape[0])
                   for i in np.nonzero(owned[bnd])[0])[:max_sources]
    ids = np.arange(1, len(order) + 1, dtype=np.int32)
    cols = {k: np.array([arr[b, r, i] for _, b, i in order], np.float32)
            for k, r in (("x", 3), ("y", 4), ("flux", 2), ("area", 1),
                         ("peak", 5), ("xmin", 6), ("xmax", 7),
                         ("ymin", 8), ("ymax", 9))}
    cat = Table({
        "id": ids,
        "x": cols["x"].astype(np.float64),
        "y": cols["y"].astype(np.float64),
        "flux": cols["flux"].astype(np.float64),
        "area": cols["area"].astype(np.int64),
        "peak": cols["peak"],
        "xmin": cols["xmin"].astype(np.int64),
        "xmax": cols["xmax"].astype(np.int64),
        "ymin": cols["ymin"].astype(np.int64),
        "ymax": cols["ymax"].astype(np.int64),
    })
    # band-local rank -> global id, applied to each band on its device:
    # owned candidates map directly, a neighbour's view of the same
    # source (its peak in that band's halo) by the peak's coordinates
    luts = np.zeros((arr.shape[0], B + 1), np.int32)
    by_peak = {}
    for gid, (_, bnd, i) in zip(ids, order):
        luts[bnd, i + 1] = gid
        by_peak[(int(arr[bnd, 11, i]), int(arr[bnd, 12, i]))] = gid
    for bnd in range(arr.shape[0]):
        for i in np.nonzero(keep[bnd] & ~owned[bnd])[0]:
            luts[bnd, i + 1] = by_peak.get((int(arr[bnd, 11, i]),
                                            int(arr[bnd, 12, i])), 0)
    lut = torch.as_tensor(luts[mesh.index(rax)], device=dev)
    return cat, lut[seg_local.long()]


class SpatialSourceCatalog:
    """Catalog over :func:`find_sources_spatial`: the spatial analogue of
    :class:`~subpixal_tpu_torch.catalogs_device.DeviceSourceCatalog`, with
    the surface ``align_images`` reads (``catalog``,
    ``segmentation_device``: this rank's band of the id plane,
    ``segmentation``: the whole plane on the host, a collective).
    Detection runs at construction, on every rank of the mesh."""

    def __init__(self, mesh, band_plane, logical_rows: int,
                 nsigma: float = 3.0, npixels: int = 5,
                 max_sources: int = 8192, window: int = 32):
        self._mesh = mesh
        self._logical_rows = int(logical_rows)
        self._cat, self._seg = find_sources_spatial(
            mesh, band_plane, logical_rows, nsigma=nsigma, npixels=npixels,
            max_sources=max_sources, window=window)
        self._seg_host = None

    @property
    def catalog(self) -> Table:
        return self._cat

    def execute(self):
        return self._cat

    @property
    def segmentation_device(self) -> torch.Tensor:
        """This rank's (band_rows, W) int32 band of the id plane."""
        return self._seg

    @property
    def segmentation(self) -> np.ndarray:
        """The whole (H, W) id plane on the host: every rank must read
        it (the bands are gathered)."""
        if self._seg_host is None:
            self._seg_host = gather_rows(self._seg, self._logical_rows,
                                         mesh=self._mesh)
        return self._seg_host

    def __len__(self) -> int:
        return len(self._cat)
