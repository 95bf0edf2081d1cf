"""Iterative image alignment — the port's main API.

Counterpart of ``subpixal_tpu/align.py · align_images``: measure
per-source displacements between each exposure and the combined
(drizzled) reference, fit a sigma-clipped linear correction per exposure
in the reference pixel frame, compose it into the per-exposure affine
state, and repeat until the ``eps_shift`` test passes.

* Setup: the AstroDrizzle stages when asked (``match_sky``,
  ``static_mask``, and ``reject_cr`` after the initial drizzle, on copies
  of the exposures), then the initial drizzle's product (one B1 launch
  for a same-shape stack on CUDA) feeds the source finder — on CUDA
  the device finder (:mod:`subpixal_tpu_torch.catalogs_device`, the
  mosaic stays on the card and the primary cutouts come from the table
  alone), on the CPU the host finder (``device_catalog`` picks) —
  primary cutouts fix the static cutout shape (with an oversized-footprint
  bucket for sources that outgrow it), and full-frame and per-cutout
  pixmaps into the reference frame are evaluated once — in float32 on
  the device on CUDA (``cutout_pixmaps='auto'``; frames from
  ``device_pixmap_min_pixels``), else in host float64. Jacobians are
  host float64 either way.
* The sparse deposit (``sparse_deposit='auto'`` on CUDA): input blocks
  whose deposits cannot reach any cutout's blot window are compacted
  away once at setup, and the live set self-heals when the applied
  corrections outgrow its margin.
* One iteration (:func:`_step`) runs on the device: re-drizzle every
  exposure through its affine-corrected pixmap (the whole stack in one
  launch of kernel B1), blot the combined image at every (exposure,
  source) cutout grid of the flattened batch and measure the
  displacements (``blot.blot_measure``: kernel B2, then kernel B3 for
  ``usfac > 1`` under a small search box, ``torch.fft`` otherwise), the
  per-exposure fits, and the affine composition. Under ``wcsupdate='otf'`` the reference is re-drizzled
  before each exposure is measured, so later exposures align against
  already-corrected ones.
* The fixed-point loop (:func:`_fixed_point`, the JAX package's
  ``_build_device_loop``) keeps the state and a preallocated history on
  the device. On one card it runs the step as a CUDA graph and reads the
  host every :data:`READ_EVERY` iterations: the first call of a shape
  runs its first iteration eagerly and captures the step, later calls
  replay the cached graph (:data:`_LOOP_CACHE`). Elsewhere it reads every
  iteration. The host loop (``device_loop=False``, or ``verbose``) reads
  each iteration's fit back and records (and prints) it.
* Under ``mesh=`` (the JAX package's ``_build_mesh_step``) one process
  per device runs the same call and the same :func:`_step` on its block
  (:func:`_block`): it re-drizzles its block of the frames (one B1
  launch) and measures its block of the flattened (frame, source) cutout
  batch (B2, B3); the accumulators and the fits' moment sums are
  ``all_reduce``-d over the process group.
* Through a ``Drizzle(spatial_mesh=...)`` (the JAX package's spatial
  mode) the reference plane is row-band-sharded, one band a rank: setup
  finds the sources band-locally (:mod:`subpixal_tpu_torch.catalogs_spatial`)
  on CUDA or on the gathered plane on the CPU, each rank compacts its
  band's live blocks for the sparse deposit, and every iteration
  re-drizzles into the band (B1) and blots through
  ``parallel.sample_spatial`` (B2 on the halo-extended band), with the
  measurement and the fits replicated on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import time
import warnings
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ._precision import full_f32
from .aot import Captured, capture_graph, get_executable, warm_up
from . import tracing
from .blot import (_affine_apply_grid, blot_measure, compute_pixmap,
                   compute_cutout_pixmaps_device_stack,
                   compute_pixmap_device_stack, device_pixmap_min_pixels)
from .catalogs import ImageCatalog, ImageSourceCatalog
from .catalogs_device import DeviceSourceCatalog
from .catalogs_device import warm_compile as _cat_warm
from .catalogs_spatial import SpatialSourceCatalog
from .cutout import create_primary_cutouts
from .kernels import use_pallas as _use_pallas
from .kernels.drizzle import drizzle_deposit_stack
from .ops.cutouts import extract_cutouts
from .ops.drizzle import drizzle_combine, kernel_reach
from .ops.fit import LinearFitResult, _reducer, iter_linear_fit_frames
from .ops.interp import sample_image
from .parallel.sharding import pad_to_multiple
from .parallel.spatial import _deposit_band, band_rows, sample_spatial
from .resample import (Drizzle, Exposure, _exposure_stack_key,
                       _stack_planes, _weight_parts, exposure_rate_data)
from .wcs import apply_tangent_affine

__all__ = ["align_images", "AlignConfig", "AlignResult", "ImageAlignInfo"]

#: floor of the oversized-footprint bucket's shape cap (the bucket is
#: sized min(need, max(_BIG_CAP_FLOOR, 2*max(cutout_shape))))
_BIG_CAP_FLOOR = 256

#: the input block of the sparse deposit's live set and compaction (the
#: JAX package's ``kernels/_common.py · DEPOSIT_BLOCK``), so both packages
#: keep the same blocks
DEPOSIT_BLOCK = (16, 128)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Alignment configuration: the fields and defaults of the JAX
    package's ``AlignConfig``. ``use_pallas`` selects the TPU kernels
    there and the hand-written CUDA kernels here
    (:func:`~subpixal_tpu_torch.kernels.use_pallas` on the align's
    device): ``'auto'`` takes them on CUDA, ``False`` takes their plain
    versions on any device (under a spatial mesh too, where the JAX
    package turns its kernels off off TPU), ``True`` on a device that is
    not CUDA raises ``ValueError``."""

    cc_type: str = "NCC"
    fitgeom: str = "general"
    nclip: int = 3
    sigma: float = 3.0
    use_weights: bool = True
    combine_seg_mask: bool = True
    wcsupdate: str = "batch"
    max_iterations: int = 10
    eps_shift: float = 0.004
    history: str = "all"
    usfac: int = 1
    peak_fit_box: int = 5
    peak_search_box: int | str | tuple | None = "fitbox"
    fit_type: str = "quadratic"
    interp: str = "poly5"
    cutout_shape: tuple[int, int] | None = None
    max_cut_size: int = 128
    pixfrac: float = 1.0
    kernel: str = "square"
    wht_type: str = "exptime"
    skymethod: str = "match"
    min_sources: int = 3
    use_pallas: bool | str = "auto"
    sparse_deposit: bool | str = "auto"
    match_sky: bool = False
    static_mask: bool = False
    reject_cr: bool = False
    cutout_pixmaps: str = "auto"
    device_loop: bool | str = "auto"
    device_catalog: str = "auto"
    catalog_nsigma: float = 3.0
    catalog_npixels: int = 5
    catalog_max_sources: int = 8192
    catalog_window: int = 32


@dataclasses.dataclass
class ImageAlignInfo:
    """Per-image, per-iteration fit record."""

    name: str
    iteration: int
    shift: tuple[float, float]
    matrix: tuple[tuple[float, float], tuple[float, float]]
    rms: tuple[float, float]
    rmse: float
    mae: float
    nmatches: int
    iter_s: float = 0.0  # wall time of one device iteration
    # pixels the kernels' static tiles missed: the CUDA kernels have no
    # tiles, so this is 0 by construction
    escaped: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@dataclasses.dataclass
class AlignResult:
    """Result of :func:`align_images`: exposures with CORRECTED WCSs, the
    cumulative per-exposure affine corrections in the reference pixel
    frame (``p_true = M @ p_pred + t``), per-iteration history, whether
    ``eps_shift`` was met, and setup timing."""

    exposures: list[Exposure]
    matrices: np.ndarray
    shifts: np.ndarray
    history: list[list[ImageAlignInfo]]
    converged: bool
    n_iterations: int
    drizzle: Drizzle | None = None
    setup_s: float = 0.0
    setup_breakdown: dict | None = None
    truncated_sources: list[int] = dataclasses.field(default_factory=list)


def _check_config(cfg: AlignConfig) -> None:
    """Reject the JAX package's branches that this slice leaves out."""
    if cfg.wcsupdate not in ("batch", "otf"):
        raise ValueError(f"wcsupdate must be 'batch'|'otf', "
                         f"got {cfg.wcsupdate!r}")
    if cfg.sparse_deposit not in (True, False, "auto"):
        raise ValueError(f"sparse_deposit must be True|False|'auto', "
                         f"got {cfg.sparse_deposit!r}")
    if cfg.cutout_pixmaps not in ("auto", "device", "host"):
        raise ValueError(f"cutout_pixmaps must be 'auto'|'device'|'host', "
                         f"got {cfg.cutout_pixmaps!r}")
    if cfg.device_catalog not in ("auto", "device", "host"):
        raise ValueError(f"device_catalog must be 'auto'|'device'|'host', "
                         f"got {cfg.device_catalog!r}")


class _PrimMeta:
    """Shape, id, position and flux of one primary cutout without its
    pixels: on the device-catalog path the mosaic never reaches the host,
    and setup reads only these four attributes (``.data`` is an
    allocation-free broadcast view, there for ``.data.shape``)."""

    __slots__ = ("data", "src_id", "src_pos_parent", "src_weight")

    def __init__(self, shape, src_id, pos, weight):
        self.data = np.broadcast_to(np.float32(0.0), shape)
        self.src_id = src_id
        self.src_pos_parent = pos
        self.src_weight = weight


def _prim_meta_from_catalog(cat, out_shape, pad: int = 1,
                            min_box_size: int = 8, max_box_size: int = 512):
    """Primary-cutout metadata from a catalog table's bbox columns: the
    box sizing and rejections of
    :func:`~subpixal_tpu_torch.cutout.create_primary_cutouts` (footprint
    plus ``pad``, min/max box size, no-overlap skip) without image pixels."""
    Hs, Ws = out_shape
    n = len(cat)
    ids = (np.asarray(cat["id"], int) if "id" in cat
           else np.arange(1, n + 1))
    xs = np.asarray(cat["x"], float)
    ys = np.asarray(cat["y"], float)
    flux = np.asarray(cat["flux"], float) if "flux" in cat else np.ones(n)
    has_bb = all(k in cat for k in ("xmin", "xmax", "ymin", "ymax"))
    out = []
    for k in range(n):
        if has_bb and int(np.asarray(cat["ymax"])[k]) >= 0:
            fy0 = int(np.asarray(cat["ymin"])[k])
            fy1 = int(np.asarray(cat["ymax"])[k])
            fx0 = int(np.asarray(cat["xmin"])[k])
            fx1 = int(np.asarray(cat["xmax"])[k])
            y0 = fy0 - pad
            x0 = fx0 - pad
            h = fy1 - y0 + 1 + pad
            w = fx1 - x0 + 1 + pad
            if h < min_box_size or w < min_box_size:
                cy, cx = (fy0 + fy1) / 2, (fx0 + fx1) / 2
                h = w = max(h, w, min_box_size)
                y0 = int(round(cy)) - h // 2
                x0 = int(round(cx)) - w // 2
            if h > max_box_size or w > max_box_size:
                continue  # an absurd footprint (blended junk)
        else:
            y0 = int(round(ys[k])) - min_box_size // 2
            x0 = int(round(xs[k])) - min_box_size // 2
            h = w = min_box_size
        if y0 >= Hs or x0 >= Ws or y0 + h <= 0 or x0 + w <= 0:
            continue  # no overlap with the reference
        out.append(_PrimMeta((h, w), int(ids[k]), (float(xs[k]),
                                                   float(ys[k])),
                             float(flux[k])))
    return out


# --------------------------------------------------------------------- #
# sparse deposit: live input blocks and their compaction
# --------------------------------------------------------------------- #

def _block_partition(a, block=DEPOSIT_BLOCK, edge: bool = False):
    """``(E, H, W) -> (E, nb, bh, bw)``: the deposit's input blocks,
    row-major over (by, bx), padded to whole blocks with zeros (or the
    edge values, for coordinate planes)."""
    E, H, W = a.shape
    bh, bw = block
    Hp, Wp = -(-H // bh) * bh, -(-W // bw) * bw
    if (Hp, Wp) != (H, W):
        if edge:
            rows = torch.clamp(torch.arange(Hp, device=a.device), max=H - 1)
            cols = torch.clamp(torch.arange(Wp, device=a.device), max=W - 1)
            a = a[:, rows][:, :, cols]
        else:
            a = torch.nn.functional.pad(a, (0, Wp - W, 0, Hp - H))
    return (a.reshape(E, Hp // bh, bh, Wp // bw, bw)
            .permute(0, 1, 3, 2, 4).reshape(E, -1, bh, bw))


def _block_bboxes_wcs(wcs_list, to_wcs, shape, block=DEPOSIT_BLOCK,
                      pad: float = 1.0):
    """Per-input-block output bboxes from the WCS composition evaluated at
    the block CORNERS (host float64), padded by ``pad`` px for
    within-block curvature; row-major (by, bx) block order as
    :func:`_block_partition`. Returns (y0, y1, x0, x1), each (E, nb)."""
    H, W = shape
    bh, bw = block
    nby, nbx = -(-H // bh), -(-W // bw)
    y0s = np.minimum(np.arange(nby) * bh, H - 1).astype(np.float64)
    y1s = np.minimum((np.arange(nby) + 1) * bh - 1, H - 1).astype(
        np.float64)
    x0s = np.minimum(np.arange(nbx) * bw, W - 1).astype(np.float64)
    x1s = np.minimum((np.arange(nbx) + 1) * bw - 1, W - 1).astype(
        np.float64)
    ye = np.stack([y0s, y1s])  # (2, nby)
    xe = np.stack([x0s, x1s])  # (2, nbx)
    gy = np.broadcast_to(ye[:, :, None, None], (2, nby, 2, nbx))
    gx = np.broadcast_to(xe[None, None, :, :], (2, nby, 2, nbx))
    outs = []
    for wcs in wcs_list:
        ra, dec = wcs.pixel_to_world(gx, gy)
        rx, ry = to_wcs.world_to_pixel(ra, dec)
        rx = np.asarray(rx)
        ry = np.asarray(ry)
        outs.append(((ry.min(axis=(0, 2)) - pad).reshape(-1),
                     (ry.max(axis=(0, 2)) + pad).reshape(-1),
                     (rx.min(axis=(0, 2)) - pad).reshape(-1),
                     (rx.max(axis=(0, 2)) + pad).reshape(-1)))
    return tuple(np.stack([o[k] for o in outs]) for k in range(4))


def _compact_blocks(data, wht, px, py, idx, valid, block=DEPOSIT_BLOCK):
    """Gather input blocks ``idx`` (E, L) into (E, L·bh, bw)
    pseudo-images. Padded entries (``valid`` False) keep a live block's
    pixmap but get weight 0, so they deposit nothing. The deposit is
    position-based, so it takes the pseudo-images as they are."""
    E = data.shape[0]
    bh, bw = block
    L = idx.shape[1]
    rows = torch.arange(E, device=idx.device)[:, None]

    def take(a, edge=False):
        return _block_partition(a, block, edge)[rows, idx].reshape(
            E, L * bh, bw)

    cw = take(wht) * valid.to(wht.dtype).repeat_interleave(bh, 1)[:, :, None]
    return take(data), cw, take(px, edge=True), take(py, edge=True)


def _live_block_indices(bboxes, cut_bb, out_shape, blot_margin: float,
                        corr_margin: float, bands=None):
    """Input blocks whose deposits can reach any cutout's blot window.

    A block is LIVE when its output bbox (``bboxes``, from
    :func:`_block_bboxes_wcs`), padded by ``corr_margin``, overlaps the
    union of the per-cutout needed rectangles (``cut_bb`` = (y0, y1, x0,
    x1) of (E, N) cutout bboxes in the reference frame, padded by
    ``blot_margin``), on a grid of 8 px cells. Returns ``(idx, valid)``
    of shape (E, L), L shared across frames and rounded up to 64; pads
    repeat the first live block and are not valid.

    ``bands=(n_bands, band_rows)``: the spatial (row-band) live sets. A
    block is live FOR BAND b when a needed cell lies in its padded bbox
    within the band's rows, so the union over the bands keeps exactly the
    deposits the one live set keeps, each made by the band that owns its
    rows. Returns ``(idx, valid)`` of shape (n_bands, E, L), L shared
    across bands and frames.
    """
    Ho, Wo = out_shape
    cell = 8
    gh, gw = -(-Ho // cell), -(-Wo // cell)
    need = np.zeros((gh, gw), bool)
    m = blot_margin
    cy0, cy1b, cx0b, cx1b = [np.asarray(b, np.float64) for b in cut_bb]
    ry0 = np.floor((cy0 - m) / cell).astype(int)
    ry1 = np.ceil((cy1b + m) / cell).astype(int)
    rx0 = np.floor((cx0b - m) / cell).astype(int)
    rx1 = np.ceil((cx1b + m) / cell).astype(int)
    for y0, y1, x0, x1 in zip(ry0.ravel(), ry1.ravel(),
                              rx0.ravel(), rx1.ravel()):
        if y1 < 0 or x1 < 0 or y0 >= gh or x0 >= gw:
            continue
        need[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = True
    # integral image for O(1) any-needed-cell-in-range queries
    integ = np.zeros((gh + 1, gw + 1), np.int64)
    integ[1:, 1:] = np.cumsum(np.cumsum(need, 0), 1)

    y0, y1, x0, x1 = [np.asarray(b, np.float64) for b in bboxes]  # (E, nb)
    pad = corr_margin
    cy0 = np.clip(np.floor((y0 - pad) / cell).astype(int), 0, gh - 1)
    cy1 = np.clip(np.ceil((y1 + pad) / cell).astype(int), 0, gh - 1)
    cx0 = np.clip(np.floor((x0 - pad) / cell).astype(int), 0, gw - 1)
    cx1 = np.clip(np.ceil((x1 + pad) / cell).astype(int), 0, gw - 1)
    # blocks entirely outside the output grid never deposit
    on_grid = ((y1 + pad >= 0) & (y0 - pad < Ho)
               & (x1 + pad >= 0) & (x0 - pad < Wo))

    def count(r0, r1):
        """Needed cells in each block's padded bbox, its cell rows clipped
        to [r0, r1] (an empty range counts none)."""
        a0 = np.maximum(cy0, r0)
        a1 = np.minimum(cy1, r1)
        c = (integ[a1 + 1, cx1 + 1] - integ[a0, cx1 + 1]
             - integ[a1 + 1, cx0] + integ[a0, cx0])
        return np.where(a0 <= a1, c, 0)

    def pack(live):
        E = live.shape[0]
        L = max(int(live.sum(1).max()), 1)
        L = min(-(-L // 64) * 64, live.shape[1])  # bucket: shape reuse
        idx = np.zeros((E, L), np.int64)
        valid = np.zeros((E, L), bool)
        for e in range(E):
            ids = np.flatnonzero(live[e])[:L]
            idx[e, :len(ids)] = ids
            idx[e, len(ids):] = ids[0] if len(ids) else 0
            valid[e, :len(ids)] = True
        return idx, valid

    if bands is None:
        return pack((count(0, gh - 1) > 0) & on_grid)
    n_bands, Hl = bands
    live = np.stack([(count(b * Hl // cell,
                            min(((b + 1) * Hl - 1) // cell, gh - 1)) > 0)
                     & on_grid for b in range(n_bands)])  # (Nb, E, nb)
    Nb, E, nb = live.shape
    idx, valid = pack(live.reshape(Nb * E, nb))
    return idx.reshape(Nb, E, -1), valid.reshape(Nb, E, -1)


def _stage_device_inputs(exp_data, centers, seg_f, cut_px, cut_py, src_ids,
                         src_cat, seg_ok, *, cut_shape, use_seg=True):
    """The program ``device_stage``: the static per-exposure loop inputs,
    the image cutouts (rate units) with their in-image masks, and each
    source's segmentation mask sampled (nearest) from its catalog's plane
    ``seg_f[src_cat[n]]`` at the cutout pixmaps (all ones where its
    catalog has none, ``seg_ok`` False). Without segmentation
    (``use_seg`` False) there is no mask (all ones)."""
    cbs = [extract_cutouts(exp_data[e], centers[e], cut_shape)
           for e in range(exp_data.shape[0])]
    data = torch.stack([c.data for c in cbs])
    mask = torch.stack([c.mask for c in cbs])
    if not use_seg:
        return data, mask, torch.ones_like(data)

    def samp(plane):
        return sample_image(plane, cut_px, cut_py, interp="nearest")[0]

    sseg = samp(seg_f[0])
    for ci in range(1, seg_f.shape[0]):
        sseg = torch.where(src_cat[None, :, None, None] == ci,
                           samp(seg_f[ci]), sseg)
    seg_cut = ((sseg - src_ids[None, :, None, None]).abs() < 0.5).to(
        torch.float32)
    return data, mask, torch.maximum(
        seg_cut, (~seg_ok)[None, :, None, None].to(torch.float32))


def _stage_device_inputs_aot(*args, cut_shape, use_seg):
    """:func:`_stage_device_inputs` through ``aot.get_executable`` (one
    captured program a shape on a card)."""
    exe = get_executable("device_stage", _stage_device_inputs, args,
                         statics=dict(cut_shape=tuple(cut_shape),
                                      use_seg=bool(use_seg)))
    return exe(*args)


@dataclasses.dataclass
class _LoopArgs:
    """Device-resident inputs of one iteration (E exposures, N sources)."""

    # deposit inputs: (E, H, W) frames, or under the sparse deposit the
    # (E, L*16, 128) compacted live blocks
    exp_data: torch.Tensor   # rate data
    exp_wht: torch.Tensor    # deposit weights
    dri_px: torch.Tensor     # pixmaps into the reference frame
    dri_py: torch.Tensor
    cut_px: torch.Tensor     # (E, N, h, w) cutout pixmaps
    cut_py: torch.Tensor
    img_cut: torch.Tensor    # (E, N, h, w) image cutouts
    img_msk: torch.Tensor
    seg_cut: torch.Tensor
    jac: torch.Tensor        # (E, N, 2, 2) exposure->ref Jacobians
    xy0: torch.Tensor        # (E, N, 2) catalog positions
    src_w: torch.Tensor      # (E, N) flux weights
    src_valid: torch.Tensor  # (E, N) bool
    big: tuple | None = None  # oversized bucket: (cpx, cpy, img, msk,
    #                           seg, idx, valid)


@dataclasses.dataclass
class _Block:
    """One iteration's inputs as this device holds them: the frames it
    re-drizzles and its rows of the flattened (frame, source) cutout
    batch. Without a mesh that is every frame and every row, in order (N
    rows a frame); under ``mesh=`` this rank's contiguous block of each,
    padded to a multiple of the mesh size (padded frames: data, weight
    and pixmaps 0, frame id E - 1; padded rows: weight 0, invalid, frame
    id 0). Under a spatial mesh every rank holds every row (the
    measurement is replicated) and every frame, or on a 2-D mesh its
    block of the frames."""

    dep_data: torch.Tensor   # (El, Hd, Wd) deposit inputs, as _LoopArgs
    dep_wht: torch.Tensor
    dep_px: torch.Tensor
    dep_py: torch.Tensor
    dep_fid: torch.Tensor    # (El,) int64 frame of each plane
    dep_ratios: tuple        # (El,) pscale ratio of each plane
    px: torch.Tensor         # (Bl, h, w) cutout pixmaps
    py: torch.Tensor
    img: torch.Tensor        # (Bl, h, w) image cutouts, masks, seg masks
    msk: torch.Tensor
    seg: torch.Tensor
    jac: torch.Tensor        # (Bl, 2, 2) exposure->ref Jacobians
    xy0: torch.Tensor        # (Bl, 2) catalog positions
    w: torch.Tensor          # (Bl,) fit weights before the measurement
    valid: torch.Tensor      # (Bl,) bool
    fid: torch.Tensor        # (Bl,) int64 frame of each row
    # rows a frame of the base set and of the bucket when the block holds
    # whole frames in order (no mesh), else None
    per_frame: tuple | None = None
    big: tuple | None = None  # oversized bucket: (px, py, img, msk, seg,
    #                           tgt, fid, valid), (KBl, ...) each; tgt is
    #                           the global row a slot overrides


def _block(a: _LoopArgs, mesh, cfg: AlignConfig, dri_ratios,
           spatial=None) -> _Block:
    """``a`` flattened to (frame, source) rows: all of it without a mesh,
    else this rank's block of the frames and of the rows, each padded to
    a multiple of the mesh size. Under a 2-D spatial mesh the frames are
    split over its frames axis and the rows are not."""
    E, N = a.cut_px.shape[:2]
    D, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    Df, rf = D, rank
    if spatial is not None and len(spatial.axis_names) == 2:
        fax = spatial.axis_names[0]
        Df, rf = spatial.shape[fax], spatial.index(fax)
    El = -(-E // Df)
    dev = a.cut_px.device
    fid = np.minimum(np.arange(El * Df), E - 1)[rf * El:(rf + 1) * El]

    def shard(t, fill=0, D=D, rank=rank):
        if D == 1:
            return t
        t = pad_to_multiple(t, D, fill=fill)[0]
        k = t.shape[0] // D
        return t[rank * k:(rank + 1) * k]

    def flat(t):  # (E, n, ...) -> (E·n, ...)
        return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))

    fw = a.src_valid.to(torch.float32)
    if cfg.use_weights:
        fw = fw * a.src_w
    big, NBp = None, 0
    if a.big is not None:
        cpx, cpy, bimg, bmsk, bseg, bidx, bval = a.big
        NBp = bidx.shape[0]
        eidx = torch.arange(E, device=dev)[:, None]
        big = tuple(shard(flat(t), fill) for t, fill in (
            (cpx, 0), (cpy, 0), (bimg, 0), (bmsk, False), (bseg, 0),
            (eidx * N + bidx[None], 0), (eidx.expand(E, NBp), 0),
            (bval[None].expand(E, NBp), False)))
    return _Block(
        *(shard(t, D=Df, rank=rf)
          for t in (a.exp_data, a.exp_wht, a.dri_px, a.dri_py)),
        dep_fid=torch.as_tensor(fid, device=dev),
        dep_ratios=tuple(dri_ratios[f] for f in fid),
        px=shard(flat(a.cut_px)), py=shard(flat(a.cut_py)),
        img=shard(flat(a.img_cut)), msk=shard(flat(a.img_msk), False),
        seg=shard(flat(a.seg_cut)), jac=shard(flat(a.jac)),
        xy0=shard(flat(a.xy0)), w=shard(flat(fw)),
        valid=shard(flat(a.src_valid), False),
        fid=shard(torch.arange(E, device=dev).repeat_interleave(N)),
        per_frame=(N, NBp) if mesh is None else None, big=big)


def _step(cfg: AlignConfig, out_shape, cut_shape, big_shape, b: _Block,
          Ms: torch.Tensor, ts: torch.Tensor, mesh=None,
          track_corr: bool = False, spatial=None):
    """One iteration: re-drizzle, blot, measure, fit, compose.

    Under ``wcsupdate='otf'`` with more than one exposure the reference is
    re-drizzled with the current state before each exposure is measured
    and fitted, and that exposure's state is updated before the next.

    ``b`` holds this device's frames and cutout rows: their re-drizzle is
    one kernel B1 launch (a pscale ratio per plane), their blot kernel B2
    and their measurement kernel B3 (``usfac > 1``). Under ``mesh=`` every
    rank runs this on its block, and the sci / weight accumulators, the
    bucket's override, the escapes, the fits' moments and the eps_shift
    sums are ``all_reduce``-d over the ranks (without a mesh each
    reduction is the identity), so every rank holds the same fits and
    composes the same state. Ranks must take every decision alike, or a
    collective waits forever: every value the host branches on
    (``max_shift``, ``max_corr``, the escapes) is reduced here, and the
    collectives run in the same order on every rank. Only ``all_reduce``
    is used: gloo (ranks sharing one card) takes CUDA tensors for it, not
    for ``all_gather``.

    Under a spatial mesh (``spatial``: a ``Drizzle(spatial_mesh=...)``'s
    mesh) the reference is this rank's row band: its frames (every frame,
    or on a 2-D mesh its block of them, the band then summed over the
    frames axis) are re-drizzled into the band by one kernel B1 launch,
    and every row is blotted through ``parallel.sample_spatial`` (kernel
    B2 on the halo-extended band, the partials summed over the bands), so
    every rank measures and fits the whole batch alike; ``max_shift`` and
    ``max_corr`` are taken as their largest over the ranks, so that every
    rank ends the loop at the same iteration.

    Returns ``(newM, newt, info)``; ``info`` holds the per-exposure fit
    (G_M, G_t, rms, rmse, mae, nmatches), ``max_shift`` (the eps_shift
    metric), the kernels' ``escaped`` counts and, with ``track_corr``
    (only the compacted deposit reads it), ``max_corr``: how far any
    cutout window has moved from its setup position, the sparse deposit's
    staleness signal."""
    dev = Ms.device
    E = Ms.shape[0]
    group = None if mesh is None else mesh.group()
    psum = _reducer(group)
    # the group whose ranks must agree on a largest value
    group_max = group if spatial is None or spatial.size == 1 \
        else spatial.group()
    sampler = None
    if spatial is not None:
        sampler = functools.partial(sample_spatial, spatial,
                                    logical_rows=out_shape[0],
                                    use_pallas=cfg.use_pallas,
                                    return_escaped=True)
    Bl = b.px.shape[0]
    off, Bg = (0, Bl) if mesh is None else (mesh.rank * Bl, mesh.size * Bl)
    meas_kw = dict(interp=cfg.interp, cc_type=cfg.cc_type, usfac=cfg.usfac,
                   peak_fit_box=cfg.peak_fit_box, fit_type=cfg.fit_type,
                   peak_search_box=cfg.peak_search_box,
                   use_pallas=cfg.use_pallas)

    def per_frame(v, fid):  # (E,) int32 sums of v over the rows' frames
        return torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
            0, fid, v.to(torch.int32))

    def measure(M_, t_, e=None):
        """The reference re-drizzled at state (M_, t_) and the block's
        rows (frame e's alone, given e and whole frames) blotted and
        measured against it: (rows, uv, weights, escapes (E,))."""
        px, py = _affine_apply_grid(M_[b.dep_fid], t_[b.dep_fid], b.dep_px,
                                    b.dep_py)
        if spatial is None:
            sci, wht, esc_d = drizzle_deposit_stack(
                b.dep_data, b.dep_wht, px, py, out_shape,
                pixfrac=cfg.pixfrac, pscale_ratio=b.dep_ratios,
                kernel=cfg.kernel, use_pallas=cfg.use_pallas)
            drz = drizzle_combine(psum(sci), psum(wht))
        else:  # this rank's band
            sci, wht = _deposit_band(spatial, b.dep_data, b.dep_wht, px, py,
                                     out_shape, cfg.pixfrac, b.dep_ratios,
                                     cfg.kernel, sum_frames=True,
                                     use_pallas=cfg.use_pallas)
            drz = drizzle_combine(sci, wht)
            esc_d = torch.zeros(b.dep_data.shape[0], dtype=torch.int32,
                                device=dev)
        rows = brows = slice(None)
        if e is not None and b.per_frame is not None:
            n, nb = b.per_frame
            rows, brows = slice(e * n, (e + 1) * n), slice(e * nb, (e + 1) * nb)
        fid = b.fid[rows]
        Mi, ti = M_[fid], t_[fid]
        seg = b.seg[rows] if cfg.combine_seg_mask else None
        d, besc = blot_measure(drz, Mi, ti, b.px[rows], b.py[rows],
                               b.img[rows], b.msk[rows], seg,
                               sampler=sampler, **meas_kw)
        dxy = torch.stack([d.dx, d.dy], dim=-1)
        good = (d.fit_ok & (d.peak > 0)).to(torch.float32)
        esc = per_frame(esc_d, b.dep_fid) + per_frame(besc, fid)
        if b.big is not None:
            # oversized-footprint bucket: sources whose footprint exceeds
            # the base cutout are re-measured whole at a second static
            # shape and override their base rows (tgt, a global row)
            # through a one-hot product summed over the ranks, of which
            # each rank reads its own rows back out (an index_put_ with
            # padded duplicate indices has no defined order)
            bpx, bpy, bimg, bmsk, bseg, btgt, bfid, bval = (
                v[brows] for v in b.big)
            dB, escB = blot_measure(
                drz, M_[bfid], t_[bfid], bpx, bpy, bimg, bmsk,
                bseg if cfg.combine_seg_mask else None, sampler=sampler,
                **meas_kw)
            goodB = (dB.fit_ok & (dB.peak > 0)).to(torch.float32)
            ohB = ((btgt[:, None] == torch.arange(Bg, device=dev)[None])
                   & bval[:, None]).to(torch.float32)         # (KB, Bg)
            over = psum(torch.cat([
                torch.einsum("kb,kj->bj", ohB,
                             torch.stack([dB.dx, dB.dy], dim=-1)),
                torch.einsum("kb,k->b", ohB, goodB)[:, None],
                ohB.sum(0)[:, None]], 1))[off:off + Bl][rows]
            anyb = over[:, 3] > 0.5
            dxy = torch.where(anyb[:, None], over[:, :2], dxy)
            good = torch.where(anyb, over[:, 2], good)
            esc = esc + per_frame(escB * bval, bfid)
        MJ = torch.einsum("nij,njk->nik", Mi, b.jac[rows])
        uv = b.xy0[rows] + torch.einsum("nik,nk->ni", MJ, dxy)
        return rows, uv, b.w[rows] * good, psum(esc)

    # ---- per-exposure sigma-clipped fits in the reference frame ----
    # displacement in ref-frame px: duv = (M_e @ J_{e,n}) @ d_{e,n}; the
    # fit G maps the measured positions xy0 + duv back onto xy0, so the
    # true fixed point d = 0 gives G = I
    fit_kw = dict(fitgeom=cfg.fitgeom, nclip=cfg.nclip, sigma=cfg.sigma,
                  group=group)
    if cfg.wcsupdate == "otf" and E > 1:
        # update as you go: each exposure is measured against the
        # reference rebuilt with every earlier exposure's update of this
        # iteration. The state at exposure e's measurement is still its
        # iteration-start (Ms[e], ts[e]) — only other exposures' updates
        # moved the reference — so these fits are the iteration's fits.
        # A rank's block holds parts of frames, so under a mesh every
        # sub-step measures the whole block and reads exposure e's fit
        cur_M, cur_t = Ms, ts
        uv = torch.zeros((Bl, 2), device=dev)
        wgt = torch.zeros(Bl, device=dev)
        recs, esc_l = [], []
        for e in range(E):
            rows, uv_e, wgt_e, esc_e = measure(cur_M, cur_t, e)
            fit_e = iter_linear_fit_frames(uv_e, b.xy0[rows], b.fid[rows],
                                           E, wxy=wgt_e, **fit_kw)
            newMe = fit_e.matrix[e] @ cur_M[e]
            newte = fit_e.matrix[e] @ cur_t[e] + fit_e.shift[e]
            cur_M = torch.cat([cur_M[:e], newMe[None], cur_M[e + 1:]])
            cur_t = torch.cat([cur_t[:e], newte[None], cur_t[e + 1:]])
            sel = b.fid[rows] == e
            uv[rows] = torch.where(sel[:, None], uv_e, uv[rows])
            wgt[rows] = torch.where(sel, wgt_e, wgt[rows])
            recs.append([v[e] for v in fit_e[:-1]])
            esc_l.append(esc_e[e])
        fit = LinearFitResult(*(torch.stack(v) for v in zip(*recs)), wgt)
        newM, newt = cur_M, cur_t
        escaped = torch.stack(esc_l)
    else:
        _, uv, wgt, escaped = measure(Ms, ts)
        fit = iter_linear_fit_frames(uv, b.xy0, b.fid, E, wxy=wgt, **fit_kw)
        newM = torch.einsum("eij,ejk->eik", fit.matrix, Ms)
        newt = torch.einsum("eij,ej->ei", fit.matrix, ts) + fit.shift
    G_M, G_t = fit.matrix, fit.shift

    # ---- eps_shift metric: rms incremental source motion, with the
    # common-mode motion of a multi-exposure stack projected out ----
    moved = (torch.einsum("nij,nj->ni", G_M[b.fid], uv) + G_t[b.fid]
             - uv)
    if E > 1:
        red = psum(torch.cat([wgt.sum()[None],
                              (wgt[:, None] * moved).sum(0)]))
        moved = moved - red[1:][None] / torch.clamp(red[0], min=1e-12)
    move2 = (moved * moved).sum(-1)
    oh = (b.fid[:, None] == torch.arange(E, device=dev)[None]).to(
        torch.float32)                                        # (Bl, E)
    red = psum(torch.stack([(oh * wgt[:, None]).sum(0),
                            (oh * (wgt * move2)[:, None]).sum(0)]))
    rms_move = torch.sqrt(red[1] / torch.clamp(red[0], min=1e-12))

    max_shift = rms_move.max()[None]
    if group_max is not group:
        dist.all_reduce(max_shift, op=dist.ReduceOp.MAX, group=group_max)
    info = dict(G_M=G_M, G_t=G_t, rms=fit.rms, rmse=fit.rmse, mae=fit.mae,
                nmatches=fit.nmatches, max_shift=max_shift[0],
                escaped=escaped)
    if track_corr:
        # ---- total correction magnitude: an upper bound on how far
        # any cutout's blot window has moved from its setup position ----
        dM = newM - torch.eye(2, dtype=newM.dtype, device=dev)[None]
        dpts = torch.einsum("nij,nj->ni", dM[b.fid], b.xy0) + newt[b.fid]
        dnorm = torch.where(b.valid, torch.sqrt((dpts * dpts).sum(-1)),
                            torch.zeros_like(dpts[:, 0]))
        maxdim = max(cut_shape) if big_shape is None else max(*cut_shape,
                                                              *big_shape)
        dmax = torch.stack([dnorm.max(), dM.abs().sum(dim=(1, 2)).max()])
        if group_max is not None:
            dist.all_reduce(dmax, op=dist.ReduceOp.MAX, group=group_max)
        info["max_corr"] = dmax[0] + dmax[1] * (maxdim * 0.5)
    return newM, newt, info


#: the device loop's host reads on a card and under a mesh: every this
#: many iterations, and at the end of an entry (the cadence at which the
#: device source finder reads its fixed points)
READ_EVERY = 4

#: captured loops kept for later calls (the JAX package's ``_LOOP_CACHE``):
#: key -> :class:`_Graph`, oldest first. A key holds everything the
#: captured step's launches depend on (the config, the device, the shapes
#: of the step's inputs and its host-side constants; under a mesh its
#: process groups, their backend, the rank and the mesh's axes), so a
#: later call that matches copies its inputs into the entry's and
#: replays. An entry holds its graph's memory and a copy of the inputs,
#: so only a few are kept. A step whose functions are patched between
#: calls must clear it.
_LOOP_CACHE: dict = {}
_LOOP_CACHE_MAX = 4

@dataclasses.dataclass
class _Graph:
    """One captured masked step (with the kernels' launches one replay
    makes) and the static buffers it reads and writes: the block's
    tensors, the state, the loop's store; and under a mesh the process
    groups whose communicators its collectives run on (held, so that a
    group's identity in the key is never another group's)."""

    graph: Captured
    block: _Block
    Ms: torch.Tensor
    ts: torch.Tensor
    store: torch.Tensor
    groups: tuple = ()


def _mesh_groups(mesh) -> tuple:
    """The distinct process groups of a mesh: the whole group and the
    line of each axis."""
    out = []
    for g in [mesh.group()] + [mesh.group(a) for a in mesh.axis_names]:
        if all(g is not o for o in out):
            out.append(g)
    return tuple(out)


def _group_alive(group) -> bool:
    """Whether ``group`` is still a process group of this process (not
    destroyed)."""
    try:
        dist.get_backend(group)
    except (ValueError, RuntimeError):
        return False
    return True


def _capturable(mesh) -> bool:
    """Whether a CUDA graph can hold a mesh's collectives: NCCL's are
    kernels on the card; gloo's go through the host."""
    return all(dist.get_backend(g) == "nccl" for g in _mesh_groups(mesh))


def _mesh_key(mesh) -> tuple:
    """A mesh's part of a loop's cache key: its groups (by identity; an
    entry holds them), their backend, this rank, and the axes."""
    groups = _mesh_groups(mesh)
    return (tuple(id(g) for g in groups),
            tuple(str(dist.get_backend(g)) for g in groups), mesh.rank,
            tuple(mesh.shape.items()))


def _all_ranks_hold(held: bool, mesh, device) -> bool:
    """Whether every rank of ``mesh`` holds the loop's graph: one MIN
    ``all_reduce`` of the ranks' flags, read on the host. Every rank then
    replays, or every rank captures: a rank that captured while the
    others replayed would run an eager step's collectives against their
    graphs' and hang or desynchronise the group."""
    flag = torch.full((1,), int(held), dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group())
    return bool(tracing.to_host(flag).item())


def _block_tensors(b: _Block | None) -> tuple[list, tuple]:
    """The tensors of ``b`` in field order (the bucket's one by one), and
    its other fields as (name, value) pairs; none for no block."""
    tensors, rest = [], []
    for f in dataclasses.fields(b) if b is not None else ():
        v = getattr(b, f.name)
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        elif f.name == "big" and v is not None:
            tensors.extend(v)
        else:
            rest.append((f.name, v))
    return tensors, tuple(rest)


def _clone_block(b: _Block | None) -> _Block | None:
    """``b`` with each tensor copied into new contiguous memory."""
    if b is None:
        return None
    c = dataclasses.replace(b)
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if isinstance(v, torch.Tensor):
            setattr(c, f.name, v.clone(memory_format=torch.contiguous_format))
        elif f.name == "big" and v is not None:
            c.big = tuple(t.clone(memory_format=torch.contiguous_format)
                          for t in v)
    return c


def _fixed_point(step, blk: _Block | None, Ms: torch.Tensor, ts: torch.Tensor,
                 fields: dict, T: int, eps: float, breakdown: dict,
                 graph_key=None, every: int | None = None, mesh=None,
                 capture: bool = True):
    """Up to ``T`` iterations of ``step(blk, Ms, ts) -> (Ms', ts', info)``
    from the state (Ms, ts), stopping after the first whose
    ``info['max_shift']`` is below ``eps``: the JAX package's
    ``_build_device_loop``.

    The state, an int32 iteration count, a done flag and the history
    (``fields``: name -> (shape, dtype) of the ``info`` entries recorded
    each iteration) live in static device buffers. Each call runs the
    masked step: ``step`` where the loop has not ended, and where it has,
    no change, so the iteration that converges keeps its own result. The
    host reads the count, the flag and the history in one copy every
    ``every`` iterations and at the end: :data:`READ_EVERY` with a graph
    or a ``mesh`` (the mesh the step's collectives run over: ``mesh=``'s
    or a spatial mesh), else 1 (one device, no graph). Between reads it
    only enqueues, and the steps after ``done`` change nothing; under a
    mesh every rank enqueues the same steps, so the ranks' collectives
    stay in step.

    ``graph_key`` (a CUDA device's loop: the step's host-side constants)
    runs the loop as a CUDA graph when ``T`` > 1, ``capture`` holds and
    there is no mesh or its groups are NCCL's (gloo's collectives go
    through the host and cannot be captured: such a mesh runs the masked
    step eagerly). Where :data:`_LOOP_CACHE` holds a graph for the key
    and the block's shapes, the call copies its block and state into
    that graph's buffers and replays it for every iteration. Otherwise
    the first iteration runs eagerly on a side stream (the warm-up
    capture needs: kernel builds, B3's plans, the cached constants,
    cuFFT plans, cuBLAS workspaces and the groups' NCCL communicators) on
    copies of the block, and, unless it converged, the masked step is
    captured once with ``torch.cuda.CUDAGraph``, its collectives with
    it, replayed for the other iterations and cached. Under a mesh the
    ranks first agree (:func:`_all_ranks_hold`: one read) to replay or
    to capture together, and that read stands in for the one after the
    eager step, so a capture follows it whatever it gave. A capture that
    fails raises. The kernels' launch counts (``kernels.LAUNCHES``)
    leave out the capture's own wrapper calls and add the graph's
    launches at every replay.

    Adds to ``breakdown``: ``loop_steps`` (masked steps run),
    ``loop_host_reads``, and with a graph ``loop_compile`` (the seconds
    spent capturing, or copying the inputs into a cached graph: the JAX
    package's key for its loop's compile), ``loop_graphs`` (captures),
    ``loop_graph_hits`` (entries served by a cached graph) and
    ``loop_replays``; its reads count under ``host_syncs`` in the current
    record (:mod:`~subpixal_tpu_torch.tracing`). Returns ``(Ms, ts, n_new,
    converged, hist, iter_s)``: ``hist`` maps each field to its first
    ``n_new`` rows (numpy), ``iter_s`` is the entry's wall time to its
    last read, less ``loop_compile``'s share, over ``n_new``.
    """
    if T < 1:  # as the reference's while_loop: no iteration at all
        return (Ms, ts, 0, False, {
            k: torch.zeros((0,) + tuple(shape), dtype=dt).numpy()
            for k, (shape, dt) in fields.items()}, 0.0)
    dev = Ms.device
    graph = (graph_key is not None and T > 1 and capture
             and (mesh is None or _capturable(mesh)))
    every = every or (READ_EVERY if graph or mesh is not None else 1)
    # one int32 store, [iteration count, done, history...], the float
    # fields as their bits: one copy reads the whole loop state
    sizes = [T * math.prod(shape) for shape, _ in fields.values()]

    def views(s):
        out, o = {}, 2
        for (k, (shape, dt)), n in zip(fields.items(), sizes):
            v = s[o:o + n]
            out[k] = (v if dt == torch.int32 else v.view(dt)).view(
                (T,) + tuple(shape))
            o += n
        return out

    t0 = time.perf_counter()
    tensors, rest = _block_tensors(blk)
    key = graph and (graph_key, dev, T, float(eps), tuple(fields.items()),
                     rest, tuple((t.shape, t.dtype) for t in tensors),
                     None if mesh is None else _mesh_key(mesh))
    steps = reads = 0
    hit = None
    if graph:
        # entries whose groups were destroyed can never match again
        for k in [k for k, e in _LOOP_CACHE.items()
                  if not all(map(_group_alive, e.groups))]:
            del _LOOP_CACHE[k]
        hit = _LOOP_CACHE.pop(key, None)
        if mesh is not None:
            reads = 1
            if not _all_ranks_hold(hit is not None, mesh, dev):
                hit = None  # every rank captures anew
    if hit is not None:  # refresh its place, then copy this call in
        _LOOP_CACHE[key] = hit
        for dst, src in zip(_block_tensors(hit.block)[0], tensors):
            dst.copy_(src)
        hit.Ms.copy_(Ms)
        hit.ts.copy_(ts)
        hit.store.zero_()
        blk, Ms, ts, store = hit.block, hit.Ms, hit.ts, hit.store
    else:
        if graph:
            blk = _clone_block(blk)
        store = torch.zeros(2 + sum(sizes), dtype=torch.int32, device=dev)
        Ms, ts = Ms.clone(), ts.clone()
    hist = views(store)

    def masked():
        newM, newt, info = step(blk, Ms, ts)
        live = store[1:2] == 0
        at = store[0:1].long()
        for k, buf in hist.items():
            new = torch.where(live, info[k].to(buf.dtype),
                              buf.index_select(0, at)[0])
            buf.index_copy_(0, at, new.reshape((1,) + buf.shape[1:]))
        Ms.copy_(torch.where(live, newM, Ms))
        ts.copy_(torch.where(live, newt, ts))
        store[1:2] |= (live & (info["max_shift"] < eps)).to(torch.int32)
        store[0:1] += live.to(torch.int32)

    compile_s, captured = 0.0, 0
    h = None
    if hit is not None:
        compile_s = time.perf_counter() - t0
        run = hit.graph.replay
    elif graph:
        # the first step, eagerly on the side stream and waited for:
        # nothing (no collective either) is in flight when a capture begins
        warm_up(masked, dev)
        steps = 1
        if mesh is None:
            h = store.to("cpu", copy=True)
            reads += 1
        if h is None or not bool(h[1]):
            t_c = time.perf_counter()
            entry = _Graph(capture_graph(masked, dev), blk, Ms, ts, store,
                           () if mesh is None else _mesh_groups(mesh))
            _LOOP_CACHE[key] = entry
            while len(_LOOP_CACHE) > _LOOP_CACHE_MAX:
                _LOOP_CACHE.pop(next(iter(_LOOP_CACHE)))
            compile_s = time.perf_counter() - t_c
            captured = 1
            run = entry.graph.replay
    else:
        run = masked
    while h is None or not (steps == T or bool(h[1])):
        run()
        steps += 1
        if steps == T or steps % every == 0:
            h = store.to("cpu", copy=True)
            reads += 1
    n_new = int(h[0])
    iter_s = (time.perf_counter() - t0 - compile_s) / max(n_new, 1)
    tracing.count(tracing.HOST_SYNCS, reads)
    out = {"loop_steps": steps, "loop_host_reads": reads}
    if graph:
        out.update(loop_compile=compile_s, loop_graphs=captured,
                   loop_graph_hits=int(hit is not None),
                   loop_replays=steps - (hit is None))
    for k, v in out.items():
        breakdown[k] = breakdown.get(k, 0) + v
    return (Ms.clone(), ts.clone(), n_new, bool(h[1]),
            {k: v[:n_new].numpy() for k, v in views(h).items()}, iter_s)


def _canon(dev) -> torch.device:
    """``dev`` with its index: a CUDA device named without one is the
    current device (under a mesh, this rank's card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _broadcast_catalogs(cats, seg_planes, mesh):
    """Rank 0's catalog tables and segmentation planes, on every rank.

    Every rank runs the setup, but on the card kernel B1's atomics sum
    in an order that changes from run to run, so two ranks' drizzled
    references, and the catalogs found on them, may differ in their last
    bits. Every shape the loop's collectives depend on (the source count,
    the cutout shape, the bucket) is derived from the catalog: ranks that
    disagreed on it would wait on each other forever."""
    obj = [(cats, [None if isinstance(sp, torch.Tensor) else sp
                   for sp in seg_planes])]
    dist.broadcast_object_list(obj, src=0, group=mesh.group())
    cats, host = obj[0]
    out = []
    for sp, hp in zip(seg_planes, host):
        if isinstance(sp, torch.Tensor):
            sp = sp.contiguous()
            dist.broadcast(sp, src=0, group=mesh.group())
        out.append(sp if isinstance(sp, torch.Tensor) else hp)
    return cats, out


@full_f32()
def align_images(
    catalogs: ImageCatalog | Sequence[ImageCatalog] | None = None,
    resample: Drizzle | None = None,
    *,
    exposures: Sequence[Exposure] | None = None,
    cc_type: str = "NCC",
    fitgeom: str = "general",
    nclip: int = 3,
    sigma: float = 3.0,
    use_weights: bool = True,
    combine_seg_mask: bool = True,
    wcsupdate: str = "batch",
    max_iterations: int = 10,
    eps_shift: float = 0.004,
    history: str = "all",
    config: AlignConfig | None = None,
    verbose: bool = False,
    mesh=None,
    device="cuda",
    **kw: Any,
) -> AlignResult:
    """Iteratively align exposures to their combined reference image.

    Parameters mirror the JAX package's ``align_images``. ``resample`` is
    a :class:`~subpixal_tpu_torch.resample.Drizzle` holding the
    exposures, or pass ``exposures=`` and one is built on ``device``.
    ``catalogs`` may be an :class:`ImageCatalog` (or a list of them) for
    the reference image; ``None`` runs a source finder on the first
    drizzle product: under ``device_catalog='auto'`` the device finder on
    CUDA and the host finder on the CPU (``'device'`` / ``'host'`` force
    one). ``device`` ('cuda' by default) runs the loop; a given
    ``resample`` must live on the same device. ``verbose`` runs the host
    loop and prints each iteration's records as JSON. Input exposures are
    not mutated: corrected copies are returned.

    ``mesh`` (a :class:`~subpixal_tpu_torch.parallel.Mesh`, from
    ``parallel.make_mesh``) runs every iteration over the ranks of its
    process group, one device each: every rank calls ``align_images``
    with the same arguments, runs the setup, and takes its block of the
    frames for the re-drizzle and of the (frame, source) cutout batch for
    the measurement; the accumulators and the fits' moments are summed
    over the ranks, so every rank returns the same result. The loop runs
    on ``mesh.device``, whose type ``device`` must name. Both
    ``wcsupdate`` modes, the oversized bucket and the sparse deposit run
    under a mesh.

    A ``resample`` built with ``spatial_mesh=`` (a 1-D rows mesh, or a
    2-D ``parallel.make_mesh2d`` mesh) runs the loop with the reference
    plane row-band-sharded over it: every rank of that mesh calls
    ``align_images`` with the same arguments (and its own Drizzle),
    re-drizzles its frames (every frame, or on a 2-D mesh its block of
    them) into its band, and blots every cutout from the bands; the
    measurement and the fits are replicated, so every rank returns the
    same result, whose ``drizzle`` keeps the spatial mesh. The default
    catalog is the band-local finder on CUDA (``device_catalog='auto'``)
    and anywhere under ``'device'``; on the CPU ``'auto'`` runs the host
    finder on the gathered plane. ``mesh=`` with a spatial Drizzle raises
    ``ValueError``.

    The result's ``setup_breakdown`` is the call's record
    (:mod:`~subpixal_tpu_torch.tracing`): each stage's host seconds under
    its span's name (``align.call``, ``align.setup`` and its stages,
    ``align.geometry``, ``align.loop``, ``align.writeback``), on CUDA each
    device span's ``<name>.device`` seconds, and the counters
    (``host_syncs``, ``catalog.sources``, ``cutout.rows``,
    ``cutout.cols``, ``stack_inputs.reused``, the loop's ``loop_*``);
    ``setup_s`` is ``align.setup``'s seconds.
    """
    breakdown: dict = {}
    with tracing.recording(breakdown, device_events=True), \
            tracing.span("align.call", rest="align.unspanned"):
        if config is None:
            config = AlignConfig(
                cc_type=cc_type, fitgeom=fitgeom, nclip=nclip, sigma=sigma,
                use_weights=use_weights, combine_seg_mask=combine_seg_mask,
                wcsupdate=wcsupdate, max_iterations=max_iterations,
                eps_shift=eps_shift, history=history, **kw)
        res = _align(catalogs, resample, exposures, config, verbose, mesh,
                     device, breakdown)
        tracing.read_device()  # after the write-back's host reads
    return res


def _align(catalogs, resample, exposures, cfg: AlignConfig, verbose: bool,
           mesh, device, setup_breakdown: dict) -> AlignResult:
    """:func:`align_images`' body, inside its record ``setup_breakdown``."""
    _check_config(cfg)
    dev = torch.device(device)
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"mesh runs on {mesh.device}, but "
                             f"device={device}")
        dev = mesh.device
        if getattr(resample, "spatial_mesh", None) is not None:
            raise ValueError(
                "mesh= (frame-sharded align) and a spatial_mesh Drizzle "
                "(row-band-sharded reference plane) are mutually exclusive "
                "— the two shard the same devices differently")
    _use_pallas(cfg.use_pallas, dev)  # use_pallas=True off CUDA raises

    if resample is None:
        if exposures is None:
            raise ValueError("provide `resample` (Drizzle) or `exposures`")
        resample = Drizzle(list(exposures), pixfrac=cfg.pixfrac,
                           kernel=cfg.kernel, use_pallas=cfg.use_pallas,
                           wht_type=cfg.wht_type, device=dev)
    elif _canon(resample.device) != _canon(dev):
        raise ValueError(f"resample lives on {resample.device}, but "
                         f"device={dev}")
    # a spatial Drizzle: the reference plane is row-band-sharded over this
    # mesh, one band a rank (parallel/spatial.py)
    spatial = getattr(resample, "spatial_mesh", None)
    if cfg.match_sky or cfg.static_mask or cfg.reject_cr:
        # the stages rebind data and weights: the caller's Exposure
        # objects stay untouched
        resample.exposures = [e.copy() for e in resample.exposures]
    exps = list(resample.exposures)
    if not exps:
        raise ValueError("no exposures to align")

    span = tracing.span
    # the set-up, each stage a span of its own; setup_s is its seconds
    setup = span("align.setup").open()
    # -- the AstroDrizzle stages and the initial reference image -------- #
    # (each stage's time is its own key; the JAX package counts them in
    # 'resample_execute'; Drizzle.execute's stages come in as resample.*)
    if cfg.match_sky:
        with span("match_sky"):
            resample.match_sky(skymethod=cfg.skymethod)
    if cfg.static_mask:
        with span("static_mask"):
            resample.apply_static_mask()
    if (catalogs is None and cfg.device_catalog in ("auto", "device")
            and dev.type == "cuda" and spatial is None):
        # the device finder's programs for the reference's shape, before
        # the first deposit, where the JAX package warms them
        with span("catalog_warm_compile"):
            resample._ensure_output_grid()
            _cat_warm(tuple(resample.output_shape),
                      nsigma=cfg.catalog_nsigma, npixels=cfg.catalog_npixels,
                      window=cfg.catalog_window,
                      max_sources=cfg.catalog_max_sources, device=dev)
    with span("resample_execute"):
        resample.execute()
    if cfg.reject_cr and len(resample.exposures) >= 3:
        with span("reject_cr"):
            resample.reject_cr()  # and the re-drizzle without the CRs
    ref_wcs = resample.output_wcs
    out_shape = resample.output_shape
    # the default catalog on the device finder ('auto': on CUDA, as the
    # JAX package takes it on any accelerator): the drizzled reference
    # never crosses to the host. Under a spatial mesh that finder is the
    # band-local one (catalogs_spatial), and the host finder reads the
    # gathered plane
    use_dev_catalog = catalogs is None and (
        cfg.device_catalog == "device"
        or (cfg.device_catalog == "auto" and dev.type == "cuda"))
    use_spatial_catalog = use_dev_catalog and spatial is not None
    use_dev_catalog = use_dev_catalog and spatial is None
    with span("output_sci", device=dev):
        if use_dev_catalog or use_spatial_catalog:
            drz_sci = None
            drz_sci_dev = drizzle_combine(resample._sci_acc,
                                          resample._wht_acc,
                                          fill=resample.fillval)
        else:
            drz_sci = resample.output_sci

    with span("catalog"):  # ended by the table's read
        if use_spatial_catalog:
            cat_list = [SpatialSourceCatalog(
                spatial, drz_sci_dev, out_shape[0],
                nsigma=cfg.catalog_nsigma, npixels=cfg.catalog_npixels,
                max_sources=cfg.catalog_max_sources,
                window=cfg.catalog_window)]
        elif catalogs is None:
            cat_list = [DeviceSourceCatalog(
                drz_sci_dev, nsigma=cfg.catalog_nsigma,
                npixels=cfg.catalog_npixels,
                max_sources=cfg.catalog_max_sources,
                window=cfg.catalog_window) if use_dev_catalog
                else ImageSourceCatalog(drz_sci, nsigma=cfg.catalog_nsigma,
                                        npixels=cfg.catalog_npixels)]
        elif isinstance(catalogs, (list, tuple)):
            cat_list = list(catalogs)
        else:
            cat_list = [catalogs]
        if not cat_list:
            raise ValueError("catalogs must not be an empty sequence")
        cats = [c.catalog for c in cat_list]
        # device-resident segmentation planes are preferred (no host copy)
        seg_planes = [c.segmentation_device
                      if getattr(c, "segmentation_device", None) is not None
                      else c.segmentation for c in cat_list]
        if mesh is not None and mesh.size > 1:
            cats, seg_planes = _broadcast_catalogs(cats, seg_planes, mesh)
    have_seg = any(s is not None for s in seg_planes)
    n_tot = sum(len(c) for c in cats)
    tracing.count("catalog.sources", n_tot)
    if n_tot < cfg.min_sources:
        raise ValueError(
            f"only {n_tot} sources found (need >= {cfg.min_sources})")

    with span("primary_cutouts"):
        prim = []
        src_cat_l: list[int] = []
        for ci, (cat, seg_i) in enumerate(zip(cats, seg_planes)):
            # the device catalog's cutouts come from its table alone:
            # setup reads only their shapes, ids, positions and fluxes
            p_i = _prim_meta_from_catalog(cat, out_shape) \
                if use_dev_catalog or use_spatial_catalog \
                else create_primary_cutouts(
                    cat, seg_i if seg_i is not None
                    else np.zeros(out_shape, np.int32),
                    drz_sci, ref_wcs, combine_seg_mask=False)
            prim.extend(p_i)
            src_cat_l.extend([ci] * len(p_i))
    if len(prim) < cfg.min_sources:
        raise ValueError("too few usable primary cutouts")

    # the host geometry: the cutout shape and windows, the predicted
    # positions, the f64 Jacobians or pixmaps, the corner bboxes
    geometry = span("align.geometry").open()
    # -- static cutout shape, and the oversized-footprint bucket -------- #
    if cfg.cutout_shape is None:
        mh = max(c.data.shape[0] for c in prim)
        mw = max(c.data.shape[1] for c in prim)
        # bucketed to 16 so similar scenes share one geometry
        s = int(np.ceil(max(mh + 4, mw + 4, 16) / 16) * 16)
        cut_shape = (min(s, cfg.max_cut_size), min(s, cfg.max_cut_size))
    else:
        cut_shape = tuple(cfg.cutout_shape)
    h, w = cut_shape
    tracing.count("cutout.rows", h)
    tracing.count("cutout.cols", w)
    # sources whose footprint exceeds the static shape are re-measured
    # whole in a second static-shape bucket; only a footprint beyond the
    # bucket cap still crops (recorded in truncated_sources and warned)
    over_i = [i for i, c in enumerate(prim)
              if c.data.shape[0] > h or c.data.shape[1] > w]
    big_hw = None
    big_src_i: list[int] = []
    if over_i:
        cap = max(_BIG_CAP_FLOOR, 2 * max(h, w))
        need = max(max(prim[i].data.shape) for i in over_i) + 4
        sB = int(np.ceil(min(need, cap) / 16) * 16)
        big_src_i = [i for i in over_i if max(prim[i].data.shape) + 4 <= sB]
        if big_src_i:
            big_hw = (sB, sB)
    in_bucket = set(big_src_i)
    truncated = [prim[i].src_id for i in over_i if i not in in_bucket]
    if truncated:
        warnings.warn(
            f"{len(truncated)} source footprint(s) exceed the static "
            f"cutout shape {cut_shape} and are measured on centered "
            f"crops (src ids: {truncated[:10]}"
            f"{'...' if len(truncated) > 10 else ''}); pass a larger "
            "cutout_shape / max_cut_size to use the full footprints",
            stacklevel=2)
    N = len(prim)
    E = len(exps)

    xy_cat = np.array([c.src_pos_parent for c in prim], np.float64)
    src_ids = np.array([c.src_id for c in prim], np.int64)
    src_cat = np.array(src_cat_l, np.int64)
    seg_ok = np.array([seg_planes[ci] is not None for ci in src_cat_l],
                      bool)
    flux_w = np.array([c.src_weight for c in prim], np.float64)
    flux_w = flux_w / max(flux_w.max(), 1e-12)

    # catalog axis padded to a multiple of 64 as in the JAX package (its
    # compiled programs are sized per catalog size); pads sit at the
    # frame center with zero weight and are invalid
    n_real = N
    N_pad = max(-(-N // 64) * 64, 64)
    if N_pad != N:
        cyc, cxc = out_shape[0] / 2.0, out_shape[1] / 2.0
        xy_cat = np.concatenate(
            [xy_cat, np.tile([[cxc, cyc]], (N_pad - N, 1))])
        src_ids = np.concatenate([src_ids, np.full(N_pad - N, -1, np.int64)])
        src_cat = np.concatenate([src_cat, np.zeros(N_pad - N, np.int64)])
        seg_ok = np.concatenate([seg_ok, np.ones(N_pad - N, bool)])
        flux_w = np.concatenate([flux_w, np.zeros(N_pad - N)])
        N = N_pad
    real_src = np.arange(N) < n_real

    # -- per-exposure static inputs --------------------------------------- #
    # cutout pixmaps: float32 on the device ('auto' on CUDA, as the JAX
    # package on an accelerator) or host float64; frame pixmaps on the
    # device from device_pixmap_min_pixels. Jacobians are host float64.
    use_dev_cut = cfg.cutout_pixmaps == "device" or (
        cfg.cutout_pixmaps == "auto" and dev.type == "cuda")
    host_frames = (exps[0].data.shape[0] * exps[0].data.shape[1]
                   < device_pixmap_min_pixels(dev))
    centers = np.zeros((E, N, 2), np.float32)
    blc_all = np.zeros((E, N, 2), np.float32)
    if not use_dev_cut:
        cut_px = np.zeros((E, N, h, w), np.float32)
        cut_py = np.zeros((E, N, h, w), np.float32)
    # per-cutout ref-frame bboxes from the 4 window corners (host f64,
    # +-1 px curvature pad): they feed the sparse deposit's live set
    cut_bb = tuple(np.zeros((E, N)) for _ in range(4))  # y0, y1, x0, x1
    jac = np.zeros((E, N, 2, 2), np.float32)
    xy0 = np.zeros((E, N, 2), np.float32)
    src_valid = np.zeros((E, N), bool)
    shape0 = tuple(exps[0].data.shape)
    # the rate-data stack the stacked execute just built for these same
    # exposures (keyed on their identities) is reused on the device; the
    # devices compare indexed, as torch.device("cuda") != "cuda:0"
    ds = resample._data_stack
    reuse_data = (ds is not None and _canon(ds.device) == _canon(dev)
                  and resample._data_stack_key == _exposure_stack_key(exps)
                  and tuple(ds.shape) == (E,) + shape0)
    rate_planes: list = []
    wht_scalars = np.ones(E, np.float32)
    wht_planes: list = [None] * E
    dri_maps: list = []
    ra_cat, dec_cat = ref_wcs.pixel_to_world(xy_cat[:, 0], xy_cat[:, 1])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def corner_bboxes(e, bx, by, hh, ww, rows=slice(None)):
        """Reference-frame bboxes of (hh, ww) windows at origins bx, by."""
        cx4 = np.stack([bx, bx + ww - 1, bx, bx + ww - 1]).astype(np.float64)
        cy4 = np.stack([by, by, by + hh - 1, by + hh - 1]).astype(np.float64)
        rx4, ry4 = ref_wcs.world_to_pixel(
            *exps[e].wcs.pixel_to_world(cx4, cy4))
        for k, v in enumerate((np.asarray(ry4).min(0) - 1.0,
                               np.asarray(ry4).max(0) + 1.0,
                               np.asarray(rx4).min(0) - 1.0,
                               np.asarray(rx4).max(0) + 1.0)):
            cut_bb[k][e, rows] = v

    for e, exp in enumerate(exps):
        if tuple(exp.data.shape) != shape0:
            raise ValueError("all exposures must share one shape "
                             "(pad on ingest)")
        if not reuse_data:  # host arrays or tensors, as the exposure holds
            rate_planes.append(exposure_rate_data(exp))
        # weights in their own residence until they are stacked
        wht_scalars[e], wht_planes[e] = _weight_parts(exp, resample.wht_type)
        H, W = exp.data.shape
        with span("frame_pixmaps"):
            if host_frames:  # else one device evaluation after this loop
                dri_maps.append(compute_pixmap(exp.wcs, ref_wcs, (H, W)))
        with span("cutout_pixmaps"):
            # predicted source positions in this exposure
            sx, sy = exp.wcs.world_to_pixel(ra_cat, dec_cat)
            inside = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
            src_valid[e] = inside & real_src
            # cutout windows, fixed for all iterations: the same origin
            # formula as extract_cutouts, floor(f32(c) + 0.5)
            bx = np.floor(sx.astype(np.float32) + 0.5).astype(int) - w // 2
            by = np.floor(sy.astype(np.float32) + 0.5).astype(int) - h // 2
            blc_all[e] = np.stack([bx, by], 1)
            corner_bboxes(e, bx, by, h, w)
            cy, cx2 = h // 2, w // 2
            if use_dev_cut:
                # the grids are built on the device after this loop; the
                # Jacobians (which f32 central differences would corrupt)
                # come from host f64 evaluations at the cutout centers
                ccx = (bx + cx2).astype(np.float64)
                ccy = (by + cy).astype(np.float64)
                rx, ry = ref_wcs.world_to_pixel(*exp.wcs.pixel_to_world(
                    np.concatenate([ccx + 1, ccx - 1, ccx, ccx]),
                    np.concatenate([ccy, ccy, ccy + 1, ccy - 1])))
                rx = np.asarray(rx).reshape(4, N)
                ry = np.asarray(ry).reshape(4, N)
                d = [(rx[0] - rx[1]) / 2.0, (rx[2] - rx[3]) / 2.0,
                     (ry[0] - ry[1]) / 2.0, (ry[2] - ry[3]) / 2.0]
            else:
                # per-cutout pixmaps into the ref frame + Jacobians (one
                # batched (N, h, w) float64 WCS evaluation per exposure)
                ra, dec = exp.wcs.pixel_to_world(
                    xx[None] + bx[:, None, None],
                    yy[None] + by[:, None, None])
                rx, ry = ref_wcs.world_to_pixel(ra, dec)
                cut_px[e] = rx
                cut_py[e] = ry
                d = [(rx[:, cy, cx2 + 1] - rx[:, cy, cx2 - 1]) / 2.0,
                     (rx[:, cy + 1, cx2] - rx[:, cy - 1, cx2]) / 2.0,
                     (ry[:, cy, cx2 + 1] - ry[:, cy, cx2 - 1]) / 2.0,
                     (ry[:, cy + 1, cx2] - ry[:, cy - 1, cx2]) / 2.0]
            jac[e, :, 0, 0], jac[e, :, 0, 1], jac[e, :, 1, 0], \
                jac[e, :, 1, 1] = d
        # initial predictions in the ref frame = catalog positions
        xy0[e] = xy_cat.astype(np.float32)
        centers[e] = np.stack([sx, sy], 1)
    geometry.close()

    def to_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def device_cutout_maps(blc, hw):
        """(E, n, hh, ww) cutout pixmaps on the device."""
        return compute_cutout_pixmaps_device_stack(
            [e.wcs for e in exps], ref_wcs, blc, hw, dev)

    with span("stack_inputs", device=dev):  # the frames' and weights'
        tracing.count("stack_inputs.reused", int(reuse_data))
        exp_data_t = ds if reuse_data else _stack_planes(rate_planes,
                                                          shape0, dev)
        if all(wp is None for wp in wht_planes):
            exp_wht_t = (torch.ones_like(exp_data_t)
                         * to_dev(wht_scalars)[:, None, None])
        else:
            exp_wht_t = _stack_planes(
                [float(wht_scalars[e]) if wp is None
                 else wp * float(wht_scalars[e])
                 for e, wp in enumerate(wht_planes)], shape0, dev)
    with span("cutout_pixmaps", device=dev):
        if use_dev_cut:
            cut_px_t, cut_py_t = device_cutout_maps(blc_all, cut_shape)
        else:
            cut_px_t, cut_py_t = to_dev(cut_px), to_dev(cut_py)
    with span("frame_pixmaps", device=dev):
        if host_frames:
            dri_px_t = to_dev(np.stack([p for p, _ in dri_maps]))
            dri_py_t = to_dev(np.stack([q for _, q in dri_maps]))
        else:
            dri_px_t, dri_py_t = compute_pixmap_device_stack(
                [e.wcs for e in exps], ref_wcs, exps[0].data.shape,
                device=dev)
    def stage(centers_, cpx, cpy, ids_, cat_, ok_, hw):
        """Image cutouts, masks and segmentation masks of a cutout set:
        the program ``device_stage``; under a spatial mesh the masks are
        sampled from the bands by ``sample_spatial``, eagerly."""
        img_, msk_, seg_ = _stage_device_inputs_aot(
            exp_data_t, to_dev(centers_), seg_f_t, cpx, cpy, ids_, cat_, ok_,
            cut_shape=hw, use_seg=have_seg and seg_f_t is not None)
        if seg_f_t is None and have_seg:
            E_, N_ = cpx.shape[:2]
            sseg, _ = sample_spatial(
                spatial, seg_planes[0].to(torch.float32),
                cpx.reshape((E_ * N_,) + tuple(hw)),
                cpy.reshape((E_ * N_,) + tuple(hw)), interp="nearest",
                logical_rows=out_shape[0])
            sseg = sseg.reshape(cpx.shape)
            seg_ = torch.maximum(
                ((sseg - ids_[None, :, None, None]).abs() < 0.5).to(
                    torch.float32),
                (~ok_)[None, :, None, None].to(torch.float32))
        return img_, msk_, seg_

    with span("device_stage", device=dev):
        # (C, H, W) per-catalog segmentation planes as float32 on the
        # device (ids below 2**24 are exact); a device plane stays where
        # it is. The band-local catalog's plane is this rank's band: its
        # masks are sampled from the bands (nearest) by sample_spatial
        seg_f_t = None if use_spatial_catalog else torch.stack([
            torch.zeros(out_shape, dtype=torch.float32, device=dev)
            if sp is None
            else torch.as_tensor(sp if isinstance(sp, torch.Tensor)
                                 else np.ascontiguousarray(sp)).to(
                                     device=dev, dtype=torch.float32)
            for sp in seg_planes])
        src_ids_t = to_dev(src_ids)
        src_cat_t = to_dev(src_cat, torch.int32)
        seg_ok_t = to_dev(seg_ok, torch.bool)
        img_cut, img_msk, seg_cut = stage(centers, cut_px_t, cut_py_t,
                                          src_ids_t, src_cat_t, seg_ok_t,
                                          cut_shape)

    big = None
    if big_hw is not None:
        with span("big_bucket_stage", device=dev):
            hB, wB = big_hw
            bidx = np.asarray(big_src_i, np.int64)
            NB = len(bidx)
            NBp = max(-(-NB // 8) * 8, 8)

            def padB(a, fill):
                pad = [(0, 0), (0, NBp - NB)] + [(0, 0)] * (a.ndim - 2)
                return np.pad(a, pad, constant_values=fill)

            centersB = padB(centers[:, bidx], 0.0)
            off = np.array([w // 2 - wB // 2, h // 2 - hB // 2], np.float32)
            blcB = padB(blc_all[:, bidx] + off[None, None], 0.0)
            src_idsB = np.concatenate([src_ids[bidx],
                                       np.full(NBp - NB, -1, np.int64)])
            src_catB = np.concatenate([src_cat[bidx],
                                       np.zeros(NBp - NB, np.int64)])
            seg_okB = np.concatenate([seg_ok[bidx],
                                      np.ones(NBp - NB, bool)])
            # the bucket's cutout pixmaps: f32 on the device, as the JAX
            # package builds them whatever cutout_pixmaps says (the
            # Jacobians are shape-independent: the base set's serve)
            cpxB_t, cpyB_t = device_cutout_maps(blcB, big_hw)
            bimg, bmsk, bseg = stage(
                centersB, cpxB_t, cpyB_t, to_dev(src_idsB),
                to_dev(src_catB, torch.int32), to_dev(seg_okB, torch.bool),
                big_hw)
            # widen the bucket sources' ref-frame bboxes to the big windows
            for e in range(E):
                corner_bboxes(e, blcB[e, :NB, 0], blcB[e, :NB, 1], hB, wB,
                              rows=bidx)
            bidx_pad = np.concatenate([bidx, np.zeros(NBp - NB, np.int64)])
            big = (cpxB_t, cpyB_t, bimg, bmsk, bseg,
                   to_dev(bidx_pad, torch.int64),
                   to_dev(np.arange(NBp) < NB, torch.bool))

    # per-exposure input/output pixel-scale ratios (deposit window sizes)
    dri_ratios = tuple(round(float(exp.wcs.pscale / ref_wcs.pscale), 6)
                       for exp in exps)
    with span("stage_args", device=dev):
        args = _LoopArgs(
            exp_data=exp_data_t, exp_wht=exp_wht_t, dri_px=dri_px_t,
            dri_py=dri_py_t, cut_px=cut_px_t, cut_py=cut_py_t,
            img_cut=img_cut, img_msk=img_msk, seg_cut=seg_cut,
            jac=to_dev(jac), xy0=to_dev(xy0),
            src_w=to_dev(np.repeat(flux_w[None], E, 0)),
            src_valid=to_dev(src_valid, torch.bool), big=big)

    # -- sparse in-loop deposit: the re-drizzle only feeds the blot, so
    # input blocks whose deposits cannot reach any cutout's blot window
    # are compacted away ('auto' = on CUDA, where the kernels run, as the
    # JAX package turns it on with its Pallas kernels) -------------------- #
    margin = max(12, int(max(h, w) // 4))  # affine-correction headroom
    reach = max(kernel_reach(cfg.kernel, cfg.pixfrac, r)
                for r in dri_ratios) + 0.1
    # the JAX package's margins, so the live set is the same: its Pallas
    # blot tile reads up to 4 px past a window and its deposit tiles add
    # 1 px. The CUDA kernels have no tiles: B2 reads only the
    # interpolant's footprint (3 px at poly5) and B1 writes within
    # `reach`, so margin + 3 and reach + margin would do.
    live_margins = dict(blot_margin=float(margin + 4),
                        corr_margin=float(reach + margin + 1))
    sparse = None
    # under a spatial mesh each band keeps the blocks whose deposits reach
    # a needed cell in its own rows, and this rank compacts its band's
    bands = None if spatial is None else (
        spatial.shape[spatial.axis_names[-1]],
        band_rows(spatial, out_shape[0]))

    def compact(idx_, valid_):
        if bands is not None:
            b_ = spatial.index(spatial.axis_names[-1])
            idx_, valid_ = idx_[b_], valid_[b_]
        return _compact_blocks(exp_data_t, exp_wht_t, dri_px_t, dri_py_t,
                               to_dev(idx_, torch.int64),
                               to_dev(valid_, torch.bool))

    if cfg.sparse_deposit is True or (cfg.sparse_deposit == "auto"
                                      and dev.type == "cuda"):
        with span("sparse_blocks", device=dev):
            bb = _block_bboxes_wcs([e.wcs for e in exps], ref_wcs,
                                   exps[0].data.shape)
            idx, valid_b = _live_block_indices(bb, cut_bb, out_shape,
                                               bands=bands, **live_margins)
            nb_total = int(bb[0].shape[1])
            # fraction of the input blocks the live set keeps; the
            # deposit walks only those (``sparse_live_frac``) when that
            # pays
            setup_breakdown["sparse_live_set"] = round(
                idx.shape[-1] / nb_total, 4)
            if idx.shape[-1] < 0.85 * nb_total:  # compaction must pay
                dep = compact(idx, valid_b)
                args = dataclasses.replace(args, exp_data=dep[0],
                                           exp_wht=dep[1], dri_px=dep[2],
                                           dri_py=dep[3])
                # (under a mesh the compacted blocks are split by frame
                # below) the live set is policed against the applied
                # corrections (max_corr) and self-heals when they outgrow
                # this margin
                sparse = dict(bb=bb, nb_total=nb_total,
                              margin=float(margin), heals=0, warned=False)
                # fraction of the frame's input blocks the deposit still
                # walks
                setup_breakdown["sparse_live_frac"] = round(
                    idx.shape[-1] / nb_total, 4)
    with span("stage_args" if mesh is None else "mesh_stage", device=dev):
        blk = _block(args, mesh, cfg, dri_ratios, spatial)
    with span("stage_args"):
        if dev.type == "cuda":
            tracing.synchronize(dev)  # staging is charged to setup
    setup.close()
    setup_s = setup_breakdown["align.setup"]

    def sparse_heal_or_warn(max_corr: float, it: int) -> bool:
        """Police the sparse live set against the applied corrections.

        On a breach the per-cutout bboxes are moved by the current
        affines, the live blocks recomputed around the union of setup and
        corrected positions, the deposit inputs re-compacted, and the
        caller re-enters the fixed point from the current state. Two heals
        are attempted (each raises the margin to the correction at heal
        time), then a breach only warns. Returns True to re-enter."""
        nonlocal args, blk
        if max_corr <= sparse["margin"]:
            return False
        if sparse["heals"] < 2:
            sparse["heals"] += 1
            Ms_h = tracing.to_host(Ms).numpy().astype(np.float64)
            ts_h = tracing.to_host(ts).numpy().astype(np.float64)
            y0c, y1c, x0c, x1c = cut_bb
            cx4 = np.stack([x0c, x0c, x1c, x1c])  # (4, E, N) corners
            cy4 = np.stack([y0c, y1c, y0c, y1c])
            nx = (Ms_h[:, 0, 0][None, :, None] * cx4
                  + Ms_h[:, 0, 1][None, :, None] * cy4
                  + ts_h[:, 0][None, :, None])
            ny = (Ms_h[:, 1, 0][None, :, None] * cx4
                  + Ms_h[:, 1, 1][None, :, None] * cy4
                  + ts_h[:, 1][None, :, None])
            heal_bb = (np.minimum(y0c, ny.min(0)), np.maximum(y1c, ny.max(0)),
                       np.minimum(x0c, nx.min(0)), np.maximum(x1c, nx.max(0)))
            idx2, valid2 = _live_block_indices(sparse["bb"], heal_bb,
                                               out_shape, bands=bands,
                                               **live_margins)
            dep = compact(idx2, valid2)
            args = dataclasses.replace(args, exp_data=dep[0],
                                       exp_wht=dep[1], dri_px=dep[2],
                                       dri_py=dep[3])
            # (under a mesh, re-padded and re-split by frame)
            blk = _block(args, mesh, cfg, dri_ratios, spatial)
            sparse["margin"] = float(max_corr + margin)
            setup_breakdown["sparse_live_frac"] = round(
                idx2.shape[-1] / sparse["nb_total"], 4)
            setup_breakdown["sparse_heals"] = sparse["heals"]
            return True
        if not sparse["warned"]:
            sparse["warned"] = True
            warnings.warn(
                f"applied corrections reach {max_corr:.1f} px at iteration "
                f"{it}, beyond the sparse-deposit live-set margin of "
                f"{sparse['margin']:.0f} px (after {sparse['heals']} "
                "self-heal(s)) — blot windows may now sample un-deposited "
                "reference pixels. Re-run with sparse_deposit=False (or a "
                "larger cutout_shape) for exact results.", stacklevel=3)
        return False

    def make_recs(it, h, iter_s):
        """One iteration's per-exposure records from its fit (host)."""
        return [ImageAlignInfo(
            name=exps[e].name, iteration=it,
            shift=tuple(map(float, h["G_t"][e])),
            matrix=tuple(tuple(map(float, row)) for row in h["G_M"][e]),
            rms=tuple(map(float, h["rms"][e])), rmse=float(h["rmse"][e]),
            mae=float(h["mae"][e]), nmatches=int(h["nmatches"][e]),
            iter_s=iter_s, escaped=int(h["escaped"][e])) for e in range(E)]

    def record(recs):
        if cfg.history == "all" or not hist:
            hist.append(recs)
        else:
            hist[-1] = recs

    def step(b, Ms, ts):
        """One iteration of block ``b`` from state (Ms, ts): on this
        device, or over the mesh's ranks."""
        return _step(cfg, out_shape, cut_shape, big_hw, b, Ms, ts,
                     mesh=mesh, track_corr=sparse is not None,
                     spatial=spatial)

    # 'auto' runs the device loop unless verbose, which needs the host loop
    dev_loop = (not verbose) if cfg.device_loop == "auto" \
        else bool(cfg.device_loop)
    if dev_loop and verbose:
        warnings.warn(
            "device_loop=True is incompatible with verbose per-iteration "
            "printing; falling back to the host loop", stacklevel=2)
        dev_loop = False

    # ------------------------------------------------------------------ #
    # fixed-point iteration. The device loop (_fixed_point) keeps the
    # state and history on the device; on a card it replays a CUDA graph
    # of the step (and of its collectives, where NCCL runs them) and reads
    # them back every READ_EVERY iterations; under a gloo mesh it calls
    # the step at that cadence, and on one CPU it reads every iteration. The
    # host loop reads each iteration's fit back, records it, polices the
    # sparse live set and then tests eps_shift. A sparse self-heal
    # re-enters from the current state (convergence reached on stale
    # deposits is not trusted).
    # ------------------------------------------------------------------ #
    T = int(cfg.max_iterations)
    Ms = torch.eye(2, dtype=torch.float32, device=dev).repeat(E, 1, 1)
    ts = torch.zeros((E, 2), dtype=torch.float32, device=dev)
    hist: list[list[ImageAlignInfo]] = []
    fit_keys = ("G_M", "G_t", "rms", "rmse", "mae", "nmatches", "escaped")
    f32, i32 = torch.float32, torch.int32
    fields = dict(G_M=((E, 2, 2), f32), G_t=((E, 2), f32),
                  rms=((E, 2), f32), rmse=((E,), f32), mae=((E,), f32),
                  nmatches=((E,), i32), escaped=((E,), i32))
    if sparse is not None:
        fields["max_corr"] = ((), f32)
    n_iter = 0
    converged = False
    # on a card the loop runs as a CUDA graph (under a mesh, where its
    # collectives are NCCL's), keyed by what the step's launches depend on
    # beyond its block's shapes and the mesh
    graph_key = (repr(cfg), out_shape, cut_shape, big_hw,
                 sparse is not None, torch.get_float32_matmul_precision()) \
        if dev.type == "cuda" else None
    # each loop entry (a fixed point or a host loop, and its sparse heal)
    # is a span of its own
    while dev_loop:
        with span("align.loop", device=dev):
            Ms, ts, n_new, converged, h_np, iter_s = _fixed_point(
                step, blk, Ms, ts, fields, T, cfg.eps_shift, setup_breakdown,
                graph_key, mesh=spatial if mesh is None else mesh)
            for it in range(n_new):
                record(make_recs(n_iter + it,
                                 {k: h_np[k][it] for k in fit_keys}, iter_s))
            n_iter += n_new
            healed = sparse is not None and sparse_heal_or_warn(
                float(h_np["max_corr"].max()) if n_new else 0.0, n_iter - 1)
        if not healed:
            break
    while not dev_loop:
        healed = False
        with span("align.loop", device=dev):
            for _ in range(T):
                t_it = time.perf_counter()
                Ms, ts, info = step(blk, Ms, ts)
                h = {k: tracing.to_host(info[k]).numpy() for k in fit_keys}
                # the iteration's time, its reads included
                recs = make_recs(n_iter, h, time.perf_counter() - t_it)
                n_iter += 1
                record(recs)
                if verbose:
                    for r in recs:
                        print(r.to_json())
                if sparse is not None and sparse_heal_or_warn(
                        float(tracing.to_host(info["max_corr"])),
                        n_iter - 1):
                    healed = True
                    break
                if float(tracing.to_host(info["max_shift"])) \
                        < cfg.eps_shift:
                    converged = True
                    break
        if not healed:
            break
        converged = False

    # ------------------------------------------------------------------ #
    # write the corrections back into the WCSs (host)
    # ------------------------------------------------------------------ #
    with span("align.writeback"):
        Ms_np = tracing.to_host(Ms).numpy().astype(np.float64)
        ts_np = tracing.to_host(ts).numpy().astype(np.float64)
        out_exps = [Exposure(exp.data, apply_tangent_affine(
                        exp.wcs, ref_wcs, Ms_np[e], ts_np[e]),
                        weight=exp.weight, exptime=exp.exptime,
                        name=exp.name, data_units=exp.data_units,
                        err=exp.err, ivm=exp.ivm)
                    for e, exp in enumerate(exps)]
        # a spatial align's product stays row-band-sharded: gathering it
        # would put the whole mosaic on one device, what the mode avoids
        final = Drizzle(out_exps, output_wcs=ref_wcs, output_shape=out_shape,
                        pixfrac=cfg.pixfrac, kernel=cfg.kernel,
                        use_pallas=cfg.use_pallas,
                        wht_type=resample.wht_type, device=dev,
                        spatial_mesh=spatial)
    return AlignResult(
        exposures=out_exps, matrices=Ms_np, shifts=ts_np, history=hist,
        converged=converged, n_iterations=n_iter, drizzle=final,
        setup_s=setup_s, setup_breakdown=setup_breakdown,
        truncated_sources=truncated)
