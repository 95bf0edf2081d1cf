"""Row-band-sharded mosaic planes: one band of the reference plane a rank.

Counterpart of ``subpixal_tpu/parallel/spatial.py``. The frame and cutout
axes (:mod:`~subpixal_tpu_torch.parallel.sharding`) scale throughput;
this module scales the mosaic: the output plane's rows are split into
``band_rows(mesh, H)`` -row bands, one a rank of the mesh's rows axis (the
only axis of a 1-D mesh, the last of a 2-D ``(frames, rows)`` mesh from
:func:`make_mesh2d`). Where the JAX package holds a row-sharded array and
runs ``shard_map``, each rank here holds its own band, a ``(band_rows,
W)`` tensor on ``mesh.device``, and every function is called by every
rank of the mesh with the same arguments (the band its own).

- The drizzle deposit is linear and local, so a band's deposit is the
  same deposit with ``y - row0`` and a band-sized output: cells outside
  the band fail kernel B1's own bounds test, and nothing is summed across
  bands (rows past the plane's logical height, the last band's padding,
  are zeroed).
- The blot gather is a weighted sum of taps, each tap row owned by one
  band. On CUDA each band is extended by the interpolant's footprint
  (:func:`halo_exchange`), the queries it owns are sampled whole by
  kernel B2 (the others clamped into the band and masked) and the values
  and the ownership-and-validity are ``all_reduce``-d: the JAX package's
  kernel path. ``nearest``, CPU tensors, ``use_pallas=False`` and bands
  thinner than the footprint take the plain per-band partial sums,
  ``all_reduce``-d.
- The cubic B-spline prefilter is an IIR along the rows; a band
  prefilters over a ``spline_halo``-row mirror-remapped halo, to
  ``|z1|**spline_halo`` (z1 = sqrt(3) - 2) of the global prefilter.

Only ``all_reduce`` and ``broadcast`` are used (gloo, the backend of
ranks sharing a card, takes CUDA tensors for them, not for
``all_gather`` or point-to-point): an exchange is a zero-filled buffer
in which each rank writes its slot.
B1 and B2 are called through this module's ``drizzle_deposit_stack`` and
``sample_cutouts``, so a caller can swap in their plain versions.
Every function that reaches a kernel takes ``use_pallas``, ``'auto'`` by
default: the kernels per band on CUDA, the path the port's spatial align
runs. (The JAX package defaults these to ``False``, its Mosaic kernels
inside ``shard_map`` being opt-in.) ``False`` takes the plain versions
on any device; ``True`` on a mesh that is not on CUDA raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import use_pallas as _use_pallas
from ..kernels.blot import sample_cutouts
from ..kernels.drizzle import drizzle_deposit_stack
from ..ops.interp import (INTERP_OFFSETS, _axis_weights,
                          _bspline3_prefilter_axis)
from ..tracing import to_host

__all__ = [
    "band_rows",
    "shard_rows",
    "gather_rows",
    "halo_exchange",
    "make_mesh2d",
    "drizzle_deposit_spatial",
    "drizzle_deposit_sparse_spatial",
    "drizzle_deposit_stack_spatial",
    "sample_spatial",
]


def _rows_axis(mesh) -> str:
    """The plane-rows axis: the only axis of a 1-D mesh, the last axis of
    a 2-D ``(frames, rows)`` mesh."""
    if len(mesh.axis_names) not in (1, 2):
        raise ValueError(
            f"spatial sharding wants a 1-D (rows) or 2-D (frames, rows) "
            f"mesh, got axes {mesh.axis_names}")
    return mesh.axis_names[-1]


def _n_bands(mesh) -> int:
    return int(mesh.shape[_rows_axis(mesh)])


def band_rows(mesh, n_rows: int) -> int:
    """Rows per band: ``n_rows`` split over the rows axis, rounded up."""
    return -(-int(n_rows) // _n_bands(mesh))


def _band(mesh, n_rows: int) -> tuple[int, int]:
    """(this rank's band index, rows per band) for a plane of ``n_rows``."""
    return mesh.index(_rows_axis(mesh)), band_rows(mesh, n_rows)


def _psum(t: torch.Tensor, mesh, axis: str,
          op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced (summed by default) in place over the ranks of this
    rank's ``axis`` line (no collective for a line of one rank)."""
    if mesh.shape[axis] > 1:
        dist.all_reduce(t, op=op, group=mesh.group(axis))
    return t


def _exchange(local: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``local`` along ``axis``, (n, ...) in index order: a
    zero-filled buffer in which each rank writes its slot, summed (x + 0
    is x, so the exchange is exact)."""
    n = mesh.shape[axis]
    if n == 1:
        return local[None]
    dt = torch.int32 if local.dtype == torch.bool else local.dtype
    buf = torch.zeros((n,) + tuple(local.shape), dtype=dt,
                      device=local.device)
    buf[mesh.index(axis)] = local.to(dt)
    return _psum(buf, mesh, axis).to(local.dtype)


def _agree(mesh, *planes) -> tuple[torch.Tensor, ...]:
    """Under a 2-D mesh the ranks of a frames line hold one band, each
    computed on its own rank (B1's atomics sum in their own order): every
    rank takes the planes of the line's rank at frames index 0 (a
    broadcast), so the ranks' products, and every decision taken from
    them, agree. The identity on a 1-D mesh or none."""
    if (mesh is None or len(mesh.axis_names) != 2
            or mesh.shape[mesh.axis_names[0]] == 1):
        return planes
    src = mesh.index(mesh.axis_names[1])     # global rank of (0, r)
    out = []
    for p in planes:
        p = p.contiguous()
        dist.broadcast(p, src=src, group=mesh.group(mesh.axis_names[0]))
        out.append(p)
    return tuple(out)


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a if isinstance(a, torch.Tensor)
                           else np.asarray(a, np.float32),
                           dtype=torch.float32, device=device)


def shard_rows(mesh, plane) -> torch.Tensor:
    """This rank's band of an ``(H, W)`` plane that every rank holds
    whole, on ``mesh.device`` (the same band on every rank of a 2-D
    mesh's frames axis).

    Rows are zero-padded up to a multiple of the rows-axis size; pass the
    LOGICAL row count to the consumers (``sample_spatial(...,
    logical_rows=H)``): padded rows are never owned by a sample tap.
    """
    t = torch.as_tensor(plane if isinstance(plane, torch.Tensor)
                        else np.asarray(plane), device=mesh.device)
    H = t.shape[0]
    b, Hl = _band(mesh, H)
    out = torch.zeros((Hl,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    r1 = min((b + 1) * Hl, H)
    if r1 > b * Hl:
        out[:r1 - b * Hl] = t[b * Hl:r1]
    return out


def _gather_band(band: torch.Tensor, mesh) -> torch.Tensor:
    """The whole padded plane from every rank's band, on every rank."""
    if mesh is None:
        return band
    ax = _rows_axis(mesh)
    full = _exchange(band, mesh, ax)
    return full.reshape((-1,) + tuple(band.shape[1:]))


def gather_rows(plane: torch.Tensor, logical_rows: int | None = None,
                mesh=None) -> np.ndarray:
    """A row-sharded plane as host numpy, its row padding cropped to
    ``logical_rows``.

    ``plane`` is this rank's band and ``mesh`` the mesh it is sharded
    over (a band does not carry it; None: ``plane`` is whole). Under a
    mesh of more than one band this is a collective: EVERY rank of the
    mesh must call it, as in the JAX package.
    """
    out = to_host(_gather_band(plane, mesh)).numpy()
    return out if logical_rows is None else out[:logical_rows]


def _mirror_halos(band: torch.Tensor, halo: int):
    """(top, bottom) local mirror reflections of a band's edges: the
    B-spline prefilter's mirror (``x[-n] = x[n]``, ``x[N-1+n] =
    x[N-1-n]``, no edge duplication)."""
    return band[1:halo + 1].flip(0), band[-halo - 1:-1].flip(0)


def halo_exchange(band: torch.Tensor, halo: int, mesh,
                  edge: str = "mirror") -> torch.Tensor:
    """Extend a ``(Hl, W)`` band with ``halo`` rows from each neighbour.

    Returns ``(Hl + 2*halo, W)``; rows ``[halo:halo+Hl]`` are the band.
    At the global top and bottom the missing neighbour is replaced by
    ``edge``: 'mirror' (local mirror reflection, the B-spline boundary)
    or 'zero'. A collective: every rank of the mesh's rows axis must call
    it.
    """
    if edge not in ("mirror", "zero"):
        raise ValueError(f"edge must be 'mirror' or 'zero', got {edge!r}")
    max_halo = band.shape[0] - (1 if edge == "mirror" else 0)
    if not 0 < halo <= max_halo:
        raise ValueError(
            f"halo must be in (0, {max_halo}] for edge={edge!r}; got "
            f"{halo} for band {tuple(band.shape)}")
    ax = _rows_axis(mesh)
    n, i = mesh.shape[ax], mesh.index(ax)
    # each rank's first and last `halo` rows, in index order
    edges = _exchange(torch.stack([band[:halo], band[-halo:]]), mesh, ax)
    zero = torch.zeros_like(band[:halo])
    top = edges[i - 1, 1] if i > 0 else zero
    bot = edges[i + 1, 0] if i < n - 1 else zero
    if edge == "mirror":
        mtop, mbot = _mirror_halos(band, halo)
        top = mtop if i == 0 else top
        bot = mbot if i == n - 1 else bot
    return torch.cat([top, band, bot], 0)


def make_mesh2d(n_frames: int, n_rows: int,
                axis_names: tuple[str, str] = ("frames", "rows"),
                device=None):
    """A 2-D ``(frames, rows)`` mesh over the default process group:
    exposures shard over the first axis (throughput), mosaic rows over
    the second (memory). Rank ``f * n_rows + r`` sits at (f, r), as the
    JAX package reshapes its devices. Every rank creates one subgroup per
    line of each axis (all rows lines, then all frames lines, the same
    order on every rank); ``mesh.group(axis)`` is this rank's line.

    The group must have ``n_frames * n_rows`` ranks; in a lone process,
    ``make_mesh2d(1, 1)`` builds a one-rank group as ``make_mesh()`` does.
    ``device`` as in :func:`~subpixal_tpu_torch.parallel.make_mesh`.
    """
    from .sharding import Mesh, make_mesh

    need = int(n_frames) * int(n_rows)
    base = make_mesh(None if dist.is_initialized() else need,
                     device=device)
    if base.size != need:
        raise ValueError(
            f"mesh2d wants {n_frames}x{n_rows}={need} ranks, the process "
            f"group has {base.size}")
    fax, rax = axis_names
    Nf, Nr = int(n_frames), int(n_rows)
    f, r = divmod(base.rank, Nr)
    groups = {}
    for ax, lines in (
            (rax, [[g * Nr + k for k in range(Nr)] for g in range(Nf)]),
            (fax, [[g * Nr + k for g in range(Nf)] for k in range(Nr)])):
        for k, ranks in enumerate(lines):
            pg = dist.new_group(ranks) if need > 1 else base.group()
            if (ax == rax and k == f) or (ax == fax and k == r):
                groups[ax] = pg
    return Mesh(base.group(), base.rank, need, base.device,
                axis_names=(fax, rax), dims=(Nf, Nr), groups=groups)


# --------------------------------------------------------------------- #
# drizzle deposit onto a row-sharded output plane
# --------------------------------------------------------------------- #

def _deposit_band(mesh, data, wht, x_out, y_out, out_shape, pixfrac,
                  ratios, kernel, per_plane=False, sum_frames=False,
                  use_pallas="auto"):
    """One kernel B1 launch (its plain version under ``use_pallas=False``)
    of an (E, H, W) stack into this rank's band
    (a pscale ratio per plane): ``y - row0``, a band-sized output, and
    the rows past the logical height (the last band's padding) zeroed.
    Returns the band's (sci, wht), (Hl, Wo) or per plane (E, Hl, Wo).
    With ``sum_frames`` each rank deposited its own block of the frames,
    and on a 2-D mesh the band is ``all_reduce``-d over the frames axis
    (band-sized tiles, never the mosaic)."""
    Ho, Wo = (int(v) for v in out_shape)
    b, Hl = _band(mesh, Ho)
    row0 = b * Hl
    sci, wht_acc, _ = drizzle_deposit_stack(
        data.contiguous(), None if wht is None else wht.contiguous(),
        x_out.contiguous(), (y_out - np.float32(row0)).contiguous(),
        (Hl, Wo), pixfrac=pixfrac, pscale_ratio=tuple(ratios),
        kernel=kernel, per_plane=per_plane, use_pallas=use_pallas)
    if row0 + Hl > Ho:  # the unsharded deposit drops these rows
        keep = (torch.arange(Hl, device=sci.device) + row0 < Ho).to(
            sci.dtype)[:, None]
        sci, wht_acc = sci * keep, wht_acc * keep
    if sum_frames and len(mesh.axis_names) == 2:
        red = _psum(torch.stack([sci, wht_acc]), mesh, mesh.axis_names[0])
        sci, wht_acc = red[0], red[1]
    return sci, wht_acc


def _ratios(pscale_ratio, E: int) -> tuple:
    ratios = (tuple(float(r) for r in pscale_ratio)
              if hasattr(pscale_ratio, "__len__")
              else (float(pscale_ratio),) * E)
    if len(ratios) != E:
        raise ValueError(f"pscale_ratio: expected {E} per-frame values, "
                         f"got {len(ratios)}")
    return ratios


def drizzle_deposit_spatial(
    mesh, in_data, in_wht, x_out, y_out, out_shape: tuple[int, int],
    pixfrac: float = 1.0, pscale_ratio=1.0, kernel: str = "square",
    use_pallas: bool | str = "auto", per_plane: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~subpixal_tpu_torch.ops.drizzle.drizzle_deposit` with the
    OUTPUT accumulators row-band-sharded over ``mesh``: returns this
    rank's band of (sci, wht), ``(band_rows, Wo)``.

    Every rank passes the same (whole) inputs: an (H, W) plane, or an
    (E, H, W) stack with a scalar or per-plane ``pscale_ratio``, summed
    over its planes, or with ``per_plane`` returned as (E, band_rows, Wo)
    planes. One kernel B1 launch on CUDA (its plain version on the CPU
    and under ``use_pallas=False``): global cells outside the band fail
    its bounds test, so the bands' union is exactly the unsharded deposit
    and nothing is summed across ranks. Combine elementwise and crop with
    :func:`gather_rows`. ``use_pallas`` defaults to ``'auto'`` (B1 per
    band on CUDA), where the JAX package's defaults to ``False``.
    """
    dev = mesh.device
    _use_pallas(use_pallas, dev)  # use_pallas=True off CUDA raises
    d = _as_f32(in_data, dev)
    stack = d.dim() == 3
    if not stack:
        d = d[None]
    E = d.shape[0]

    def st(a):
        if a is None:
            return None
        a = _as_f32(a, dev)
        return a.expand(d.shape) if stack else a[None]

    sci, wht = _deposit_band(mesh, d, st(in_wht), st(x_out), st(y_out),
                             out_shape, pixfrac, _ratios(pscale_ratio, E),
                             kernel, per_plane=per_plane and stack,
                             use_pallas=use_pallas)
    return sci, wht


def _frame_block(mesh, arrays, ratios, axis: int = 0):
    """This rank's block of the frames axis (``axis`` of each array),
    padded with zero frames (weight 0: they deposit nothing) to a multiple
    of the mesh's frames-axis size, and its pscale ratios."""
    fax = mesh.axis_names[0]
    Nf, f = mesh.shape[fax], mesh.index(fax)
    E = len(ratios)
    El = -(-E // Nf)
    lo, hi = min(f * El, E), min((f + 1) * El, E)
    out = []
    for a in arrays:
        blk = a.narrow(axis, lo, hi - lo)
        if hi - lo < El:
            shape = list(a.shape)
            shape[axis] = El - (hi - lo)
            blk = torch.cat([blk, torch.zeros(shape, dtype=a.dtype,
                                              device=a.device)], axis)
        out.append(blk)
    pad_r = ratios[0]
    return out, tuple(ratios[lo:hi]) + (pad_r,) * (El - (hi - lo))


def drizzle_deposit_stack_spatial(
    mesh, data, wht, x_out, y_out, out_shape: tuple[int, int],
    pixfrac: float = 1.0, pscale_ratio=1.0, kernel: str = "square",
    use_pallas: bool | str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deposit an (E, H, W) exposure stack over a 2-D ``(frames, rows)``
    mesh: this rank's block of the frames (E zero-padded to a multiple of
    the frames axis) into its row band in ONE kernel B1 launch (a pscale
    ratio per plane, where the JAX package switches between deposits),
    then the band's accumulators ``all_reduce``-d over the frames axis
    only: the collective moves band-sized tiles, never the mosaic.
    ``x_out``/``y_out`` may be one (H, W) pixmap for the whole stack.
    Returns this rank's band (the same on every rank of its frames line).
    ``use_pallas=False`` deposits with B1's plain version (``'auto'``
    is the default here, ``False`` the JAX package's).
    """
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"drizzle_deposit_stack_spatial wants a 2-D (frames, rows) "
            f"mesh, got axes {mesh.axis_names}")
    dev = mesh.device
    _use_pallas(use_pallas, dev)  # use_pallas=True off CUDA raises
    d = _as_f32(data, dev)
    E = d.shape[0]
    ratios = _ratios(pscale_ratio, E)
    w = torch.ones_like(d) if wht is None else _as_f32(wht, dev)
    xo, yo = (_as_f32(a, dev).expand(d.shape) for a in (x_out, y_out))
    (d, w, xo, yo), rl = _frame_block(mesh, (d, w, xo, yo), ratios)
    return _deposit_band(mesh, d, w, xo, yo, out_shape, pixfrac, rl, kernel,
                         sum_frames=True, use_pallas=use_pallas)


def drizzle_deposit_sparse_spatial(
    mesh, data, wht, x_out, y_out, out_shape: tuple[int, int],
    pixfrac: float = 1.0, pscale_ratio=1.0, kernel: str = "square",
    use_pallas: bool | str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The band-compacted sparse deposit onto a row-sharded plane.

    ``data``/``wht``/``x_out``/``y_out`` are ``(Nb, E, L·bh, bw)``
    per-band pseudo-image stacks (``align._compact_blocks`` of each
    band's live set), of which this rank deposits its band's: only the
    input blocks whose deposits
    can reach a blot-needed cell inside the band's rows, so the union
    over bands reproduces the replicated sparse deposit (a straddling
    block is listed by every band its padded bbox touches; out-of-band
    cells fail each band's bounds test). On a 2-D ``(frames, rows)`` mesh
    the rank takes its block of the frames and the band's accumulators
    are ``all_reduce``-d over the frames axis. One kernel B1 launch (its
    plain version under ``use_pallas=False``; ``'auto'`` is the default
    here, ``False`` the JAX package's).
    """
    _use_pallas(use_pallas, mesh.device)  # use_pallas=True off CUDA raises
    Nb = data.shape[0]
    if Nb != _n_bands(mesh):
        raise ValueError(f"band axis {Nb} != mesh rows axis {_n_bands(mesh)}")
    b = mesh.index(_rows_axis(mesh))
    arrs = [_as_f32(a[b], mesh.device) for a in (data, wht, x_out, y_out)]
    ratios = _ratios(pscale_ratio, arrs[0].shape[0])
    if len(mesh.axis_names) == 2:
        arrs, ratios = _frame_block(mesh, arrs, ratios)
    return _deposit_band(mesh, *arrs, out_shape, pixfrac, ratios, kernel,
                         sum_frames=True, use_pallas=use_pallas)


# --------------------------------------------------------------------- #
# interpolated gather from a row-sharded plane
# --------------------------------------------------------------------- #

def _band_sample_partial(band, row0, Hg, x, y, interp, sinscl):
    """This band's additive share of ``sample_image(global, x, y)``:
    every tap row (after the global edge clamp to ``[0, Hg)``) is owned
    by one band, so the sum of the bands' partials is the unsharded
    sampler. The global footprint validity is the caller's."""
    Hl, W = band.shape

    def owned_row(yi):
        own = (yi >= row0) & (yi < row0 + Hl)
        return torch.where(own, yi - row0, 0), own.to(band.dtype)

    if interp == "nearest":
        xi = torch.clamp(torch.floor(x + 0.5).long(), 0, W - 1)
        yi = torch.clamp(torch.floor(y + 0.5).long(), 0, Hg - 1)
        yl, own = owned_row(yi)
        return band[yl, xi] * own

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, offs = _axis_weights(x - x0, interp, sinscl=sinscl)
    wy, _ = _axis_weights(y - y0, interp, sinscl=sinscl)
    xi0 = x0.long()
    yi0 = y0.long()
    acc = torch.zeros_like(x)
    for i, oy in enumerate(offs):
        yi = torch.clamp(yi0 + oy, 0, Hg - 1)   # global edge clamp
        yl, own = owned_row(yi)
        row_acc = torch.zeros_like(x)
        for j, ox in enumerate(offs):
            xi = torch.clamp(xi0 + ox, 0, W - 1)
            row_acc = row_acc + wx[..., j] * band[yl, xi]
        acc = acc + wy[..., i] * row_acc * own
    return acc


def _spline_ext(band, mesh, row0, Hg, halo):
    """The band extended by ``halo`` rows whose slots are mirror-remapped
    into the LOGICAL rows (mirror: ``x[-n] = x[n]``, ``x[Hg-1+n] =
    x[Hg-1-n]``), axis-0 prefiltered: the global mirror-boundary
    prefilter restricted to this band, to ``|z1|**halo``."""
    Hl = band.shape[0]
    ext = halo_exchange(band, halo, mesh, edge="zero")
    # each slot's global row reflected into the logical rows: the
    # identity for in-image slots, and exactly the rows the zero-filled
    # edge halos and row padding should hold
    g = row0 - halo + torch.arange(Hl + 2 * halo, device=band.device)
    m = g.abs()
    m = torch.where(m >= Hg, 2 * (Hg - 1) - m, m)
    ext = ext[torch.clamp(m - (row0 - halo), 0, Hl + 2 * halo - 1)]
    return _bspline3_prefilter_axis(ext, 0)


def sample_spatial(
    mesh, plane: torch.Tensor, x, y, interp: str = "poly5",
    fill: float = 0.0, sinscl: float = 1.0,
    logical_rows: int | None = None, spline_halo: int = 32,
    use_pallas: bool | str = "auto", return_escaped: bool = False,
) -> tuple[torch.Tensor, ...]:
    """:func:`~subpixal_tpu_torch.ops.interp.sample_image` from a
    row-sharded plane: the blot gather for mosaics larger than a device.

    ``plane`` is this rank's ``(band_rows, W)`` band (:func:`shard_rows`,
    a ``Drizzle(spatial_mesh=...)`` product); ``logical_rows`` the
    plane's unpadded height (default: every band row). Every rank passes
    the same coordinates and gets the whole result: ``(values, valid)``,
    as ``sample_image`` (and with ``return_escaped`` a (B,) zero count,
    the kernels having no static tiles). A collective: every rank of the
    mesh's rows axis must call it.

    On CUDA, for every interpolant but ``nearest``, the band is extended
    by the interpolant's footprint (``hi - lo + 1`` rows), the queries
    whose ``floor(y)`` it owns are sampled whole by kernel B2 (which
    reads no row outside the extended band; the others are masked), and
    the values times ownership-and-validity and the ownership-and-
    validity are ``all_reduce``-d: ownership partitions the queries, so
    the union is exact. ``nearest`` and CPU tensors sum the bands' plain
    partials. ``interp='spline3'`` prefilters each band over a
    ``spline_halo``-row mirror-remapped halo.

    ``use_pallas`` (``'auto'`` by default; the JAX package's default is
    ``False``) decides from the shape alone, before any launch: B2 needs
    bands of at least the footprint's rows and, for ``spline3``, a
    ``spline_halo`` of at least the footprint. Under ``'auto'`` other
    shapes sum the bands' plain partials, as ``False`` does on every
    shape; ``True`` raises ``ValueError`` for them, as the JAX package
    does, and on a mesh that is not on CUDA.
    """
    if interp not in INTERP_OFFSETS:
        raise ValueError(
            f"unknown interp: {interp!r} "
            f"(expected one of {sorted(INTERP_OFFSETS)})")
    ax = _rows_axis(mesh)
    band = plane.to(torch.float32)
    dev = band.device
    Hl, W = band.shape
    Hp = Hl * _n_bands(mesh)
    Hg = int(logical_rows) if logical_rows is not None else Hp
    pad = Hp - Hg
    row0 = mesh.index(ax) * Hl
    x = _as_f32(x, dev)
    y = _as_f32(y, dev)
    offs = INTERP_OFFSETS[interp]
    lo, hi = offs[0], offs[-1]
    # the kernel path's band extension: every owned query (floor(y) in the
    # band) finds its whole footprint, and so does the clamped image of
    # every unowned one, with a row to spare
    halo_i = hi - lo + 1
    pallas = _use_pallas(use_pallas, dev)
    if pallas and use_pallas != "auto":
        if interp == "spline3" and spline_halo < halo_i:
            raise ValueError(f"use_pallas spline3 needs spline_halo >= "
                             f"{halo_i}")
        if Hl < halo_i:
            raise ValueError(
                f"use_pallas sample needs band_rows >= {halo_i} (the "
                f"interpolant's footprint); got {Hl}: use more rows per "
                "band or fewer ranks")
    use_kernel = (pallas and interp != "nearest" and Hl >= halo_i
                  and (interp != "spline3" or spline_halo >= halo_i))
    if interp == "spline3":
        # every extended slot's reflection must land in the rank's own
        # extended range: the halo must fit a band beside the row padding
        if (not 0 < spline_halo <= Hl - pad) or Hl < 2 * pad + 1:
            raise ValueError(
                f"spline3 needs 0 < spline_halo <= band_rows - pad "
                f"({Hl} - {pad}) and band_rows >= 2*pad + 1; got "
                f"spline_halo={spline_halo}: use more rows per band or "
                "fewer ranks")

    if interp == "nearest":
        xi = torch.floor(x + 0.5).long()
        yi = torch.floor(y + 0.5).long()
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < Hg)
    else:
        xi0 = torch.floor(x).long()
        yi0 = torch.floor(y).long()
        valid = ((xi0 + lo >= 0) & (xi0 + hi < W)
                 & (yi0 + lo >= 0) & (yi0 + hi < Hg))
    fill_t = torch.full((), fill, dtype=torch.float32, device=dev)

    if use_kernel:
        if interp == "spline3":
            ext = _spline_ext(band, mesh, row0, Hg, spline_halo)
            ext = _bspline3_prefilter_axis(
                ext[spline_halo - halo_i:spline_halo + Hl + halo_i], 1)
        else:
            ext = halo_exchange(band, halo_i, mesh, edge="zero")
        # ownership: floor(y) in this band's rows, i.e. y in [row0,
        # row0 + Hl): the float compare needs no floor
        own = (y >= row0) & (y < row0 + Hl)
        # B2 takes (B, h, w) grids: points and planes become one row; the
        # extended band starts at global row row0 - halo_i, which B2
        # takes from floor(y) in integers (a float shift of y would round
        # its fraction)
        shape3 = ((1, 1, -1) if x.dim() < 3
                  else (-1,) + tuple(x.shape[-2:]))
        vals_b, valid_b, _ = sample_cutouts(
            ext.contiguous(), x.reshape(shape3).contiguous(),
            y.reshape(shape3).contiguous(), interp=interp, fill=0.0,
            prefiltered=True, sinscl=sinscl, row0=row0 - halo_i,
            use_pallas=use_pallas)
        okb = valid_b.reshape(x.shape) & own
        red = _psum(torch.stack([
            torch.where(okb, vals_b.reshape(x.shape), 0.0),
            okb.to(torch.float32)]), mesh, ax)
        ok = valid & (red[1] > 0.5)
        out = torch.where(ok, red[0], fill_t)
    else:
        band_c = band
        if interp == "spline3":
            ext = _spline_ext(band, mesh, row0, Hg, spline_halo)
            band_c = _bspline3_prefilter_axis(
                ext[spline_halo:spline_halo + Hl], 1)
        part = _band_sample_partial(band_c, row0, Hg, x, y, interp, sinscl)
        ok = valid
        out = torch.where(valid, _psum(part.contiguous(), mesh, ax), fill_t)
    if return_escaped:
        n = x.shape[0] if x.dim() else 1
        return out, ok, torch.zeros(n, dtype=torch.int32, device=dev)
    return out, ok
