"""Pixmaps (where each pixel of one WCS frame lands in another) and blot.

Counterpart of ``subpixal_tpu/blot.py``. The align setup and the drizzle
deposits map every exposure pixel (and every cutout pixel) into the
reference frame through ``pixel -> tangent (CD + SIP + lookup tables) ->
exact tangent-plane homography -> pixel``:

* :func:`compute_pixmap` evaluates the composition on the host in float64
  numpy (memoized);
* :func:`compute_pixmap_device` and :func:`compute_cutout_pixmaps_device`
  (and their ``_stack`` forms, one evaluation for a whole exposure stack
  that shares one distortion configuration; the single forms are stacks
  of one) evaluate the same composition in float32 torch on a device,
  with the JAX package's operation order, so the grids never cross from
  the host;
  the align setup uses them on CUDA (``cutout_pixmaps='auto'``) and for
  frames of at least :func:`device_pixmap_min_pixels` pixels;
* :func:`blot_image` / :func:`blot_cutout` sample a reference image at a
  pixmap, through kernel B2 (:mod:`subpixal_tpu_torch.kernels.blot`);
* :func:`blot_measure` is the align iteration's measurement: blot the
  reference at affine-moved cutout pixmaps (B2) and measure each blotted
  cutout against its image cutout (B3 for ``usfac > 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from .cutout import Cutout
from .kernels.blot import sample_cutouts
from .kernels.measure import measure_window
from .ops.correlate import Displacement, find_displacement
from .ops.interp import sample_image
from .wcs import TanWCS, tangent_homography

__all__ = ["compute_pixmap", "compute_pixmap_device",
           "compute_pixmap_device_stack", "compute_cutout_pixmaps_device",
           "compute_cutout_pixmaps_device_stack", "device_pixmap_min_pixels",
           "blot_image", "blot_cutout", "blot_measure"]


_PIXMAP_CACHE: dict = {}
_PIXMAP_CACHE_MAX = 16
# entries are full-frame float64 pairs (268 MB each at 4k^2) — bound
# the cache by BYTES, not only count, so large scenes cannot pin GBs
_PIXMAP_CACHE_BYTES = 512 * 1024 * 1024


def _grid_cache_key(g):
    if g is None:
        return None
    return (None if g.data_x is None else g.data_x.tobytes(),
            None if g.data_y is None else g.data_y.tobytes(),
            g.crpix, g.crval, g.cdelt)


def _wcs_cache_key(w: TanWCS):
    return (w.crpix.tobytes(), w.crval.tobytes(), w.cd.tobytes(),
            *(None if getattr(w, f) is None else getattr(w, f).tobytes()
              for f in ("a", "b", "ap", "bp")),
            _grid_cache_key(w.cpdis), _grid_cache_key(w.d2im))


def compute_pixmap(
    from_wcs: TanWCS,
    to_wcs: TanWCS,
    shape: tuple[int, int],
    blc: tuple[int, int] = (0, 0),
) -> tuple[np.ndarray, np.ndarray]:
    """Map every pixel of a ``shape`` grid in ``from_wcs``'s frame (offset
    by ``blc`` = (y0, x0)) to pixel coordinates in ``to_wcs``'s frame.

    The composition goes pixel -> tangent (linear CD + SIP), then an
    **exact 3x3 homography** between the two gnomonic tangent planes
    (:func:`subpixal_tpu_torch.wcs.tangent_homography` — no per-pixel
    spherical trig), then tangent -> pixel. Returns float64 arrays
    (x_to, y_to) of shape ``shape``.

    Results are memoized on the WCS parameters (LRU, 16 entries): the
    align setup and the Drizzle deposits request the SAME full-frame
    pixmaps back-to-back, so the cache halves the host work. The returned arrays are
    read-only; ``copy()`` before mutating.
    """
    key = (_wcs_cache_key(from_wcs), _wcs_cache_key(to_wcs),
           tuple(shape), tuple(blc))
    hit = _PIXMAP_CACHE.get(key)
    if hit is not None:
        _PIXMAP_CACHE[key] = _PIXMAP_CACHE.pop(key)  # refresh LRU order
        return hit

    h, w = shape
    y0, x0 = blc
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xi, eta = from_wcs.pixel_to_tangent(xx + x0, yy + y0)  # degrees
    M = tangent_homography(from_wcs.crval, to_wcs.crval)
    d2r = np.pi / 180.0
    x = xi * d2r
    y = eta * d2r
    w0 = M[0, 0] + M[0, 1] * x + M[0, 2] * y
    w1 = M[1, 0] + M[1, 1] * x + M[1, 2] * y
    w2 = M[2, 0] + M[2, 1] * x + M[2, 2] * y
    xi2 = (w1 / w0) / d2r
    eta2 = (w2 / w0) / d2r
    xt, yt = to_wcs.tangent_to_pixel(xi2, eta2)
    xt = np.asarray(xt)
    yt = np.asarray(yt)
    xt.setflags(write=False)
    yt.setflags(write=False)
    new_bytes = xt.nbytes + yt.nbytes
    total = sum(a.nbytes + b.nbytes for a, b in _PIXMAP_CACHE.values())
    while _PIXMAP_CACHE and (
            len(_PIXMAP_CACHE) >= _PIXMAP_CACHE_MAX
            or total + new_bytes > _PIXMAP_CACHE_BYTES):
        a, b = _PIXMAP_CACHE.pop(next(iter(_PIXMAP_CACHE)))  # oldest
        total -= a.nbytes + b.nbytes
    if new_bytes <= _PIXMAP_CACHE_BYTES:
        _PIXMAP_CACHE[key] = (xt, yt)
    return xt, yt


# --------------------------------------------------------------------- #
# device (float32) pixmaps
# --------------------------------------------------------------------- #

#: frames with at least this many pixels evaluate their DRIZZLE pixmaps
#: on the device in float32: 2048² on the CPU, 256² on a CUDA device (the
#: JAX package's thresholds for its CPU and accelerator backends).
#: Measurement-critical CUTOUT geometry is controlled separately
#: (``AlignConfig.cutout_pixmaps``).
DEVICE_PIXMAP_MIN_PIXELS = 2048 * 2048
DEVICE_PIXMAP_MIN_PIXELS_ACCEL = 256 * 256


def device_pixmap_min_pixels(device="cuda") -> int:
    """Pixel count from which frame pixmaps are evaluated on ``device``."""
    if torch.device(device).type == "cuda":
        return DEVICE_PIXMAP_MIN_PIXELS_ACCEL
    return DEVICE_PIXMAP_MIN_PIXELS


def _bc(p: torch.Tensor, nd: int) -> torch.Tensor:
    """A stacked pack's (E,) scalar parameter shaped to broadcast against
    ``nd``-dimensional coordinate arrays (E leading)."""
    return p.reshape(p.shape + (1,) * (nd - p.dim()))


def _poly2d(C, u, v, nd):
    """Σ_ij C[i, j] u^i v^j (static coefficient shape, every term)."""
    n = C.shape[-1]
    up = [torch.ones_like(u)]
    vp = [torch.ones_like(v)]
    for _ in range(n - 1):
        up.append(up[-1] * u)
        vp.append(vp[-1] * v)
    acc = torch.zeros((), dtype=torch.float32, device=u.device)
    for i in range(n):
        for j in range(n):
            acc = acc + _bc(C[..., i, j], nd) * (up[i] * vp[j])
    return acc


def _grid_sample(grid, meta, x, y, nd):
    """Bilinear lookup-table sample (DistGrid semantics, clamped at the
    edges). ``meta`` rows: (crpix, crval, cdelt) per axis, (E, 3, 2);
    ``grid`` is (E, gh, gw)."""
    gh, gw = grid.shape[-2:]
    gx = (x - _bc(meta[..., 1, 0], nd)) / _bc(meta[..., 2, 0], nd) \
        + _bc(meta[..., 0, 0], nd)
    gy = (y - _bc(meta[..., 1, 1], nd)) / _bc(meta[..., 2, 1], nd) \
        + _bc(meta[..., 0, 1], nd)
    gx = torch.clamp(gx, 0.0, gw - 1.0)
    gy = torch.clamp(gy, 0.0, gh - 1.0)
    ix = torch.clamp(torch.floor(gx), 0, max(gw - 2, 0)).to(torch.int32)
    iy = torch.clamp(torch.floor(gy), 0, max(gh - 2, 0)).to(torch.int32)
    fx = gx - ix
    fy = gy - iy
    ix1 = torch.clamp(ix + 1, max=gw - 1)
    iy1 = torch.clamp(iy + 1, max=gh - 1)
    flat = grid.reshape(-1, gh * gw)

    def at(r, c):
        k = (r * gw + c).to(torch.int64)
        return flat.gather(1, k.reshape(flat.shape[0], -1)).reshape(k.shape)

    v00 = at(iy, ix)
    v01 = at(iy, ix1)
    v10 = at(iy1, ix)
    v11 = at(iy1, ix1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _pixmap_compose(u, v, cd1, A, B_, M, icd2, AP2, BP2, A2, B2, tab1, tab2,
                    crpix1, crpix2, *, sip_mode, sip2_mode, tab_modes, nd):
    """The shared WCS composition on crpix-relative coordinates: (d2im →
    forward SIP + cpdis) → tangent → exact 3x3 tangent-plane homography →
    inverse tangent (inverse SIP, or a fixed-trip Picard over the total
    correction including lookup tables). Returns crpix2-relative
    coordinates. ``tab1``/``tab2`` are 6-tuples (d2im_x, d2im_y,
    d2im_meta, cpdis_x, cpdis_y, cpdis_meta); ``tab_modes`` flags
    (d2im1, cpdis1, d2im2, cpdis2) say which are present. Parameters are
    a stacked pack's (leading exposure axis); ``nd`` is the dimension of
    the coordinate arrays."""
    d2im1_on, cpdis1_on, d2im2_on, cpdis2_on = tab_modes

    def P(t):
        return _bc(t, nd)

    def fwd_offsets(uu, vv, cd_a, cd_b, tab, d2im_on, cpdis_on, crpix):
        """TanWCS._focal_offsets on crpix-relative coordinates."""
        if d2im_on:
            x = uu + P(crpix[..., 0])
            y = vv + P(crpix[..., 1])
            uu = uu + _grid_sample(tab[0], tab[2], x, y, nd)
            vv = vv + _grid_sample(tab[1], tab[2], x, y, nd)
        du = dv = None
        if cd_a is not None:
            du = _poly2d(cd_a, uu, vv, nd)
            dv = _poly2d(cd_b, uu, vv, nd)
        if cpdis_on:
            x = uu + P(crpix[..., 0])
            y = vv + P(crpix[..., 1])
            cdx = _grid_sample(tab[3], tab[5], x, y, nd)
            cdy = _grid_sample(tab[4], tab[5], x, y, nd)
            du = cdx if du is None else du + cdx
            dv = cdy if dv is None else dv + cdy
        if du is not None:
            uu, vv = uu + du, vv + dv
        return uu, vv

    u, v = fwd_offsets(u, v, A if sip_mode else None,
                       B_ if sip_mode else None, tab1,
                       d2im1_on, cpdis1_on, crpix1)
    d2r = float(np.float32(np.pi / 180.0))
    x = (P(cd1[..., 0, 0]) * u + P(cd1[..., 0, 1]) * v) * d2r
    y = (P(cd1[..., 1, 0]) * u + P(cd1[..., 1, 1]) * v) * d2r
    w0 = P(M[..., 0, 0]) + P(M[..., 0, 1]) * x + P(M[..., 0, 2]) * y
    xi2 = (P(M[..., 1, 0]) + P(M[..., 1, 1]) * x
           + P(M[..., 1, 2]) * y) / w0 / d2r
    eta2 = (P(M[..., 2, 0]) + P(M[..., 2, 1]) * x
            + P(M[..., 2, 2]) * y) / w0 / d2r
    up = P(icd2[..., 0, 0]) * xi2 + P(icd2[..., 0, 1]) * eta2
    vp = P(icd2[..., 1, 0]) * xi2 + P(icd2[..., 1, 1]) * eta2
    tab2_on = d2im2_on or cpdis2_on
    if sip2_mode == "inverse" and not tab2_on:
        u2 = up + _poly2d(AP2, up, vp, nd)
        v2 = vp + _poly2d(BP2, up, vp, nd)
    elif sip2_mode in ("newton", "inverse") or tab2_on:
        # fixed-trip Picard over the TOTAL forward correction (SIP +
        # tables), seeded by AP/BP when available — mirrors
        # TanWCS.tangent_to_pixel
        if sip2_mode == "inverse":
            u2 = up + _poly2d(AP2, up, vp, nd)
            v2 = vp + _poly2d(BP2, up, vp, nd)
        else:
            u2, v2 = up, vp
        sip2_on = sip2_mode == "newton"
        for _ in range(3):
            fu, fv = fwd_offsets(u2, v2, A2 if sip2_on else None,
                                 B2 if sip2_on else None, tab2,
                                 d2im2_on, cpdis2_on, crpix2)
            u2 = u2 - (fu - up)
            v2 = v2 - (fv - vp)
    else:
        u2, v2 = up, vp
    return u2, v2


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _grid_params(w: TanWCS):
    """(6 f32 host arrays, (d2im_on, cpdis_on)) table pack for one WCS."""
    z1 = _f32(np.zeros((1, 1)))
    zm = _f32(np.zeros((3, 2)))
    out, flags = [], []
    for g in (w.d2im, w.cpdis):
        if g is None:
            out += [z1, z1, zm]
            flags.append(False)
        else:
            meta = _f32(np.array([g.crpix, g.crval, g.cdelt], np.float64))
            gx = z1 if g.data_x is None else _f32(g.data_x)
            gy = z1 if g.data_y is None else _f32(g.data_y)
            out += [gx, gy, meta]
            flags.append(True)
    return out, tuple(flags)


def _device_wcs_params(from_wcs: TanWCS, to_wcs: TanWCS):
    """f32 parameter pack (host arrays) + static SIP/table modes for the
    device pixmap composition. Returns (params, sip_mode, (sip2_mode,
    tab_modes)).

    When ``to_wcs`` carries lookup tables, the inverse runs the Picard
    loop over the total correction with the FORWARD SIP (sip2_mode
    'newton') even if AP/BP exist — mirroring ``TanWCS.tangent_to_pixel``
    up to the AP/BP seeding.
    """
    z1 = np.zeros((1, 1), np.float32)
    sip_mode = from_wcs.a is not None
    tabs1, flags1 = _grid_params(from_wcs)
    tabs2, flags2 = _grid_params(to_wcs)
    to_tables = any(flags2)
    if to_wcs.a is None:
        sip2_mode = "none"
    elif to_wcs.ap is not None and not to_tables:
        sip2_mode = "inverse"
    else:
        sip2_mode = "newton"
    M = tangent_homography(from_wcs.crval, to_wcs.crval)
    params = (
        _f32(from_wcs.crpix), _f32(from_wcs.cd),
        _f32(from_wcs.a if sip_mode else z1),
        _f32(from_wcs.b if sip_mode else z1),
        _f32(M), _f32(np.linalg.inv(to_wcs.cd)),
        _f32(to_wcs.ap if sip2_mode == "inverse" else z1),
        _f32(to_wcs.bp if sip2_mode == "inverse" else z1),
        _f32(to_wcs.a if sip2_mode == "newton" else z1),
        _f32(to_wcs.b if sip2_mode == "newton" else z1),
        _f32(to_wcs.crpix),
        *tabs1, *tabs2,
    )
    return params, sip_mode, (sip2_mode, flags1 + flags2)


def _to_device(params, device):
    """A host parameter pack as f32 tensors on ``device`` (one copy each)."""
    return tuple(torch.as_tensor(p, device=device) for p in params)


def _packs(wcs_list, to_wcs, device):
    """(E, ...)-stacked parameter packs on ``device`` for a WCS list: one
    pack for the whole list when every WCS shares one SIP and table
    configuration (and parameter shapes), else one pack per WCS. Yields
    ``(rows, pack, sip_mode, sip2_cfg)``."""
    packs = [_device_wcs_params(w, to_wcs) for w in wcs_list]
    kinds = {(s1, s2, tuple(p.shape for p in pk)) for pk, s1, s2 in packs}
    groups = ([list(range(len(packs)))] if len(kinds) == 1
              else [[e] for e in range(len(packs))])
    for rows in groups:
        first, sip_mode, sip2_cfg = packs[rows[0]]
        stacked = [np.stack([packs[e][0][i] for e in rows])
                   for i in range(len(first))]
        yield rows, _to_device(stacked, device), sip_mode, sip2_cfg


def _compose_params(params, u, v, sip_mode, sip2_cfg, nd):
    crpix1, cd1, A, B_, M, icd2, AP2, BP2, A2, B2, crpix2, *tabs = params
    u2, v2 = _pixmap_compose(
        u, v, cd1, A, B_, M, icd2, AP2, BP2, A2, B2, tuple(tabs[:6]),
        tuple(tabs[6:12]), crpix1, crpix2, sip_mode=sip_mode,
        sip2_mode=sip2_cfg[0], tab_modes=sip2_cfg[1], nd=nd)
    return u2 + _bc(crpix2[..., 0], nd), v2 + _bc(crpix2[..., 1], nd)


def _frame_core(params, blc, shape, sip_mode, sip2_cfg):
    """(E, H, W) full-frame pixmap pairs; ``blc`` (E, 2) (y0, x0)."""
    h, w = shape
    dev = params[0].device
    yy = (torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
          + blc[:, 0, None, None])
    xx = (torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
          + blc[:, 1, None, None])
    crpix1 = params[0]
    u = xx - _bc(crpix1[..., 0], 3)
    v = yy - _bc(crpix1[..., 1], 3)
    px, py = _compose_params(params, u, v, sip_mode, sip2_cfg, 3)
    out = (blc.shape[0], h, w)
    return (torch.broadcast_to(px, out).contiguous(),
            torch.broadcast_to(py, out).contiguous())


def _cutout_core(params, blc, shape, sip_mode, sip2_cfg):
    """(E, N, h, w) per-cutout pixmap pairs; ``blc`` (E, N, 2) (x0, y0)."""
    h, w = shape
    dev = params[0].device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    crpix1 = params[0]
    u = xx + blc[..., 0, None, None] - _bc(crpix1[..., 0], 4)
    v = yy + blc[..., 1, None, None] - _bc(crpix1[..., 1], 4)
    px, py = _compose_params(params, u, v, sip_mode, sip2_cfg, 4)
    out = tuple(blc.shape[:-1]) + (h, w)
    return (torch.broadcast_to(px, out).contiguous(),
            torch.broadcast_to(py, out).contiguous())


def _eval_stack(core, wcs_list, to_wcs, blc, shape, device):
    """``core`` over a WCS list's packs (see :func:`_packs`), joined along
    the exposure axis; ``blc`` holds host origins with a leading E axis."""
    blc = np.asarray(blc, np.float32)
    outs = [core(pk, torch.as_tensor(blc[rows], device=device), tuple(shape),
                 sip_mode, sip2_cfg)
            for rows, pk, sip_mode, sip2_cfg in _packs(wcs_list, to_wcs,
                                                        device)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def compute_pixmap_device(from_wcs: TanWCS, to_wcs: TanWCS,
                          shape: tuple[int, int],
                          blc: tuple[int, int] = (0, 0), device="cuda"):
    """:func:`compute_pixmap` evaluated on ``device`` in float32.

    Same composition as the host path, in the JAX package's f32 operation
    order. Accuracy against the float64 host path is mpix-class (a
    float32 ulp at 4096 px is ~0.5 mpix) — ample for drizzle DEPOSIT
    grids. Returns float32 (H, W) tensors on ``device``.
    """
    px, py = _eval_stack(_frame_core, [from_wcs], to_wcs, [blc], shape,
                         device)
    return px[0], py[0]


def compute_pixmap_device_stack(wcs_list, to_wcs: TanWCS,
                                shape: tuple[int, int], device="cuda"):
    """:func:`compute_pixmap_device` for a same-shape exposure stack:
    returns (E, H, W) pairs, from one evaluation when every WCS shares
    one SIP and table configuration, else from one per exposure."""
    return _eval_stack(_frame_core, wcs_list, to_wcs,
                       np.zeros((len(wcs_list), 2)), shape, device)


def compute_cutout_pixmaps_device(from_wcs: TanWCS, to_wcs: TanWCS, blc,
                                  shape: tuple[int, int], device="cuda"):
    """Per-cutout pixmaps evaluated on ``device`` in float32.

    ``blc`` is an (N, 2) array of per-cutout (x0, y0) origins in
    ``from_wcs``'s pixel frame; returns (N, h, w) float32 coordinate
    pairs into ``to_wcs``'s frame — the align loop's per-source blot
    geometry, without the host float64 grid evaluation. The float32
    composition carries a few ulp of the output coordinate (≈0.3 mpix at
    a 1k reference frame), smooth and common-mode across a cutout.
    Jacobians are NOT derived from these grids: the align setup takes
    them from float64 host evaluations at the cutout centers.
    """
    px, py = _eval_stack(_cutout_core, [from_wcs], to_wcs,
                         np.asarray(blc, np.float32)[None], shape, device)
    return px[0], py[0]


def compute_cutout_pixmaps_device_stack(wcs_list, to_wcs: TanWCS, blc,
                                        shape: tuple[int, int],
                                        device="cuda"):
    """:func:`compute_cutout_pixmaps_device` for a whole exposure stack:
    ``blc`` is (E, N, 2); returns (E, N, h, w) pairs, from one evaluation
    when every WCS shares one SIP and table configuration, else from one
    per exposure."""
    return _eval_stack(_cutout_core, wcs_list, to_wcs, blc, shape, device)


# --------------------------------------------------------------------- #
# blot
# --------------------------------------------------------------------- #

def blot_image(ref_data, pixmap_x, pixmap_y, interp: str = "poly5",
               expout: float = 1.0, fill: float = 0.0, sinscl: float = 1.0,
               device=None):
    """Sample ``ref_data`` at pixmap coordinates.

    ``expout`` rescales output flux for exposure-time units and
    ``sinscl`` scales the sinc interpolant (parity with ``do_blot``'s
    expout/sinscl). Arrays go to ``device`` (default: ``ref_data``'s
    device when it is a tensor, else 'cuda'); on a CUDA device the gather
    is kernel B2, whose sinc takes ``sinscl=1`` only. Returns
    ``(blotted, valid_mask)`` tensors of the pixmap's shape.
    """
    if device is None:
        device = (ref_data.device if isinstance(ref_data, torch.Tensor)
                  else "cuda")
    dev = torch.device(device)

    def f32(a):
        if not isinstance(a, torch.Tensor):
            a = np.array(a, np.float32)  # a writable copy of host data
        return torch.as_tensor(a, dtype=torch.float32,
                               device=dev).contiguous()

    img, px, py = f32(ref_data), f32(pixmap_x), f32(pixmap_y)
    if sinscl == 1.0 or interp != "sinc":
        g = (1, -1, px.shape[-1]) if px.dim() else (1, 1, 1)
        vals, valid, _ = sample_cutouts(img, px.reshape(g), py.reshape(g),
                                        interp=interp, fill=fill)
        vals, valid = vals.reshape(px.shape), valid.reshape(px.shape)
    elif dev.type == "cpu":
        vals, valid = sample_image(img, px, py, interp=interp, fill=fill,
                                   sinscl=sinscl)
    else:
        raise ValueError("blot_image: kernel B2's sinc takes sinscl=1 only; "
                         f"got sinscl={sinscl} on {dev}")
    if expout != 1.0:
        vals = vals * float(np.float32(expout))
    return vals, valid


def blot_cutout(source_cutout: Cutout, image_cutout: Cutout,
                interp: str = "poly5", expout: float | None = None,
                sinscl: float = 1.0, device="cuda") -> Cutout:
    """Blot a reference-frame cutout onto an exposure cutout's grid.

    Parity: the JAX package's ``blot_cutout``. The source cutout's data is
    interpolated onto the image cutout's pixel grid through their WCSs
    (host float64 pixmap), on ``device``. ``expout`` None derives the
    exposure-time scaling from the two cutouts' units (rate onto counts
    multiplies by the image's exptime, and so on). Returns a new Cutout in
    the image cutout's frame.
    """
    px, py = compute_pixmap(image_cutout.wcs, source_cutout.wcs,
                            image_cutout.data.shape, blc=(0, 0))
    if expout is None:
        src_u = getattr(source_cutout, "data_units", "rate")
        img_u = getattr(image_cutout, "data_units", "rate")
        if src_u == "rate" and img_u == "counts":
            scale = float(image_cutout.exptime)
        elif src_u == "counts" and img_u == "rate":
            scale = 1.0 / max(float(source_cutout.exptime), 1e-30)
        elif src_u == "counts" and img_u == "counts":
            scale = (float(image_cutout.exptime)
                     / max(float(source_cutout.exptime), 1e-30))
        else:
            scale = 1.0
        out_units = img_u
    else:
        scale = float(expout)
        out_units = source_cutout.data_units
    vals, valid = blot_image(source_cutout.data, px, py, interp=interp,
                             expout=scale, sinscl=sinscl, device=device)
    return Cutout(
        data=vals.cpu().numpy(), wcs=image_cutout.wcs,
        blc=image_cutout.blc, src_pos=image_cutout.src_pos,
        mask=valid.cpu().numpy() & np.asarray(image_cutout.mask, bool),
        exptime=image_cutout.exptime, data_units=out_units)


def _affine_apply_grid(M, t, gx, gy):
    """Apply per-entry affines (..., 2, 2), (..., 2) to coordinate grids
    whose leading axes match M's batch axes."""
    extra = gx.dim() - (M.dim() - 2)

    def b(a):
        return a.reshape(a.shape + (1,) * extra)

    nx = b(M[..., 0, 0]) * gx + b(M[..., 0, 1]) * gy + b(t[..., 0])
    ny = b(M[..., 1, 0]) * gx + b(M[..., 1, 1]) * gy + b(t[..., 1])
    return nx, ny


def blot_measure(image: torch.Tensor, M: torch.Tensor, t: torch.Tensor,
                 px: torch.Tensor, py: torch.Tensor, img: torch.Tensor,
                 mask: torch.Tensor, seg: torch.Tensor | None = None,
                 interp: str = "poly5",
                 **measure_kw) -> tuple[Displacement, torch.Tensor]:
    """Blot ``image`` at cutout pixmaps moved by per-cutout affines and
    measure each blotted cutout against its image cutout.

    ``px``, ``py`` (B, h, w) are pixmaps into ``image``'s frame, moved by
    ``M`` (B, 2, 2), ``t`` (B, 2) and sampled with kernel B2 on CUDA;
    ``img`` (B, h, w) are the image cutouts and ``mask`` (B, h, w) bool
    their valid pixels, AND-ed with the blot's validity; ``seg`` (B, h, w),
    when given, multiplies both sides. The displacements of the blotted
    cutouts relative to ``img`` come from ``find_displacement`` with its
    windowed ``usfac > 1`` measurement through kernel B3 on CUDA
    (``measure_kw``: its options). Returns the displacements and the (B,)
    int32 blot escapes.
    """
    bx, by = _affine_apply_grid(M, t, px, py)
    vals, ok, esc = sample_cutouts(image.contiguous(), bx, by, interp=interp)
    msk = mask & ok
    if seg is not None:
        img = img * seg
        vals = vals * seg
    d = find_displacement(vals, img.contiguous(), ref_mask=msk, img_mask=msk,
                          measure=measure_window, **measure_kw)
    return d, esc
