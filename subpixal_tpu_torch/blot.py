"""Host float64 pixmaps: where each pixel of one WCS frame lands in another.

Counterpart of ``subpixal_tpu/blot.py · compute_pixmap``, carried into the
port as numpy: the align setup and the drizzle deposits map every
exposure pixel (and every cutout pixel) into the reference frame through
``pixel -> tangent (CD + SIP) -> exact tangent-plane homography -> pixel``.
The slice evaluates these grids on the host at every frame size; the
JAX package's float32 device pixmaps wait for a later slice.
"""

from __future__ import annotations

import numpy as np

from .wcs import TanWCS, tangent_homography

__all__ = ["compute_pixmap"]


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
