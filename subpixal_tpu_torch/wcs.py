"""Self-contained TAN(+SIP) WCS on the host, in float64 numpy.

Counterpart of ``subpixal_tpu/wcs/wcs.py``, carried into the port so
that importing it never loads JAX. The JAX package also evaluates these
transforms on JAX arrays; the port evaluates every WCS on the host (the
slice's pixmaps are host float64), so only the numpy branch is kept.

* ``TanWCS`` — an immutable host-side object holding ``crpix``,
  ``crval``, ``cd`` and optional SIP coefficient matrices ``a``/``b``
  (forward) and ``ap``/``bp`` (inverse), plus lookup-table distortions;
* ``world_to_pixel`` uses the AP/BP inverse polynomials when present and
  a fixed-trip Picard refinement otherwise;
* :func:`apply_tangent_affine` applies an alignment correction measured
  in a reference image's pixel frame to an exposure's WCS.

Conventions: pixel coordinates are **0-based**, angles in degrees, and
``cd`` is the FITS CD matrix (deg/pixel).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["TanWCS", "DistGrid", "apply_tangent_affine", "tangent_homography"]


def _tangent_basis(crval) -> "np.ndarray":
    """Orthonormal basis [e_center, e_east, e_north] of a tangent frame."""
    ra0 = float(crval[0]) * _D2R
    dec0 = float(crval[1]) * _D2R
    cr, sr = np.cos(ra0), np.sin(ra0)
    cd, sd = np.cos(dec0), np.sin(dec0)
    return np.array([
        [cd * cr, cd * sr, sd],      # toward the tangent point
        [-sr, cr, 0.0],              # east
        [-sd * cr, -sd * sr, cd],    # north
    ])


def tangent_homography(from_crval, to_crval) -> "np.ndarray":
    """Exact 3x3 map between two gnomonic tangent planes.

    Gnomonic->gnomonic reprojection is exactly projective: a sky
    direction seen from tangent frame A as (xi, eta) in *radians* is the
    (unnormalized) vector ``B_A^T @ [1, xi, eta]``; in frame B it
    projects to ``w = M @ [1, xi, eta]`` with ``M = B_B @ B_A^T`` and
    ``(xi', eta') = (w[1]/w[0], w[2]/w[0])``. This replaces the
    per-pixel spherical round trip (arctan2/cos/sin over every pixel of
    every pixmap) with a handful of multiply-adds and one divide —
    ~20x faster pixmap composition at identical (f64-exact) results.
    """
    return _tangent_basis(to_crval) @ _tangent_basis(from_crval).T

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi


def _poly_eval(coeff: Any, u: Any, v: Any) -> Any:
    """Evaluate sum_{i,j} coeff[i, j] * u^i * v^j (SIP polynomial).

    ``coeff`` is a small (order+1, order+1) matrix; zero terms are
    skipped.
    """
    out = np.zeros_like(u)
    n = coeff.shape[0]
    up = [np.ones_like(u)]
    vp = [np.ones_like(v)]
    for i in range(1, n):
        up.append(up[-1] * u)
        vp.append(vp[-1] * v)
    cc = np.asarray(coeff)
    for i in range(n):
        for j in range(n):
            c = float(cc[i, j])
            if c != 0.0:
                out = out + c * (up[i] * vp[j])
    return out


@dataclasses.dataclass(frozen=True)
class DistGrid:
    """Per-axis lookup-table distortion (FITS WCS Paper IV subset).

    The reference handles HST frames through stwcs, which layers
    lookup-table corrections (NPOLFILE → ``WCSDVARR`` extensions,
    D2IMFILE → ``D2IMARR``) on top of SIP (SURVEY §1 "Host I/O", §2 #2);
    real ACS/WFC3 frames carry residual table distortion at the few-mpix
    level. This implements the Paper IV ``-TAB``/CPDIS sampled-grid
    convention: a coarse correction grid bilinearly interpolated at the
    (0-based) pixel position, clamped at the grid edges.

    ``data_x``/``data_y`` are (gh, gw) correction grids **in pixels**
    for the x and y axes (either may be None = zero). A pixel ``p``
    samples the grid at index ``(p - crval) / cdelt + crpix`` per axis
    (``crpix`` 0-based grid index of the anchor, ``crval`` the pixel
    coordinate it anchors, ``cdelt`` pixels per grid cell — the FITS
    keywords of the WCSDVARR/D2IMARR extension HDUs, 1-based there,
    converted on ingest).
    """

    data_x: np.ndarray | None = None
    data_y: np.ndarray | None = None
    crpix: tuple[float, float] = (0.0, 0.0)   # (gx0, gy0), 0-based
    crval: tuple[float, float] = (0.0, 0.0)   # anchored pixel (x, y)
    cdelt: tuple[float, float] = (1.0, 1.0)   # pixels per grid step

    def __post_init__(self):
        for f in ("data_x", "data_y"):
            val = getattr(self, f)
            if val is not None:
                object.__setattr__(self, f, np.asarray(val, np.float64))
        for f in ("crpix", "crval", "cdelt"):
            object.__setattr__(
                self, f, tuple(float(v) for v in getattr(self, f)))

    def _sample(self, grid, x, y):
        gh, gw = grid.shape
        gx = (x - self.crval[0]) / self.cdelt[0] + self.crpix[0]
        gy = (y - self.crval[1]) / self.cdelt[1] + self.crpix[1]
        gx = np.clip(gx, 0.0, gw - 1.0)
        gy = np.clip(gy, 0.0, gh - 1.0)
        ix = np.clip(np.floor(gx), 0, gw - 2).astype(int)
        iy = np.clip(np.floor(gy), 0, gh - 2).astype(int)
        fx = gx - ix
        fy = gy - iy
        g = grid
        v00 = g[iy, ix]
        v01 = g[iy, ix + 1]
        v10 = g[iy + 1, ix]
        v11 = g[iy + 1, ix + 1]
        return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
                + fy * ((1 - fx) * v10 + fx * v11))

    def delta(self, x, y):
        """(dx, dy) corrections at 0-based pixel positions (x, y)."""
        zero = np.zeros_like(np.asarray(x, dtype=float))
        dx = (self._sample(self.data_x, x, y)
              if self.data_x is not None else zero)
        dy = (self._sample(self.data_y, x, y)
              if self.data_y is not None else zero)
        return dx, dy


@dataclasses.dataclass(frozen=True)
class TanWCS:
    """Gnomonic (TAN) WCS with optional SIP distortion. Immutable.

    Parameters
    ----------
    crpix : (2,) float — 0-based reference pixel (x, y).
    crval : (2,) float — (RA, Dec) at the reference pixel, degrees.
    cd : (2, 2) float — CD matrix, degrees/pixel:
        [dxi/dx, dxi/dy; deta/dx, deta/dy] with (xi, eta) the tangent-plane
        intermediate world coordinates.
    a, b : optional (n, n) float — SIP forward distortion for x and y:
        u' = u + A(u, v), v' = v + B(u, v) with (u, v) = pixel - crpix.
    ap, bp : optional (n, n) float — SIP inverse polynomials.
    cpdis : optional :class:`DistGrid` — NPOL-style lookup-table
        distortion (stwcs NPOLFILE → ``WCSDVARR``): sampled at the
        (d2im-corrected) pixel position, added to the focal-plane
        coordinates ALONGSIDE the SIP terms (astropy ``pix2foc``
        semantics: ``foc = p + d2im + cpdis(p1) + sip(p1 - crpix)``).
    d2im : optional :class:`DistGrid` — detector-to-image correction
        (stwcs D2IMFILE → ``D2IMARR``), applied to the raw pixel
        coordinates before everything else.
    """

    crpix: np.ndarray
    crval: np.ndarray
    cd: np.ndarray
    a: np.ndarray | None = None
    b: np.ndarray | None = None
    ap: np.ndarray | None = None
    bp: np.ndarray | None = None
    cpdis: "DistGrid | None" = None
    d2im: "DistGrid | None" = None

    def __post_init__(self):
        object.__setattr__(self, "crpix", np.asarray(self.crpix, np.float64))
        object.__setattr__(self, "crval", np.asarray(self.crval, np.float64))
        object.__setattr__(self, "cd", np.asarray(self.cd, np.float64))
        for f in ("a", "b", "ap", "bp"):
            val = getattr(self, f)
            if val is not None:
                object.__setattr__(self, f, np.asarray(val, np.float64))
        # SIP matrices come in pairs (x and y corrections); a header
        # carrying only one (A_* without B_*, or AP_* without BP_*) means
        # zero correction on the other axis — not an AttributeError at
        # evaluation time
        for fa, fb in (("a", "b"), ("ap", "bp")):
            va, vb = getattr(self, fa), getattr(self, fb)
            if va is not None and vb is None:
                object.__setattr__(self, fb, np.zeros_like(va))
            elif vb is not None and va is None:
                object.__setattr__(self, fa, np.zeros_like(vb))

    # ------------------------------------------------------------------ #
    # forward: pixel -> world
    # ------------------------------------------------------------------ #
    def _focal_offsets(self, x, y):
        """(u, v) focal-plane offsets from crpix at raw pixels (x, y),
        through d2im → (SIP + cpdis) — astropy ``pix2foc`` semantics."""
        if self.d2im is not None:
            ddx, ddy = self.d2im.delta(x, y)
            x, y = x + ddx, y + ddy
        u = x - self.crpix[0]
        v = y - self.crpix[1]
        du = dv = None
        if self.a is not None:
            du = _poly_eval(self.a, u, v)
            dv = _poly_eval(self.b, u, v)
        if self.cpdis is not None:
            cdx, cdy = self.cpdis.delta(x, y)
            du = cdx if du is None else du + cdx
            dv = cdy if dv is None else dv + cdy
        if du is not None:
            u, v = u + du, v + dv
        return u, v

    def pixel_to_tangent(self, x, y):
        """Pixel -> tangent (xi, eta) deg (incl. SIP + lookup tables)."""
        u, v = self._focal_offsets(x, y)
        xi = self.cd[0, 0] * u + self.cd[0, 1] * v
        eta = self.cd[1, 0] * u + self.cd[1, 1] * v
        return xi, eta

    def tangent_to_world(self, xi, eta):
        """Tangent-plane (deg) -> (RA, Dec) via inverse gnomonic."""
        xi_r = xi * _D2R
        eta_r = eta * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        cosd, sind = np.cos(dec0), np.sin(dec0)
        den = cosd - eta_r * sind
        ra = ra0 + np.arctan2(xi_r, den)
        dec = np.arctan2(
            (sind + eta_r * cosd) * np.cos(ra - ra0), den
        )
        return (ra * _R2D) % 360.0, dec * _R2D

    def pixel_to_world(self, x, y):
        return self.tangent_to_world(*self.pixel_to_tangent(x, y))

    # ------------------------------------------------------------------ #
    # inverse: world -> pixel
    # ------------------------------------------------------------------ #
    def world_to_tangent(self, ra, dec):
        """(RA, Dec) deg -> tangent-plane (xi, eta) deg (gnomonic)."""
        ra_r = ra * _D2R
        dec_r = dec * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        cosd0, sind0 = np.cos(dec0), np.sin(dec0)
        cosd = np.cos(dec_r)
        sind = np.sin(dec_r)
        cosr = np.cos(ra_r - ra0)
        den = sind * sind0 + cosd * cosd0 * cosr
        xi = cosd * np.sin(ra_r - ra0) / den
        eta = (sind * cosd0 - cosd * sind0 * cosr) / den
        return xi * _R2D, eta * _R2D

    def tangent_to_pixel(self, xi, eta, newton_iters: int = 3):
        """Tangent (deg) -> pixel, inverting CD, SIP and lookup tables."""
        inv = np.linalg.inv(self.cd)
        up = inv[0, 0] * xi + inv[0, 1] * eta  # focal-plane (u', v')
        vp = inv[1, 0] * xi + inv[1, 1] * eta
        tables = self.cpdis is not None or self.d2im is not None
        if self.a is None and not tables:
            u, v = up, vp
        elif self.ap is not None and not tables:
            # SIP convention: u = u' + AP(u', v'), v = v' + BP(u', v')
            u = up + _poly_eval(self.ap, up, vp)
            v = vp + _poly_eval(self.bp, up, vp)
        else:
            # Fixed-trip Picard refinement of the TOTAL forward
            # correction (SIP + cpdis + d2im; corrections are smooth and
            # sub-pixel-to-few-pixel, so Picard contracts), seeded by
            # the AP/BP inverse when available.
            if self.ap is not None:
                u = up + _poly_eval(self.ap, up, vp)
                v = vp + _poly_eval(self.bp, up, vp)
            else:
                u, v = up, vp
            for _ in range(int(newton_iters)):
                x = u + self.crpix[0]
                y = v + self.crpix[1]
                fu, fv = self._focal_offsets(x, y)
                u = u - (fu - up)
                v = v - (fv - vp)
        return u + self.crpix[0], v + self.crpix[1]

    def world_to_pixel(self, ra, dec, newton_iters: int = 3):
        return self.tangent_to_pixel(*self.world_to_tangent(ra, dec),
                                     newton_iters=newton_iters)

    # ------------------------------------------------------------------ #
    # derived properties (parity with reference Cutout pixel-scale props)
    # ------------------------------------------------------------------ #
    @property
    def pscale(self) -> float:
        """Mean pixel scale, arcsec/pixel (sqrt of |det CD| in arcsec)."""
        return float(np.sqrt(abs(np.linalg.det(self.cd))) * 3600.0)

    def replace(self, **kw) -> "TanWCS":
        return dataclasses.replace(self, **kw)

    def with_shifted_crpix(self, dx: float, dy: float) -> "TanWCS":
        """WCS of a subarray whose (0,0) is at parent pixel (dx, dy) —
        the reference's deep-copied-cutout-WCS-with-CRPIX-offset
        (SURVEY §3.5). Lookup-table distortions stay anchored to the
        DETECTOR pixels (their pixel-space anchors shift with the
        frame, as stwcs does for subarrays)."""
        def shift_grid(g):
            if g is None:
                return None
            return dataclasses.replace(
                g, crval=(g.crval[0] - dx, g.crval[1] - dy))

        return self.replace(crpix=self.crpix - np.array([dx, dy]),
                            cpdis=shift_grid(self.cpdis),
                            d2im=shift_grid(self.d2im))


def apply_tangent_affine(
    wcs: TanWCS,
    ref_wcs: TanWCS,
    matrix: np.ndarray,
    shift: np.ndarray,
) -> TanWCS:
    """Apply an alignment correction fitted in ``ref_wcs`` pixel space.

    The align fit (see :func:`subpixal_tpu.ops.fit.iter_linear_fit`)
    found that a source whose current WCS predicts reference-frame pixel
    ``p`` is actually located at ``F(p) = matrix @ p + shift``. The
    corrected sky position of any point is therefore
    ``world_ref(F(pixel_ref(world_old)))``.

    Because the TAN projection is linear in the tangent plane, F conjugated
    by the reference CD matrix is an affine map of (xi, eta); we absorb its
    linear part into this WCS's CD matrix and its offset into CRVAL — the
    same first-order header update the reference performs via drizzlepac's
    ``updatehdr`` (SURVEY §3.1 "apply WCS correction to exposure SCI
    header(s)").
    """
    M = np.asarray(matrix, np.float64)
    t = np.asarray(shift, np.float64)
    cd_ref = ref_wcs.cd
    # Tangent-plane linear part: G = CD_ref @ M @ CD_ref^-1
    G = cd_ref @ M @ np.linalg.inv(cd_ref)

    # Offset: where does this WCS's CRPIX end up after correction?
    # xi/eta of CRPIX under the old WCS, in ref tangent frame:
    ra, dec = wcs.pixel_to_world(wcs.crpix[0], wcs.crpix[1])
    xi, eta = ref_wcs.world_to_tangent(ra, dec)
    p_ref = np.array(ref_wcs.tangent_to_pixel(xi, eta), np.float64)
    p_new = M @ p_ref + t
    xi2, eta2 = ref_wcs.pixel_to_tangent(p_new[0], p_new[1])
    ra2, dec2 = ref_wcs.tangent_to_world(xi2, eta2)

    # New CD: corrected tangent frame differs by G (expressed around the
    # ref tangent point; for the small corrections of the align loop this
    # is also valid around this image's tangent point).
    cd_new = G @ wcs.cd
    return wcs.replace(cd=cd_new, crval=np.array([ra2, dec2]))
