"""FITS header <-> TanWCS bridge.

Counterpart of ``subpixal_tpu/wcs/fitswcs.py``, carried into the port
beside :mod:`subpixal_tpu_torch.wcs` (numpy only). The standard keywords
are parsed here, with no astropy/stwcs: CRPIX (FITS 1-based -> internal
0-based), CRVAL, CD matrix (CD*_* preferred, CDELT+PC*_* fallback, plain
CDELT last), SIP distortion keywords (A_ORDER/A_i_j, B_*, AP_*, BP_*) and
the WCSDVARR / D2IMARR lookup-table extensions.
"""

from __future__ import annotations

import numpy as np

from .io.fits import HDU, Header
from .wcs import DistGrid, TanWCS

__all__ = ["wcs_from_header", "wcs_to_header", "wcs_from_hdul",
           "distortion_from_hdus", "distortion_to_hdus"]


def _sip_matrix(hdr: Header, prefix: str) -> np.ndarray | None:
    order = hdr.get(f"{prefix}_ORDER")
    if order is None:
        return None
    n = int(order) + 1
    m = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            v = hdr.get(f"{prefix}_{i}_{j}")
            if v is not None:
                m[i, j] = float(v)
    return m


def wcs_from_header(hdr: Header) -> TanWCS:
    """Build a :class:`TanWCS` from FITS WCS keywords (0-based crpix).

    Only gnomonic (TAN/TAN-SIP) projections are supported; any other
    CTYPE projection code raises rather than silently mis-projecting.
    """
    ctype = str(hdr.get("CTYPE1", "")).strip().upper()
    if ctype:
        proj = ctype.split("-")[-1] if "-" in ctype else ""
        if proj not in ("", "TAN", "SIP"):
            raise ValueError(
                f"unsupported projection CTYPE1={ctype!r}: only TAN "
                "(gnomonic, incl. -SIP) is implemented — loading this "
                "as TAN would silently mis-project off-axis positions")
    crpix = np.array([float(hdr.get("CRPIX1", 1.0)) - 1.0,
                      float(hdr.get("CRPIX2", 1.0)) - 1.0])
    crval = np.array([float(hdr.get("CRVAL1", 0.0)),
                      float(hdr.get("CRVAL2", 0.0))])
    if "CD1_1" in hdr:
        cd = np.array([[float(hdr.get("CD1_1", 0.0)), float(hdr.get("CD1_2", 0.0))],
                       [float(hdr.get("CD2_1", 0.0)), float(hdr.get("CD2_2", 0.0))]])
    elif "PC1_1" in hdr:
        pc = np.array([[float(hdr.get("PC1_1", 1.0)), float(hdr.get("PC1_2", 0.0))],
                       [float(hdr.get("PC2_1", 0.0)), float(hdr.get("PC2_2", 1.0))]])
        cdelt = np.diag([float(hdr.get("CDELT1", 1.0)),
                         float(hdr.get("CDELT2", 1.0))])
        cd = cdelt @ pc
    else:
        cd = np.diag([float(hdr.get("CDELT1", 1.0)),
                      float(hdr.get("CDELT2", 1.0))])
    return TanWCS(
        crpix=crpix, crval=crval, cd=cd,
        a=_sip_matrix(hdr, "A"), b=_sip_matrix(hdr, "B"),
        ap=_sip_matrix(hdr, "AP"), bp=_sip_matrix(hdr, "BP"),
    )


def _write_sip(hdr: Header, prefix: str, m: np.ndarray | None):
    if m is None:
        return
    hdr[f"{prefix}_ORDER"] = m.shape[0] - 1
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            if m[i, j] != 0.0:
                hdr[f"{prefix}_{i}_{j}"] = float(m[i, j])


def wcs_to_header(wcs: TanWCS, hdr: Header | None = None) -> Header:
    """Write WCS keywords into ``hdr`` (created if None). 1-based CRPIX.

    Stale alternative representations are removed: the FITS WCS standard
    forbids CD and PC/CDELT coexisting, and a pre-existing PC+CDELT (or
    old SIP cards when the new WCS carries none/other orders) would make
    external readers see the OLD transform.
    """
    if hdr is None:
        hdr = Header()
    for key in ("PC1_1", "PC1_2", "PC2_1", "PC2_2", "CDELT1", "CDELT2"):
        if key in hdr:
            del hdr[key]
    for prefix in ("A", "B", "AP", "BP"):
        order = hdr.get(f"{prefix}_ORDER")
        if order is not None:
            del hdr[f"{prefix}_ORDER"]
            for i in range(int(order) + 1):
                for j in range(int(order) + 1):
                    if f"{prefix}_{i}_{j}" in hdr:
                        del hdr[f"{prefix}_{i}_{j}"]
    sip = wcs.a is not None
    ctype_suffix = "-SIP" if sip else ""
    hdr["WCSAXES"] = 2
    hdr["CTYPE1"] = f"RA---TAN{ctype_suffix}"
    hdr["CTYPE2"] = f"DEC--TAN{ctype_suffix}"
    hdr["CRPIX1"] = float(wcs.crpix[0]) + 1.0
    hdr["CRPIX2"] = float(wcs.crpix[1]) + 1.0
    hdr["CRVAL1"] = float(wcs.crval[0])
    hdr["CRVAL2"] = float(wcs.crval[1])
    hdr["CD1_1"] = float(wcs.cd[0, 0])
    hdr["CD1_2"] = float(wcs.cd[0, 1])
    hdr["CD2_1"] = float(wcs.cd[1, 0])
    hdr["CD2_2"] = float(wcs.cd[1, 1])
    hdr["CUNIT1"] = "deg"
    hdr["CUNIT2"] = "deg"
    for prefix, m in (("A", wcs.a), ("B", wcs.b), ("AP", wcs.ap), ("BP", wcs.bp)):
        _write_sip(hdr, prefix, m)
    return hdr


# --------------------------------------------------------------------- #
# lookup-table distortion extensions (stwcs NPOLFILE/D2IMFILE layout)
# --------------------------------------------------------------------- #

def distortion_from_hdus(hdul, kind: str = "WCSDVARR",
                         skip_record_check: bool = False,
                         extvers: tuple[int, int] | None = None):
    """Read a :class:`~subpixal_tpu_torch.wcs.DistGrid` from FITS image
    extensions named ``kind`` (``WCSDVARR`` = NPOL / CPDIS lookup,
    ``D2IMARR`` = detector-to-image), the layout stwcs writes into HST
    science files (SURVEY §1 Host I/O: stwcs lookup-table corrections).

    Convention (FITS WCS Paper IV, as emitted by stwcs): EXTVER 1 is
    the axis-1 (x) correction grid, EXTVER 2 the axis-2 (y) grid; each
    extension's own CRPIX/CRVAL/CDELT keywords anchor the grid in
    (1-based) science-pixel coordinates — converted to the 0-based
    :class:`DistGrid` anchor here. The record-valued ``DPj`` keywords
    of the science header are NOT required (they only point at these
    extensions). Returns None when no ``kind`` extension exists.

    ``extvers=(x_ver, y_ver)`` selects a specific grid pair — the
    multi-chip stwcs layout stores chip k's corrections at EXTVER
    (2k-1, 2k); the default (1, 2) is the single-chip case. Only the
    requested extensions are read (other chips' grids may carry
    different anchors).
    """
    xv, yv = extvers or (1, 2)
    grids = {}
    meta = None
    for hdu in hdul:
        if str(hdu.header.get("EXTNAME", "")).strip().upper() != kind:
            continue
        ver = int(hdu.header.get("EXTVER", 1))
        if ver not in (xv, yv) or hdu.data is None:
            continue
        grids[ver] = np.asarray(hdu.data, np.float64)
        m = (float(hdu.header.get("CRPIX1", 1.0)) - 1.0,
             float(hdu.header.get("CRPIX2", 1.0)) - 1.0,
             float(hdu.header.get("CRVAL1", 1.0)) - 1.0,
             float(hdu.header.get("CRVAL2", 1.0)) - 1.0,
             float(hdu.header.get("CDELT1", 1.0)),
             float(hdu.header.get("CDELT2", 1.0)))
        if meta is None:
            meta = m
        elif m != meta:
            raise ValueError(
                f"{kind} EXTVER grids disagree on CRPIX/CRVAL/CDELT — "
                "per-axis grid geometries are not supported")
    if not grids:
        return None
    return DistGrid(
        data_x=grids.get(xv), data_y=grids.get(yv),
        crpix=(meta[0], meta[1]), crval=(meta[2], meta[3]),
        cdelt=(meta[4], meta[5]))


def distortion_to_hdus(grid, kind: str = "WCSDVARR",
                       extvers: tuple[int, int] = (1, 2)):
    """Write a :class:`DistGrid` as ``kind`` image extensions (EXTVER
    ``extvers[0]`` = x grid, ``extvers[1]`` = y grid; multi-chip files
    use (2k-1, 2k) for chip k) — the inverse of
    :func:`distortion_from_hdus`."""
    out = []
    for ver, data in ((extvers[0], grid.data_x),
                      (extvers[1], grid.data_y)):
        if data is None:
            continue
        hdu = HDU(data=np.asarray(data, np.float32), name=kind)
        hdu.header["EXTVER"] = ver
        hdu.header["CRPIX1"] = grid.crpix[0] + 1.0
        hdu.header["CRPIX2"] = grid.crpix[1] + 1.0
        hdu.header["CRVAL1"] = grid.crval[0] + 1.0
        hdu.header["CRVAL2"] = grid.crval[1] + 1.0
        hdu.header["CDELT1"] = grid.cdelt[0]
        hdu.header["CDELT2"] = grid.cdelt[1]
        out.append(hdu)
    return out


def wcs_from_hdul(hdul, ext=0, chip: int = 1) -> TanWCS:
    """:func:`wcs_from_header` of ``hdul[ext]`` plus any lookup-table
    distortion extensions (``WCSDVARR`` -> ``cpdis``, ``D2IMARR`` ->
    ``d2im``) present in the file — the full stwcs-style HST chain.

    ``chip`` selects the grid pair for multi-chip files (stwcs layout:
    chip k's grids at EXTVER (2k-1, 2k)); a file carrying only the
    single (1, 2) pair applies it to every chip."""
    target = ext if hasattr(ext, "header") else hdul[ext]
    w = wcs_from_header(target.header if hasattr(target, "header")
                        else target)
    cpdis = d2im = None
    if chip > 1:
        cpdis = distortion_from_hdus(
            hdul, "WCSDVARR", extvers=(2 * chip - 1, 2 * chip))
        d2im = distortion_from_hdus(
            hdul, "D2IMARR", extvers=(2 * chip - 1, 2 * chip))
    if cpdis is None:
        cpdis = distortion_from_hdus(hdul, "WCSDVARR")
    if d2im is None:
        d2im = distortion_from_hdus(hdul, "D2IMARR")
    if cpdis is not None or d2im is not None:
        w = w.replace(cpdis=cpdis, d2im=d2im)
    return w
