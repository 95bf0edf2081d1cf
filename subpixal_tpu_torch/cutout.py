"""Host-side Cutout objects and primary-cutout creation.

Counterpart of ``subpixal_tpu/cutout.py`` (``Cutout`` and
``create_primary_cutouts``), carried into the port as numpy so that
importing it never loads JAX. The align setup sizes its static cutout
shape and its oversized-footprint bucket from these cutouts. The JAX
package's other cutout functions wait for ROADMAP item A14.
"""

from __future__ import annotations

import numpy as np

from .wcs import TanWCS

__all__ = ["Cutout", "NoOverlapError", "create_primary_cutouts"]


class NoOverlapError(ValueError):
    """Cutout bounding box has no overlap with the image (reference
    ``cutout.NoOverlapError``)."""


class Cutout:
    """A rectangular cutout of an image with WCS and source metadata.

    Attributes (parity with reference ``Cutout``): ``data``, ``mask``
    (True = valid pixel), ``src_weight``, ``blc``/``trc`` ((y, x) corners
    in the parent image, inclusive), ``src_pos`` ((x, y) of the source in
    *cutout* coordinates), ``wcs`` (cutout-local, CRPIX-shifted),``exptime``,
    ``data_units``.
    """

    def __init__(self, data, wcs: TanWCS, blc=(0, 0), src_pos=None,
                 mask=None, src_weight: float = 1.0, exptime: float = 1.0,
                 data_units: str = "rate", src_id: int = -1):
        self.data = np.asarray(data)
        self.wcs = wcs
        self.blc = (int(blc[0]), int(blc[1]))
        h, w = self.data.shape
        self.trc = (self.blc[0] + h - 1, self.blc[1] + w - 1)
        self.src_pos = (float(src_pos[0]), float(src_pos[1])) \
            if src_pos is not None else (w / 2.0, h / 2.0)
        self.mask = (np.ones(self.data.shape, bool) if mask is None
                     else np.asarray(mask, bool))
        self.src_weight = float(src_weight)
        self.exptime = float(exptime)
        self.data_units = data_units
        self.src_id = int(src_id)

    @property
    def src_pos_parent(self) -> tuple[float, float]:
        """Source position (x, y) in the parent image frame."""
        return (self.src_pos[0] + self.blc[1], self.src_pos[1] + self.blc[0])

    def __repr__(self):
        return (f"Cutout(id={self.src_id}, blc={self.blc}, "
                f"shape={self.data.shape})")


def _extract_host(imdata: np.ndarray, y0: int, x0: int, h: int, w: int):
    """Host cutout extraction; the part outside the image is zero and
    masked out."""
    H, W = imdata.shape
    iy0, ix0 = max(y0, 0), max(x0, 0)
    iy1, ix1 = min(y0 + h, H), min(x0 + w, W)
    if iy1 <= iy0 or ix1 <= ix0:
        raise NoOverlapError(f"bbox ({y0},{x0})+({h},{w}) outside image")
    data = np.zeros((h, w), imdata.dtype)
    mask = np.zeros((h, w), bool)
    data[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = imdata[iy0:iy1, ix0:ix1]
    mask[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = True
    return data, mask


def create_primary_cutouts(
    catalog,
    segmentation_image: np.ndarray,
    imdata: np.ndarray,
    imwcs: TanWCS,
    pad: int = 1,
    min_box_size: int = 8,
    max_box_size: int = 512,
    combine_seg_mask: bool = True,
    exptime: float = 1.0,
    data_units: str = "rate",
) -> list[Cutout]:
    """Cutouts around catalog sources on the (drizzled) reference image.

    Parity: reference ``cutout.create_primary_cutouts`` (SURVEY §3.5):
    each source's box comes from its segmentation footprint (+``pad``),
    too-small/off-image sources are rejected, the segmentation mask is
    attached (and multiplied into the data when ``combine_seg_mask`` —
    reference ``combine_seg_mask=True`` behavior), and each cutout gets a
    CRPIX-shifted deep-copied WCS.
    """
    seg = np.asarray(segmentation_image)
    out: list[Cutout] = []
    n = len(catalog)
    ids = (np.asarray(catalog["id"], int) if "id" in catalog
           else np.arange(1, n + 1))
    xs = np.asarray(catalog["x"], float)
    ys = np.asarray(catalog["y"], float)
    flux = (np.asarray(catalog["flux"], float) if "flux" in catalog
            else np.ones(n))

    # all footprint bboxes in ONE image pass (a per-source ``seg == id``
    # scan is O(n_sources * H * W) — tens of seconds at catalog scale)
    maxid = int(seg.max(initial=0))
    big = np.iinfo(np.int64).max
    bb_y0 = np.full(maxid + 1, big)
    bb_x0 = np.full(maxid + 1, big)
    bb_y1 = np.full(maxid + 1, -1)
    bb_x1 = np.full(maxid + 1, -1)
    if maxid > 0:
        myy, mxx = np.nonzero(seg > 0)
        vals = seg[myy, mxx].astype(np.int64)
        np.minimum.at(bb_y0, vals, myy)
        np.minimum.at(bb_x0, vals, mxx)
        np.maximum.at(bb_y1, vals, myy)
        np.maximum.at(bb_x1, vals, mxx)

    for k in range(n):
        sid = int(ids[k])
        has_fp = 0 < sid <= maxid and bb_y1[sid] >= 0
        if not has_fp:
            # no segmentation footprint: fall back to a min-size box
            y0 = int(round(ys[k])) - min_box_size // 2
            x0 = int(round(xs[k])) - min_box_size // 2
            h = w = min_box_size
        else:
            fy0, fy1 = int(bb_y0[sid]), int(bb_y1[sid])
            fx0, fx1 = int(bb_x0[sid]), int(bb_x1[sid])
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
                continue  # reject absurd footprints (blended junk)
        try:
            data, mask = _extract_host(imdata, y0, x0, h, w)
        except NoOverlapError:
            continue
        segmask, _ = _extract_host(seg, y0, x0, h, w)
        srcmask = (segmask == sid) | (segmask == 0)
        if has_fp:
            srcsel = segmask == sid
            if combine_seg_mask:
                data = data * srcsel
            mask = mask & srcmask
        cw = imwcs.with_shifted_crpix(x0, y0)
        out.append(Cutout(
            data=data, wcs=cw, blc=(y0, x0),
            src_pos=(xs[k] - x0, ys[k] - y0),
            mask=mask, src_weight=float(flux[k]),
            exptime=exptime, data_units=data_units, src_id=sid,
        ))
    return out
