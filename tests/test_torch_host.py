"""Port parity: the host modules carried into the port, and its isolation.

WCS transforms, the source finder (labeling, deblending, measurement),
primary cutouts and the float64 pixmaps are numpy in both packages and
must agree EXACTLY. ``import subpixal_tpu_torch`` must load neither jax
nor subpixal_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import ndimage

from subpixal_tpu.blot import compute_pixmap as j_pixmap
from subpixal_tpu.catalogs import ImageSourceCatalog as JCatalog
from subpixal_tpu.catalogs import find_sources as j_find
from subpixal_tpu.cutout import create_primary_cutouts as j_prim
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.wcs.wcs import DistGrid as JDistGrid
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu.wcs.wcs import apply_tangent_affine as j_apply
from subpixal_tpu_torch import _native
from subpixal_tpu_torch.blot import compute_pixmap
from subpixal_tpu_torch.catalogs import ImageSourceCatalog, find_sources
from subpixal_tpu_torch.convert import (exposures_from_reference,
                                        wcs_from_reference)
from subpixal_tpu_torch.cutout import create_primary_cutouts
from subpixal_tpu_torch.wcs import apply_tangent_affine


def _jwcs(seed=0, sip=True, tables=False):
    rng = np.random.default_rng(seed)
    s = 0.04 / 3600.0
    th = np.deg2rad(rng.uniform(-20, 20))
    cd = s * np.array([[-np.cos(th), np.sin(th)], [np.sin(th), np.cos(th)]])
    kw = {}
    if sip:
        a = np.zeros((4, 4))
        b = np.zeros((4, 4))
        a[2, 0], a[1, 1], a[0, 2], a[3, 0] = 3e-6, -2e-6, 1e-6, 1e-9
        b[2, 0], b[1, 1], b[0, 2], b[0, 3] = -1e-6, 2.5e-6, 2e-6, -2e-9
        kw.update(a=a, b=b)
    if tables:
        kw["cpdis"] = JDistGrid(data_x=rng.normal(0, 0.05, (9, 11)),
                                data_y=rng.normal(0, 0.05, (9, 11)),
                                crpix=(4.0, 5.0), crval=(100.0, 80.0),
                                cdelt=(25.0, 25.0))
        kw["d2im"] = JDistGrid(data_x=rng.normal(0, 0.02, (5, 5)),
                               cdelt=(60.0, 60.0))
    return JTanWCS(crpix=np.array([150.5, 120.25]),
                   crval=np.array([83.6, -5.4]), cd=cd, **kw)


@pytest.mark.parametrize("sip,tables", [(False, False), (True, False),
                                        (True, True)])
def test_wcs_transforms_exact(sip, tables):
    jw = _jwcs(1, sip=sip, tables=tables)
    tw = wcs_from_reference(jw)
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-20, 320, (2, 500))
    for jf, tf in ((jw.pixel_to_world, tw.pixel_to_world),
                   (jw.pixel_to_tangent, tw.pixel_to_tangent)):
        for a, b in zip(jf(x, y), tf(x, y)):
            np.testing.assert_array_equal(a, b)
    ra, dec = jw.pixel_to_world(x, y)
    for a, b in zip(jw.world_to_pixel(ra, dec), tw.world_to_pixel(ra, dec)):
        np.testing.assert_array_equal(a, b)
    assert tw.pscale == jw.pscale
    M = np.array([[1.0001, 2e-4], [-1e-4, 0.9998]])
    t = np.array([0.31, -0.17])
    jn = j_apply(jw, _jwcs(3, sip=False), M, t)
    tn = apply_tangent_affine(tw, wcs_from_reference(_jwcs(3, sip=False)),
                              M, t)
    np.testing.assert_array_equal(jn.cd, tn.cd)
    np.testing.assert_array_equal(jn.crval, tn.crval)


@pytest.mark.parametrize("blc", [(0, 0), (37, -12)])
def test_compute_pixmap_exact(blc):
    jf, jt = _jwcs(4), _jwcs(5, sip=False)
    a = j_pixmap(jf, jt, (40, 52), blc=blc)
    b = compute_pixmap(wcs_from_reference(jf), wcs_from_reference(jt),
                       (40, 52), blc=blc)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def _star_image(seed=6):
    rng = np.random.default_rng(seed)
    H, W = 120, 140
    yy, xx = np.mgrid[0:H, 0:W]
    img = rng.normal(0, 0.1, (H, W))
    for x0, y0, a in zip(rng.uniform(8, W - 8, 25), rng.uniform(8, H - 8, 25),
                         rng.uniform(2, 30, 25)):
        img += a * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 5.0)
    # a blended pair the deblender must split
    img += 20 * np.exp(-((xx - 60) ** 2 + (yy - 60) ** 2) / 4.0)
    img += 15 * np.exp(-((xx - 66) ** 2 + (yy - 61) ** 2) / 4.0)
    return img.astype(np.float32)


def test_finder_and_primary_cutouts_exact():
    img = _star_image()
    jcat, jseg = j_find(img)
    tcat, tseg = find_sources(img)
    np.testing.assert_array_equal(tseg, jseg)
    assert tcat.colnames == jcat.colnames
    for k in jcat.colnames:
        np.testing.assert_array_equal(tcat[k], jcat[k])
    assert len(tcat) >= 20
    jw = _jwcs(7, sip=False)
    jp = j_prim(jcat, jseg, img, jw)
    tp = create_primary_cutouts(tcat, tseg, img, wcs_from_reference(jw))
    assert len(tp) == len(jp) > 0
    for a, b in zip(jp, tp):
        assert (a.blc, a.src_id, a.src_pos_parent, a.src_weight) == (
            b.blc, b.src_id, b.src_pos_parent, b.src_weight)
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.mask, b.mask)


def test_image_source_catalog_exact_and_filters(tmp_path):
    img = _star_image(8)
    j = JCatalog(img, nsigma=4.0)
    t = ImageSourceCatalog(img, nsigma=4.0)
    for c in (j, t):
        c.set_filters([("flux", ">", 5.0)])
    np.testing.assert_array_equal(t.catalog["x"], j.catalog["x"])
    np.testing.assert_array_equal(t.segmentation, j.segmentation)
    # a FITS path gives the catalog of the array it holds
    from subpixal_tpu_torch.io.fits import HDU, write_fits

    path = str(tmp_path / "image.fits")
    write_fits(path, HDU(img))
    f = ImageSourceCatalog(path, nsigma=4.0)
    f.set_filters([("flux", ">", 5.0)])
    for k in t.catalog.colnames:
        np.testing.assert_array_equal(f.catalog[k], t.catalog[k])
    np.testing.assert_array_equal(f.segmentation, t.segmentation)


def test_native_labeling_matches_scipy():
    rng = np.random.default_rng(9)
    mask = ndimage.gaussian_filter(rng.normal(size=(80, 90)), 2) > 0.1
    labels, n = _native.label_components(mask)
    ref, nref = ndimage.label(mask, structure=np.ones((3, 3)))
    assert n == nref
    # same partition (label numbering may differ)
    pairs = set(zip(labels[mask].tolist(), ref[mask].tolist()))
    assert len(pairs) == n


def test_exposures_from_reference_copies_state():
    rng = np.random.default_rng(10)
    je = JExposure(rng.normal(size=(8, 9)), _jwcs(11, tables=True),
                   weight=np.ones((8, 9)), exptime=42.0, name="e1",
                   data_units="counts", err=np.full((8, 9), 0.5))
    (te,) = exposures_from_reference([je])
    np.testing.assert_array_equal(te.data, je.data)
    np.testing.assert_array_equal(te.weight, je.weight)
    np.testing.assert_array_equal(te.err, je.err)
    assert (te.exptime, te.name, te.data_units) == (42.0, "e1", "counts")
    assert te.ivm is None
    np.testing.assert_array_equal(te.wcs.cpdis.data_x, je.wcs.cpdis.data_x)
    x = np.linspace(0, 8, 5)
    np.testing.assert_array_equal(te.wcs.pixel_to_world(x, x),
                                  je.wcs.pixel_to_world(x, x))


def test_import_does_not_load_jax():
    code = ("import sys, subpixal_tpu_torch, subpixal_tpu_torch.align, "
            "subpixal_tpu_torch.pipeline, subpixal_tpu_torch.cc, "
            "subpixal_tpu_torch.centroid, "
            "subpixal_tpu_torch.kernels.drizzle, "
            "subpixal_tpu_torch.kernels.blot, subpixal_tpu_torch.testing; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'subpixal_tpu.')) "
            "or m == 'subpixal_tpu']; "
            "assert not bad, bad; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
