"""Port parity: the rest of the public surface (cutouts, insertion, the
SExtractor wrappers, the package exports).

The host cutout functions and the SExtractor wrappers are numpy in both
packages and must agree EXACTLY on the same inputs; ``insert_cutouts`` is
plain torch against the JAX package's scatter, exact too (the 'add' sums
meet one cutout at a time in batch order in both). Every name the JAX
package exports, the port exports.
"""

import os
import re
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subpixal_tpu
import subpixal_tpu_torch
from subpixal_tpu import catalogs as jcat
from subpixal_tpu import cutout as jcut
from subpixal_tpu.ops.cutouts import insert_cutouts as j_insert
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import catalogs as tcat
from subpixal_tpu_torch import cutout as tcut
from subpixal_tpu_torch.convert import wcs_from_reference
from subpixal_tpu_torch.io.fits import HDU, write_fits
from subpixal_tpu_torch.ops.cutouts import insert_cutouts


def _jwcs(crpix, scale=0.05, rot=0.0):
    s = scale / 3600.0
    th = np.deg2rad(rot)
    cd = s * np.array([[-np.cos(th), np.sin(th)], [np.sin(th), np.cos(th)]])
    return JTanWCS(crpix=np.asarray(crpix, float),
                   crval=np.array([150.0, 2.0]), cd=cd)


def _field(h=128, w=128, seed=0, nsrc=8):
    """tests/test_cutout_host.py's field: well-separated Gaussian stars."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (h, w)).astype(np.float32)
    pts = []
    while len(pts) < nsrc:
        p = rng.uniform(15, [w - 15, h - 15])
        if all(np.hypot(*(p - q)) > 20.0 for q in pts):
            pts.append(p)
    yy, xx = np.mgrid[0:h, 0:w]
    for x0, y0 in pts:
        img += (100.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 8.0)
                ).astype(np.float32)
    return img


def _primaries(seed=0):
    """The same primary cutouts from both packages (their finders and
    primary cutouts are held equal by tests/test_torch_host.py)."""
    img = _field(seed=seed)
    jw = _jwcs((64, 64), rot=3.0)
    jc, jseg = jcat.find_sources(img, nsigma=5.0)
    tc, tseg = tcat.find_sources(img, nsigma=5.0)
    jp = jcut.create_primary_cutouts(jc, jseg, img, jw, pad=2)
    tp = tcut.create_primary_cutouts(tc, tseg, img, wcs_from_reference(jw),
                                     pad=2)
    return img, jw, jp, tp


def _same_cutouts(jl, tl):
    assert len(tl) == len(jl) > 0
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.mask, a.mask)
        assert (b.blc, b.trc, b.src_pos, b.src_id, b.src_weight, b.exptime,
                b.data_units) == (a.blc, a.trc, a.src_pos, a.src_id,
                                  a.src_weight, a.exptime, a.data_units)
        assert b.shape == a.shape and b.get_bbox() == a.get_bbox()
        assert b.pscale == a.pscale
        assert b.src_pos_parent == a.src_pos_parent
        for f in ("crpix", "crval", "cd"):
            np.testing.assert_array_equal(getattr(b.wcs, f),
                                          getattr(a.wcs, f))


@pytest.mark.parametrize("y0,x0,h,w,allow", [
    (4, 5, 8, 8, True), (-2, 0, 8, 8, True), (10, 12, 8, 8, True),
    (-2, 0, 8, 8, False), (100, 100, 8, 8, True)])
def test_extract_host_overlap_policy_matches_jax(y0, x0, h, w, allow):
    img = np.arange(16 * 18, dtype=np.float32).reshape(16, 18)
    try:
        want = jcut._extract_host(img, y0, x0, h, w, allow_partial=allow)
    except ValueError as e:  # the port raises its own class of that name
        with pytest.raises(getattr(tcut, type(e).__name__),
                           match=re.escape(str(e))):
            tcut._extract_host(img, y0, x0, h, w, allow_partial=allow)
        return
    got = tcut._extract_host(img, y0, x0, h, w, allow_partial=allow)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_overlap_exceptions_are_value_errors():
    for name in ("NoOverlapError", "PartialOverlapError"):
        assert issubclass(getattr(tcut, name), ValueError)
        assert getattr(subpixal_tpu_torch, name) is getattr(tcut, name)


@pytest.mark.parametrize("crpix,n_skipped", [((60.5, 66.2), 0),
                                             ((30.0, 66.0), 1)])
def test_create_input_image_cutouts_matches_jax(crpix, n_skipped):
    """Matched cutouts on a shifted exposure; where the exposure misses
    some sources, those pairs are skipped and the pairing stays aligned."""
    img, _, jp, tp = _primaries()
    flt = np.roll(np.roll(img, -3, axis=0), 4, axis=1)
    if n_skipped:
        flt = flt[:, :70]  # a narrow exposure: the right-hand sources fall off
    jw = _jwcs(crpix, rot=1.0)
    ji, jm = jcut.create_input_image_cutouts(jp, flt, jw, pad=2)
    ti, tm = tcut.create_input_image_cutouts(tp, flt, wcs_from_reference(jw),
                                             pad=2)
    _same_cutouts(ji, ti)
    assert [c.src_id for c in tm] == [c.src_id for c in jm]
    if n_skipped:
        assert len(tm) < len(tp)
    # create_cutouts is the same call; drz_from_input_cutouts maps back
    _same_cutouts(*(f(p, flt, w, pad=2)[0] for f, p, w in (
        (jcut.create_cutouts, jp, jw),
        (tcut.create_cutouts, tp, wcs_from_reference(jw)))))
    jb, jbm = jcut.drz_from_input_cutouts(ji, img, _jwcs((64, 64), rot=3.0))
    tb, tbm = tcut.drz_from_input_cutouts(
        ti, img, wcs_from_reference(_jwcs((64, 64), rot=3.0)))
    _same_cutouts(jb, tb)
    assert [c.src_id for c in tbm] == [c.src_id for c in jbm]


@pytest.mark.parametrize("shape", [None, (16, 16), (40, 24)])
def test_cutouts_to_batch_matches_jax(shape):
    _, _, jp, tp = _primaries(seed=1)
    want = jcut.cutouts_to_batch(jp, shape)
    got = tcut.cutouts_to_batch(tp, shape)
    for a, b in zip(want, got):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="no cutouts"):
        tcut.cutouts_to_batch([])


@pytest.mark.parametrize("mode", ["set", "add"])
def test_cutout_insert_into_image_matches_jax(mode):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(6, 5))
    mask = rng.random((6, 5)) > 0.3
    for blc in ((2, 3), (-2, 7), (8, -1)):
        images = [rng.normal(size=(10, 9)) for _ in range(2)]
        base = images[0].copy()
        images[1][:] = base
        a = jcut.Cutout(data, _jwcs((2, 2)), blc=blc, mask=mask)
        b = tcut.Cutout(data, wcs_from_reference(_jwcs((2, 2))), blc=blc,
                        mask=mask)
        a.insert_into_image(images[0], mode=mode)
        b.insert_into_image(images[1], mode=mode)
        np.testing.assert_array_equal(images[1], images[0])
        assert not np.array_equal(images[1], base)
    far = tcut.Cutout(data, wcs_from_reference(_jwcs((2, 2))), blc=(50, 50))
    with pytest.raises(tcut.NoOverlapError):
        far.insert_into_image(np.zeros((10, 9)))
    with pytest.raises(ValueError, match="mode"):
        b.insert_into_image(np.zeros((10, 9)), mode="max")


@pytest.mark.parametrize("mode", ["set", "add"])
@pytest.mark.parametrize("masked", [False, True])
def test_insert_cutouts_matches_jax(mode, masked):
    """Overlapping cutouts (the last wins under 'set'), cutouts partly and
    wholly off the image, and masked-out pixels."""
    rng = np.random.default_rng(3)
    image = rng.normal(size=(40, 36)).astype(np.float32)
    data = rng.normal(size=(6, 9, 11)).astype(np.float32)
    blc = np.array([[3, 4], [6, 8], [5, 5], [-4, 30], [35, -6], [90, 90]],
                   np.int32)
    mask = rng.random(data.shape) > 0.25 if masked else None
    want = j_insert(jnp.asarray(image), jnp.asarray(data), jnp.asarray(blc),
                    None if mask is None else jnp.asarray(mask), mode=mode)
    got = insert_cutouts(torch.from_numpy(image), torch.from_numpy(data),
                         torch.from_numpy(blc),
                         None if mask is None else torch.from_numpy(mask),
                         mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mode"):
        insert_cutouts(torch.from_numpy(image), torch.from_numpy(data),
                       torch.from_numpy(blc), mode="max")


_HEAD = ("#   1 NUMBER     Running object number\n"
         "#   2 X_IMAGE    Object position along x    [pixel]\n"
         "#   3 Y_IMAGE    Object position along y    [pixel]\n"
         "#   5 FLUX_ISO   Isophotal flux\n"
         "#   6 FLUX_BEST  Best of FLUX_AUTO and FLUX_ISOCOR\n")


def _write_sex_outputs(cat_path, seg_path, rows):
    with open(cat_path, "w") as f:
        f.write(_HEAD)
        for r in rows:
            f.write(" ".join(repr(float(v)) for v in r) + "\n")
    seg = np.zeros((20, 24), np.int32)
    seg[3:7, 8:12] = 1
    seg[12:15, 2:6] = 2
    write_fits(seg_path, [HDU(seg)])


def _same_catalog(jc, tc):
    jt, tt = jc.catalog, tc.catalog
    assert tt.colnames == jt.colnames
    for k in jt.colnames:
        assert tt[k].dtype == jt[k].dtype
        np.testing.assert_array_equal(tt[k], jt[k])
    if jc.segmentation is None:
        assert tc.segmentation is None
    else:
        np.testing.assert_array_equal(tc.segmentation, jc.segmentation)


_ROWS = [(1, 10.5, 4.25, 7.0, 100.0, 110.0),
         (2, 4.0, 13.5, 7.5, 250.0, 240.0),
         (3, 20.25, 18.0, 1.0, 5.0, 6.0)]


@pytest.mark.parametrize("rows,seg,filt", [
    (_ROWS, True, None), (_ROWS, False, [("flux", ">", 50.0)]),
    ([], False, None)])
def test_sex_catalog_matches_jax(tmp_path, rows, seg, filt):
    """An ASCII_HEAD catalog (a column without a header line, FLUX_ISO
    taken before FLUX_BEST) and its segmentation FITS file."""
    cat, segf = str(tmp_path / "in.cat"), str(tmp_path / "seg.fits")
    _write_sex_outputs(cat, segf, rows)
    jc = jcat.SExCatalog(cat, segf if seg else None)
    tc = tcat.SExCatalog(cat, segf if seg else None)
    for c in (jc, tc):
        c.set_filters(filt)
    _same_catalog(jc, tc)
    if rows:
        np.testing.assert_array_equal(tc.rawcat["x"], [9.5, 3.0, 19.25])
        assert "col4" in tc.rawcat.colnames
        np.testing.assert_array_equal(tc.rawcat["flux"], [100., 250., 5.])


_FAKE_SEX = """#!{python}
import os, shutil, sys
args = sys.argv[1:]
opt = dict(zip(args[1::2], args[2::2]))
with open({log!r}, "w") as f:
    f.write(os.getcwd() + "\\n" + " ".join(args))
shutil.copy({cat!r}, opt["-CATALOG_NAME"])
shutil.copy({seg!r}, opt["-CHECKIMAGE_NAME"])
"""


def test_sex_image_catalog_runs_binary_matches_jax(tmp_path, monkeypatch):
    """Both packages find a ``sex`` on PATH, run it with absolute paths
    and ``cwd=workdir``, and read back the same catalog and segmentation."""
    src = tmp_path / "src"
    src.mkdir()
    cat, segf = str(src / "made.cat"), str(src / "made_seg.fits")
    _write_sex_outputs(cat, segf, _ROWS)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = str(tmp_path / "sex.log")
    exe = bindir / "sex"
    exe.write_text(_FAKE_SEX.format(python=sys.executable, log=log, cat=cat,
                                    seg=segf))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    work = tmp_path / "work"
    work.mkdir()
    (tmp_path / "img.fits").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    runs = []
    for mod in (jcat, tcat):
        c = mod.SExImageCatalog("img.fits", "conf.sex", workdir="work")
        assert os.path.basename(c.sextractor_cmd) == "sex"
        c.execute()
        with open(log) as f:
            cwd, argv = f.read().splitlines()
        runs.append((c, cwd, argv))
    (jc, jcwd, jargv), (tc, tcwd, targv) = runs
    assert tcwd == jcwd == str(work)
    assert targv == jargv
    assert str(tmp_path / "img.fits") in targv.split()
    _same_catalog(jc, tc)


def test_sex_image_catalog_without_binary_raises(tmp_path, monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda *_a, **_k: None)
    c = tcat.SExImageCatalog(str(tmp_path / "x.fits"), "conf.sex")
    assert c.sextractor_cmd is None
    with pytest.raises(RuntimeError, match="SExtractor"):
        c.execute()


def test_package_exports_cover_jax():
    assert set(subpixal_tpu.__all__) <= set(subpixal_tpu_torch.__all__)
    assert subpixal_tpu_torch.__version__ == subpixal_tpu.__version__
    for name in subpixal_tpu_torch.__all__:
        assert hasattr(subpixal_tpu_torch, name), name
