"""Port parity: the FITS pipeline vs ``subpixal_tpu``.

``io/fits.py``, ``fitswcs.py`` and ``utils.py`` are numpy in both
packages: each package's writer must produce the same bytes for the same
HDUs, read the other's files, and build the same WCSs (exact equality).
``load_exposures`` builds equal exposures. ``align_images`` with the
AstroDrizzle stages on, ``align_fits`` end to end and the HST-shape scene
(two gzip'd files of two SCI chips with WHT extensions, SIP and per-chip
table distortion) follow the JAX package's run iteration by iteration
within ``SHIFT_TOL`` px with equal ``nmatches`` (the JAX package on the
CPU, the port on ``device="cpu"``), and the rewritten headers reload to
the returned WCSs.
"""

import gzip
import os
import warnings

import numpy as np
import pytest
import torch

from subpixal_tpu import align_images as j_align
from subpixal_tpu.io import fits as JF
from subpixal_tpu.pipeline import align_fits as j_align_fits
from subpixal_tpu.pipeline import load_exposures as j_load
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.utils import parse_file_name as j_parse
from subpixal_tpu.utils import py2round as j_py2round
from subpixal_tpu.wcs import fitswcs as JW
from subpixal_tpu.wcs.wcs import DistGrid as JDistGrid
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align_images, fitswcs as TW
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.io import fits as TF
from subpixal_tpu_torch.pipeline import AlignState, align_fits, load_exposures
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.utils import parse_file_name, py2round

torch.set_num_threads(2)

#: every iteration's shifts against the JAX package's (px)
SHIFT_TOL = 1e-3

SCALE = 0.05 / 3600.0


# --------------------------------------------------------------------- #
# FITS files: the cases of tests/test_fits.py, written by both packages
# --------------------------------------------------------------------- #

def _header(F, cards=(), history=()):
    h = F.Header()
    for k, v in cards:
        h[k] = v
    for line in history:
        h.add_history(line)
    return h


def _fits_case(name, F):
    """(hdus, suffix) of one tests/test_fits.py case, built with the
    module ``F`` (either package's io.fits)."""
    rng = np.random.default_rng(0)
    if name.startswith("dtype_"):
        dt = np.dtype(name[6:])
        data = (rng.integers(0, 100, (7, 11)) if dt.kind in "iu"
                else rng.normal(size=(7, 11))).astype(dt)
        return [F.HDU(data=data)], ".fits"
    if name == "multi_ext":
        return [F.HDU(), F.HDU(np.ones((4, 4), np.float32),
                               _header(F, [("EXTNAME", "SCI"),
                                           ("EXTVER", 1)])),
                F.HDU(2 * np.ones((4, 4), np.float32),
                      _header(F, [("EXTNAME", "SCI"), ("EXTVER", 2)]))], \
            ".fits"
    if name == "header_types":
        h = _header(F, [("CRPIX1", 2048.5),
                        ("CRVAL1", (150.1234567890123,
                                    "RA of reference pixel")),
                        ("NITER", 42), ("ALIGNED", True),
                        ("TARGNAME", "NGC-1234 o'neill"),
                        ("BIGNUM", 1.23e-11)],
                    ["aligned by subpixal_tpu"])
        return [F.HDU(np.zeros((2, 2), np.float32), h)], ".fits"
    if name == "bscale_bzero":
        h = _header(F, [("BZERO", 32768.0), ("BSCALE", 1.0)])
        return [F.HDU(np.array([[0, 1], [2, 3]], np.int16), h)], ".fits"
    if name == "cube":
        return [F.HDU(np.arange(24, dtype=np.float32).reshape(2, 3, 4))], \
            ".fits"
    if name == "long_string":
        return [F.HDU(np.zeros((2, 2), np.float32),
                      _header(F, [("LONGVAL", "x" * 100)]))], ".fits"
    if name == "gzip":
        return [F.HDU(rng.normal(size=(9, 13)).astype(np.float32),
                      _header(F, [("OBJECT", "gztest")]))], ".fits.gz"
    if name == "long_history":
        long = "matrix=" + ",".join(f"{v:.8f}" for v in np.linspace(0, 1, 12))
        return [F.HDU(np.zeros((2, 2), np.float32),
                      _header(F, history=[long]))], ".fits"
    raise KeyError(name)


FITS_CASES = ["dtype_uint8", "dtype_int16", "dtype_int32", "dtype_float32",
              "dtype_float64", "multi_ext", "header_types", "bscale_bzero",
              "cube", "long_string", "gzip", "long_history"]


def _same_hdus(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x.header.items()) == list(y.header.items())
        assert x.header.history == y.header.history
        if x.data is None:
            assert y.data is None
        else:
            assert x.data.dtype == y.data.dtype
            np.testing.assert_array_equal(x.data, y.data)


@pytest.mark.parametrize("case", FITS_CASES)
def test_fits_bytes_identical_and_cross_read(tmp_path, case):
    paths = {}
    for tag, F in (("jax", JF), ("port", TF)):
        hdus, suffix = _fits_case(case, F)
        paths[tag] = str(tmp_path / f"{tag}{suffix}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the long string's truncation
            F.write_fits(paths[tag], hdus)
    with open(paths["jax"], "rb") as fa, open(paths["port"], "rb") as fb:
        assert fa.read() == fb.read()
    _same_hdus(TF.read_fits(paths["jax"]), JF.read_fits(paths["jax"]))
    _same_hdus(JF.read_fits(paths["port"]), TF.read_fits(paths["port"]))
    if case == "multi_ext":
        assert TF.read_fits(paths["jax"])["SCI", 2].data[0, 0] == 2.0


# --------------------------------------------------------------------- #
# fitswcs and utils
# --------------------------------------------------------------------- #

def _jwcs(tables=True, crpix=(128.0, 120.0), seed=7):
    rng = np.random.default_rng(seed)
    a = np.zeros((3, 3))
    a[2, 0], a[0, 2] = 4e-7, -3e-7
    b = np.zeros((3, 3))
    b[2, 0], b[0, 2] = -2e-7, 3e-7
    kw = {}
    if tables:
        kw["cpdis"] = JDistGrid(data_x=rng.normal(0, 0.05, (8, 8)),
                                data_y=rng.normal(0, 0.05, (8, 8)),
                                crpix=(0.0, 0.0), crval=(0.0, 0.0),
                                cdelt=(256 / 7, 256 / 7))
        kw["d2im"] = JDistGrid(data_x=rng.normal(0, 0.02, (6, 6)),
                               cdelt=(256 / 5, 256 / 5))
    return JTanWCS(crpix=np.asarray(crpix), crval=np.array([150.0, 2.0]),
                   cd=SCALE * np.array([[-1.0, 0.001], [0.002, 1.0]]),
                   a=a, b=b, ap=-a, bp=-b, **kw)


def _same_wcs(t, j):
    for f in ("crpix", "crval", "cd", "a", "b", "ap", "bp"):
        x, y = getattr(t, f), getattr(j, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for g in ("cpdis", "d2im"):
        x, y = getattr(t, g), getattr(j, g)
        assert (x is None) == (y is None), g
        if x is not None:
            for f in ("data_x", "data_y", "crpix", "crval", "cdelt"):
                u, v = getattr(x, f), getattr(y, f)
                if u is None or v is None:
                    assert u is None and v is None
                else:
                    np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("tables", [False, True])
def test_fitswcs_roundtrips_match_jax(tmp_path, tables):
    """wcs_to_header writes the same cards, wcs_from_header /
    wcs_from_hdul read the same WCS (SIP and table distortion, chip 2 of
    a multi-chip file at EXTVER 3, 4), in both packages."""
    jw = _jwcs(tables)
    tw = exposures_from_reference([JExposure(np.zeros((2, 2)), jw)])[0].wcs
    th = TW.wcs_to_header(tw, TF.Header())
    jh = JW.wcs_to_header(jw, JF.Header())
    assert list(th.items()) == list(jh.items())
    _same_wcs(TW.wcs_from_header(th), JW.wcs_from_header(jh))
    # a stale PC/CDELT representation is removed on write
    stale = TF.Header()
    for k, v in (("PC1_1", 1.0), ("CDELT1", 1e-5), ("A_ORDER", 5),
                 ("A_4_1", 1e-12)):
        stale[k] = v
    TW.wcs_to_header(tw, stale)
    assert "PC1_1" not in stale and "A_4_1" not in stale
    if not tables:
        return
    for F, W, w in ((TF, TW, tw), (JF, JW, jw)):
        sci = F.HDU(np.zeros((4, 4), np.float32),
                    _header(F, [("EXTNAME", "SCI"), ("EXTVER", 2)]))
        W.wcs_to_header(w, sci.header)
        hdus = ([F.HDU(), sci] + W.distortion_to_hdus(w.cpdis, "WCSDVARR",
                                                      extvers=(3, 4))
                + W.distortion_to_hdus(w.d2im, "D2IMARR"))
        F.write_fits(str(tmp_path / f"{F.__name__}.fits"), hdus)
    files = [str(tmp_path / f"{F.__name__}.fits") for F in (TF, JF)]
    with open(files[0], "rb") as fa, open(files[1], "rb") as fb:
        assert fa.read() == fb.read()
    for f in files:
        t = TW.wcs_from_hdul(TF.read_fits(f), ext=("SCI", 2), chip=2)
        j = JW.wcs_from_hdul(JF.read_fits(f), ext=("SCI", 2), chip=2)
        _same_wcs(t, j)
        for k in ("crpix", "crval", "cd", "a", "bp"):  # tables are f32
            np.testing.assert_array_equal(getattr(t, k), getattr(tw, k))
        g = TW.distortion_from_hdus(TF.read_fits(f), "WCSDVARR",
                                    extvers=(3, 4))
        np.testing.assert_array_equal(g.data_x, np.float32(tw.cpdis.data_x))


@pytest.mark.parametrize("spec,want", [
    ("img.fits", ("img.fits", None)),
    ("img.fits[3]", ("img.fits", 3)),
    ("img.fits[sci]", ("img.fits", ("SCI", 1))),
    ("img.fits[sci,2]", ("img.fits", ("SCI", 2))),
    ("img.fits[SCI, 2]", ("img.fits", ("SCI", 2))),
    ("/a/b/img.fits[err,1]", ("/a/b/img.fits", ("ERR", 1))),
])
def test_parse_file_name_matches_jax(spec, want):
    assert parse_file_name(spec) == want == j_parse(spec)


def test_py2round_and_bad_spec():
    for x in (0.5, -0.5, 1.5, 2.5, -2.5, 0.49, -3.7):
        assert py2round(x) == j_py2round(x)
    assert (py2round(0.5), py2round(-0.5), py2round(2.5)) == (1.0, -1.0, 3.0)
    with pytest.raises(ValueError):
        parse_file_name("img.fits[a,1,2]")


# --------------------------------------------------------------------- #
# scenes: tests/test_align.py's planted scene and the HST-shape visit
# --------------------------------------------------------------------- #

def _make_wcs(crpix):
    return JTanWCS(crpix=np.asarray(crpix, float),
                   crval=np.array([150.0, 2.0]),
                   cd=SCALE * np.array([[-1.0, 0.0], [0.0, 1.0]]))


def _planted_scene(n_exp, shift_err, shape=(256, 256), seed=1):
    """tests/test_align.py · planted_scene: stars rendered with each
    exposure's TRUE WCS, headers carrying a WRONG one."""
    rng = np.random.default_rng(seed)
    stars = []
    while len(stars) < 30:
        p = rng.uniform(30, 220, 2)
        if all(np.hypot(*(p - q)) > 18.0 for q in stars):
            stars.append(p)
    stars = np.asarray(stars)
    ref_frame = _make_wcs((128, 128))
    rng = np.random.default_rng(seed + 10)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    exps = []
    for e in range(n_exp):
        dith = rng.uniform(-6, 6, 2)
        true_wcs = _make_wcs((128 + dith[0], 128 + dith[1]))
        err = np.asarray(shift_err[e], float)
        img = np.random.default_rng(100 + e).normal(0, 0.5, shape)
        xs, ys = true_wcs.world_to_pixel(
            *ref_frame.pixel_to_world(stars[:, 0], stars[:, 1]))
        for x0, y0 in zip(xs, ys):
            if -10 < x0 < W + 10 and -10 < y0 < H + 10:
                img += 200.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                      / (2 * 1.8 ** 2))
        wrong = _make_wcs((128 + dith[0] + err[0], 128 + dith[1] + err[1]))
        exps.append(JExposure(img.astype(np.float32), wrong, name=f"e{e}"))
    return exps, ref_frame, stars


def _assert_same_run(jr, tr):
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            # each package's files differ in their first letter only
            assert (os.path.basename(a.name)[1:], a.iteration,
                    a.nmatches) == (os.path.basename(b.name)[1:],
                                    b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)


def test_align_precombine_stages_match_jax():
    """tests/test_align.py · test_align_precombine_stages through both
    packages: sky offsets, match_sky + static_mask + reject_cr on; the
    runs agree at every iteration and the caller's exposures are
    untouched."""
    exps, _, _ = _planted_scene(3, [(0, 0), (0.8, -0.5), (-0.4, 0.6)])
    for e, off in zip(exps, (0.5, -0.2, 0.9)):
        e.data = e.data + np.float32(off)
    texps = exposures_from_reference(exps)
    before = [e.data.copy() for e in texps]
    kw = dict(fitgeom="shift", max_iterations=3, eps_shift=0.004, usfac=1,
              fit_type="gaussian", min_sources=5, match_sky=True,
              static_mask=True, reject_cr=True)
    jr = j_align(resample=JDrizzle(exps), **kw)
    tr = align_images(resample=Drizzle(texps, device="cpu"), device="cpu",
                      **kw)
    _assert_same_run(jr, tr)
    assert tr.converged
    assert "resample.deposits" in tr.setup_breakdown
    for e, b in zip(texps, before):
        np.testing.assert_array_equal(e.data, b)
        assert e.weight is None


def _write_scene(tmp_path, exps, F, W, prefix, chips=1, counts=False):
    """Write exposures as FITS files of ``chips`` SCI extensions each with
    either package's writer."""
    paths = []
    for f in range(len(exps) // chips):
        hdus = [F.HDU()]
        for c in range(chips):
            e = exps[chips * f + c]
            h = _header(F, [("EXTNAME", "SCI"), ("EXTVER", c + 1),
                            ("EXPTIME", 1.0)])
            if counts:
                h["BUNIT"] = "ELECTRONS"
            W.wcs_to_header(e.wcs, h)
            hdus.append(F.HDU(np.asarray(e.data), h))
        p = str(tmp_path / f"{prefix}{f}_flt.fits")
        F.write_fits(p, hdus)
        paths.append(p)
    return paths


def test_load_exposures_match_jax(tmp_path):
    """Multi-SCI expansion, ext specs, BUNIT rate forms and WHT/ERR
    pairing by EXTVER: the same exposures from both loaders."""
    exps, _, _ = _planted_scene(2, [(0, 0), (0.3, 0.1)], shape=(64, 64))
    hdus = [TF.HDU(header=_header(TF, [("EXPTIME", 30.0)]))]
    for c, (e, bunit) in enumerate(zip(exps, ("ELECTRONS",
                                              "ELECTRON S**-1"))):
        h = _header(TF, [("EXTNAME", "SCI"), ("EXTVER", c + 1),
                         ("BUNIT", bunit)])
        TW.wcs_to_header(exposures_from_reference([e])[0].wcs, h)
        hdus.append(TF.HDU(np.asarray(e.data), h))
        for name, val in (("WHT", 1.0 + c), ("ERR", 0.5)):
            hdus.append(TF.HDU(np.full((64, 64), val, np.float32),
                               _header(TF, [("EXTNAME", name),
                                            ("EXTVER", c + 1)])))
    p = str(tmp_path / "two_flt.fits")
    TF.write_fits(p, hdus)
    for specs, kw in (([p], dict(wht_ext="WHT", err_ext="ERR")),
                      ([p + "[sci,2]"], dict(wht_ext="WHT")),
                      ([p], dict(ext=("SCI", 2))), ([p + "[1]"], {})):
        t, j = load_exposures(specs, **kw), j_load(specs, **kw)
        assert len(t) == len(j) > 0
        for a, b in zip(j, t):
            assert (b.name, b.exptime, b.data_units) == (
                a.name, a.exptime, a.data_units)
            np.testing.assert_array_equal(b.data, np.asarray(a.data))
            for f in ("weight", "err"):
                x, y = getattr(b, f), getattr(a, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
            _same_wcs(b.wcs, a.wcs)
    two = load_exposures([p], wht_ext="WHT")
    assert [e.data_units for e in two] == ["counts", "rate"]
    assert two[1].name.endswith("[sci,2]") and two[1].weight[0, 0] == 2.0


def test_align_fits_end_to_end_matches_jax(tmp_path):
    """tests/test_pipeline.py · test_align_fits_end_to_end on copies of
    the same files written by each package: the runs agree at every
    iteration, the rewritten headers reload to the returned WCSs, HISTORY
    is written and the state file reloads."""
    err = np.array([(0.0, 0.0), (1.0, -0.5)])
    exps, ref_frame, stars = _planted_scene(2, err)
    jp = _write_scene(tmp_path, exps, JF, JW, "j")
    tp = _write_scene(tmp_path, exps, TF, TW, "t")
    for a, b in zip(jp, tp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    kw = dict(fitgeom="shift", max_iterations=3, eps_shift=0.004,
              fit_type="gaussian", min_sources=5)
    state = str(tmp_path / "state.json")
    jr = j_align_fits(jp, **kw)
    tr = align_fits(tp, device="cpu", state_file=state, **kw)
    _assert_same_run(jr, tr)
    for p, exp in zip(tp, tr.exposures):
        hdu = TF.read_fits(p)[("SCI", 1)]
        _same_wcs(TW.wcs_from_header(hdu.header), exp.wcs)
        assert any(h.startswith("subpixal_tpu_torch: aligned")
                   for h in hdu.header.history)
    ra, dec = ref_frame.pixel_to_world(stars[:, 0], stars[:, 1])
    new = [TW.wcs_from_header(TF.read_fits(p)[("SCI", 1)].header)
           .world_to_pixel(ra, dec) for p in tp]
    old = [e.wcs.world_to_pixel(ra, dec) for e in exps]
    np.testing.assert_allclose((new[1][0] - new[0][0]) - (old[1][0] - old[0][0]),
                               -err[1, 0], atol=0.02)
    st = AlignState.load(state)
    assert st.n_iterations == tr.n_iterations and st.images == [
        e.name for e in tr.exposures]
    np.testing.assert_allclose(st.shifts, tr.shifts, atol=1e-9)
    assert len(st.history) == len(tr.history)


def _smooth_grid(ny, nx, amp, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1.0, (ny, nx))
    for _ in range(3):
        g = 0.25 * (np.roll(g, 1, 0) + np.roll(g, -1, 0)
                    + np.roll(g, 1, 1) + np.roll(g, -1, 1))
    return (amp * g / np.abs(g).max()).astype(np.float64)


def _chip_wcs(crpix, seed):
    a = np.zeros((3, 3))
    a[2, 0], a[0, 2] = 4e-7, -3e-7
    b = np.zeros((3, 3))
    b[2, 0], b[0, 2] = -2e-7, 3e-7
    cpdis = JDistGrid(data_x=_smooth_grid(8, 8, 0.06, seed),
                      data_y=_smooth_grid(8, 8, 0.06, seed + 1),
                      crpix=(0.0, 0.0), crval=(0.0, 0.0),
                      cdelt=(256 / 7, 256 / 7))
    d2im = JDistGrid(data_x=_smooth_grid(6, 6, 0.02, 99), crpix=(0.0, 0.0),
                     crval=(0.0, 0.0), cdelt=(256 / 5, 256 / 5))
    return JTanWCS(crpix=np.asarray(crpix, float),
                   crval=np.array([150.0, 2.0]),
                   cd=SCALE * np.array([[-1.0, 0.0], [0.0, 1.0]]),
                   a=a, b=b, cpdis=cpdis, d2im=d2im)


def _hst_visit(tmp_path, F, W, prefix):
    """tests/test_integration_hst.py's visit written with ``F``/``W``: two
    gzip'd files of two 256² SCI chips (BUNIT ELECTRONS) with WHT
    extensions, TAN+SIP, per-chip WCSDVARR at EXTVER (2k-1, 2k) and a
    shared D2IMARR; chip pairs of the second file off by (0.8, -0.5)."""
    ref_frame = _make_wcs((128.0, 270.0))
    rng = np.random.default_rng(3)
    sky = []
    while len(sky) < 34:
        p = rng.uniform((30, 30), (226, 510))
        if all(np.hypot(*(p - q)) > 16 for q in sky):
            sky.append(p)
    sky = np.asarray(sky)
    rng = np.random.default_rng(11)
    err = np.array([[(0.0, 0.0), (0.0, 0.0)], [(0.8, -0.5), (0.8, -0.5)]])
    yy, xx = np.mgrid[0:256, 0:256]
    paths, true_all = [], []
    for f in range(2):
        dith = rng.uniform(-4, 4, 2)
        hdus, tabs = [F.HDU()], []
        for chip in range(2):
            crpix = (128 + dith[0], 128 + dith[1] - 270 * chip)
            true_w = _chip_wcs(crpix, seed=7 + chip)
            e = err[f, chip]
            wrong = true_w.replace(crpix=np.array([crpix[0] + e[0],
                                                   crpix[1] + e[1]]))
            img = np.random.default_rng(40 + 2 * f + chip).normal(
                0, 0.1, (256, 256))
            xs, ys = true_w.world_to_pixel(
                *ref_frame.pixel_to_world(sky[:, 0], sky[:, 1]))
            for x0, y0 in zip(xs, ys):
                if -10 < x0 < 266 and -10 < y0 < 266:
                    img += 250.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                          / (2 * 2.2 ** 2))
            tw = exposures_from_reference([JExposure(np.zeros((1, 1)),
                                                     wrong)])[0].wcs
            wcs = wrong if W is JW else tw
            h = _header(F, [("EXTNAME", "SCI"), ("EXTVER", chip + 1),
                            ("EXPTIME", 1.0), ("BUNIT", "ELECTRONS")])
            W.wcs_to_header(wcs, h)
            hdus.append(F.HDU(img.astype(np.float32), h))
            hdus.append(F.HDU(np.ones((256, 256), np.float32),
                              _header(F, [("EXTNAME", "WHT"),
                                          ("EXTVER", chip + 1)])))
            tabs += W.distortion_to_hdus(wcs.cpdis, "WCSDVARR",
                                         extvers=(2 * chip + 1, 2 * chip + 2))
            true_all.append(true_w)
        tabs += W.distortion_to_hdus(wcs.d2im, "D2IMARR")
        p = str(tmp_path / f"{prefix}visit{f}_flt.fits.gz")
        F.write_fits(p, hdus + tabs)
        paths.append(p)
    return paths, ref_frame, sky, true_all, err


def test_hst_visit_matches_jax(tmp_path):
    """The HST-shape 2-chip gzip visit through both packages' align_fits
    (3 iterations): the same files byte for byte, the same exposures, the
    runs agree at every iteration, and the port's rewritten headers
    reload to its WCSs and meet the 5 mpix chip-pair bar."""
    jp, ref_frame, sky, true_all, err = _hst_visit(tmp_path, JF, JW, "j")
    tp, *_ = _hst_visit(tmp_path, TF, TW, "t")
    for a, b in zip(jp, tp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            raw = fa.read()
            assert raw[:2] == b"\x1f\x8b" and raw == fb.read()
        assert len(gzip.decompress(raw)) % 2880 == 0
    loaded = load_exposures(tp, wht_ext="WHT")
    assert len(loaded) == 4 and all(e.weight is not None for e in loaded)
    assert all(e.data_units == "counts" for e in loaded)
    kw = dict(wht_ext="WHT", fitgeom="shift", max_iterations=3,
              eps_shift=0.001, usfac=16, fit_type="gaussian", min_sources=5)
    jr = j_align_fits(jp, **kw)
    tr = align_fits(tp, device="cpu", **kw)
    _assert_same_run(jr, tr)
    ra, dec = ref_frame.pixel_to_world(sky[:, 0], sky[:, 1])
    rel = []
    for k, (f, chip) in enumerate([(0, 1), (0, 2), (1, 1), (1, 2)]):
        w = TW.wcs_from_hdul(TF.read_fits(tp[f]), ext=("SCI", chip),
                             chip=chip)
        _same_wcs(w, tr.exposures[k].wcs)
        xs, ys = w.world_to_pixel(ra, dec)
        xt, yt = true_all[k].world_to_pixel(ra, dec)
        rel.append(np.stack([xs - xt, ys - yt]))
    rel = np.asarray(rel)
    pair = max(1e3 * float(np.sqrt(np.mean((rel[2] - rel[0]) ** 2))),
               1e3 * float(np.sqrt(np.mean((rel[3] - rel[1]) ** 2))))
    assert pair < 5.0, f"end-to-end residual {pair:.2f} mpix"
    sh = np.asarray(tr.shifts)
    for a, b in ((2, 0), (3, 1)):
        assert 1e3 * np.abs((sh[a] - sh[b]) - err[1, 0]).max() < 2.0


def test_image_source_catalog_from_fits(tmp_path):
    """A FITS path (first HDU with data, or an [ext] spec) gives the
    catalog of the array itself."""
    exps, _, _ = _planted_scene(1, [(0, 0)], shape=(96, 96))
    img = np.asarray(exps[0].data)
    p = str(tmp_path / "img.fits")
    TF.write_fits(p, [TF.HDU(), TF.HDU(img, _header(
        TF, [("EXTNAME", "SCI"), ("EXTVER", 1)]))])
    want = ImageSourceCatalog(img).catalog
    for spec in (p, p + "[sci,1]", p + "[1]"):
        got = ImageSourceCatalog(spec).catalog
        assert got.colnames == want.colnames and len(got) > 0
        for k in want.colnames:
            np.testing.assert_array_equal(got[k], want[k])
    TF.write_fits(p, [TF.HDU()])
    with pytest.raises(ValueError, match="no image data"):
        ImageSourceCatalog(p).execute()
