"""Port parity: float32 device pixmaps and blot vs the JAX package.

The port's ``compute_pixmap_device`` / ``compute_cutout_pixmaps_device``
(and their ``_stack`` forms), evaluated in torch on the CPU, are held to
the JAX package's device pixmaps within ``DEV_TOL`` px (both evaluate the
same float32 composition in the same order) and to its float64 host
pixmaps within ``HOST_TOL`` px (the float32 rounding of coordinates of a
few hundred px), for plain TAN, SIP (forward + inverse polynomials, and
forward only, inverted by Picard iteration) and lookup-table (d2im,
cpdis) distortions on either side. ``blot_image`` / ``blot_cutout`` are
held to the JAX package's on the same inputs.
"""

import numpy as np
import pytest
import torch

from subpixal_tpu import blot as JB
from subpixal_tpu.cutout import Cutout as JCutout
from subpixal_tpu.wcs.wcs import DistGrid as JDistGrid
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import blot as TB
from subpixal_tpu_torch.convert import wcs_from_reference
from subpixal_tpu_torch.cutout import Cutout

torch.set_num_threads(2)

#: against the JAX package's float32 device pixmaps (px)
DEV_TOL = 1e-4
#: against the JAX package's float64 host pixmaps (px)
HOST_TOL = 5e-4


def _smooth_grid(gh, gw, amp, seed):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:gh, 0:gw].astype(float)
    gy /= gh - 1
    gx /= gw - 1
    return amp * (np.sin(2.1 * np.pi * gx + rng.uniform(0, 1))
                  * np.cos(1.7 * np.pi * gy + rng.uniform(0, 1)))


def _sip():
    a = np.zeros((4, 4))
    a[0, 2] = 1e-7
    a[2, 0] = -2e-7
    b = np.zeros((4, 4))
    b[0, 2] = -1e-7
    return a, b


_CD = (0.05 / 3600.0) * np.array([[-0.9998, 0.02], [0.021, 1.0001]])


def _wcs(kind, seed=5, size=512):
    """JAX-package WCSs of each distortion kind (tests/test_wcs.py's)."""
    if kind == "tan":
        return JTanWCS(crpix=np.array([size / 2 + 8.0, size / 2 - 7.0]),
                       crval=np.array([150.002, 2.001]),
                       cd=(0.05 / 3600.0) * np.array([[-1.0, 0.0],
                                                      [0.0, 1.0]]))
    a, b = _sip()
    kw = dict(crpix=np.array([size / 2, size / 2]),
              crval=np.array([150.0, 2.0]), cd=_CD, a=a, b=b)
    if kind == "sip_inverse":
        ap, bp = -a, -b  # first-order inverse
        return JTanWCS(ap=ap, bp=bp, **kw)
    if kind == "sip":
        return JTanWCS(**kw)
    cpdis = JDistGrid(
        data_x=_smooth_grid(16, 16, 0.1, seed),
        data_y=_smooth_grid(16, 16, 0.1, seed + 1),
        crpix=(0.0, 0.0), crval=(0.0, 0.0),
        cdelt=(size / 15, size / 15))
    d2im = JDistGrid(data_x=_smooth_grid(8, 8, 0.04, seed + 2),
                     crpix=(0.0, 0.0), crval=(0.0, 0.0),
                     cdelt=(size / 7, size / 7))
    return JTanWCS(cpdis=cpdis, d2im=d2im, **kw)


PAIRS = [("sip", "tan"), ("tan", "sip"), ("tan", "sip_inverse"),
         ("sip_inverse", "sip_inverse"), ("tan", "tan"), ("tables", "tan"),
         ("tan", "tables"), ("tables", "tables")]


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("src,dst", PAIRS)
def test_frame_pixmap_device_matches_jax(src, dst):
    js, jd = _wcs(src), _wcs(dst, seed=9)
    shape = (256, 320)
    jx, jy = JB.compute_pixmap_device(js, jd, shape)
    hx, hy = JB.compute_pixmap(js, jd, shape)
    tx, ty = TB.compute_pixmap_device(wcs_from_reference(js),
                                      wcs_from_reference(jd), shape,
                                      device="cpu")
    assert tx.dtype == torch.float32 and tuple(tx.shape) == shape
    assert _max_err(tx, jx) < DEV_TOL and _max_err(ty, jy) < DEV_TOL
    assert _max_err(tx, hx) < HOST_TOL and _max_err(ty, hy) < HOST_TOL


@pytest.mark.parametrize("src,dst", PAIRS)
def test_cutout_pixmaps_device_match_jax(src, dst):
    js, jd = _wcs(src), _wcs(dst, seed=9)
    # output coordinates stay below 512 px, where an f32 ulp is 3e-5 px
    # (DEV_TOL is then 3 ulp of the two independently compiled programs)
    blc = np.array([[40.0, 60.0], [120.0, 90.0], [200.0, 30.0],
                    [-10.0, 380.0]])
    jx, jy = JB.compute_cutout_pixmaps_device(js, jd, blc, (32, 24))
    tx, ty = TB.compute_cutout_pixmaps_device(
        wcs_from_reference(js), wcs_from_reference(jd), blc, (32, 24),
        device="cpu")
    assert tuple(tx.shape) == (4, 32, 24)
    assert _max_err(tx, jx) < DEV_TOL and _max_err(ty, jy) < DEV_TOL
    for i, (x0, y0) in enumerate(blc):
        hx, hy = JB.compute_pixmap(js, jd, (32, 24), blc=(int(y0), int(x0)))
        assert _max_err(tx[i], hx) < HOST_TOL
        assert _max_err(ty[i], hy) < HOST_TOL


@pytest.mark.parametrize("kind", ["tan", "sip", "tables"])
def test_stacked_pixmaps_match_jax(kind):
    """One evaluation for a whole stack equals the JAX package's
    vmapped program, frame and cutout forms."""
    ws = [_wcs(kind, seed=7), _wcs(kind, seed=7).with_shifted_crpix(0.4,
                                                                   -0.3)]
    ref = _wcs("tan")
    blc = np.array([[[100.0, 200.0], [300.0, 250.0]],
                    [[120.0, 180.0], [280.0, 240.0]]], np.float32)
    tws = [wcs_from_reference(w) for w in ws]
    tref = wcs_from_reference(ref)
    jx, jy = JB.compute_cutout_pixmaps_device_stack(ws, ref, blc, (16, 16))
    tx, ty = TB.compute_cutout_pixmaps_device_stack(tws, tref, blc, (16, 16),
                                                    device="cpu")
    assert tuple(tx.shape) == (2, 2, 16, 16)
    assert _max_err(tx, jx) < DEV_TOL and _max_err(ty, jy) < DEV_TOL
    jx, jy = JB.compute_pixmap_device_stack(ws, ref, (64, 96))
    tx, ty = TB.compute_pixmap_device_stack(tws, tref, (64, 96),
                                            device="cpu")
    assert tuple(tx.shape) == (2, 64, 96)
    assert _max_err(tx, jx) < DEV_TOL and _max_err(ty, jy) < DEV_TOL
    # each stacked frame equals its own single-frame evaluation
    for e, w in enumerate(tws):
        sx, sy = TB.compute_pixmap_device(w, tref, (64, 96), device="cpu")
        assert torch.equal(sx, tx[e]) and torch.equal(sy, ty[e])


def test_mixed_stack_falls_back_to_frames():
    """A stack mixing SIP configurations has no stacked pack (the JAX
    package returns None): the port evaluates it frame by frame, and each
    frame equals its own single evaluation."""
    ws = [wcs_from_reference(_wcs("sip")), wcs_from_reference(_wcs("tan"))]
    ref = wcs_from_reference(_wcs("tan"))
    assert JB.compute_pixmap_device_stack(
        [_wcs("sip"), _wcs("tan")], _wcs("tan"), (8, 8)) is None
    blc = np.array([[[3.0, 5.0]], [[-2.0, 7.0]]])
    fx, fy = TB.compute_pixmap_device_stack(ws, ref, (8, 8), device="cpu")
    cx, cy = TB.compute_cutout_pixmaps_device_stack(ws, ref, blc, (8, 8),
                                                    device="cpu")
    assert tuple(fx.shape) == (2, 8, 8) and tuple(cx.shape) == (2, 1, 8, 8)
    for e, w in enumerate(ws):
        sx, sy = TB.compute_pixmap_device(w, ref, (8, 8), device="cpu")
        assert torch.equal(sx, fx[e]) and torch.equal(sy, fy[e])
        sx, sy = TB.compute_cutout_pixmaps_device(w, ref, blc[e], (8, 8),
                                                  device="cpu")
        assert torch.equal(sx, cx[e]) and torch.equal(sy, cy[e])


def test_device_pixmap_threshold_by_device():
    assert TB.device_pixmap_min_pixels("cuda") == 256 * 256
    assert TB.device_pixmap_min_pixels("cpu") == 2048 * 2048
    assert TB.device_pixmap_min_pixels(torch.device("cpu")) == \
        JB.DEVICE_PIXMAP_MIN_PIXELS


def _scene_image(seed=4, shape=(96, 80)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    img = rng.normal(0, 0.05, shape)
    for cx, cy in rng.uniform(8, 72, (6, 2)):
        img += 5.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 5.0)
    return img.astype(np.float32)


@pytest.mark.parametrize("interp,sinscl", [("poly5", 1.0), ("linear", 1.0),
                                           ("sinc", 1.0), ("sinc", 1.5),
                                           ("spline3", 1.0)])
def test_blot_image_matches_jax(interp, sinscl):
    img = _scene_image()
    rng = np.random.default_rng(1)
    px = rng.uniform(-3, 83, (20, 30)).astype(np.float32)
    py = rng.uniform(-3, 99, (20, 30)).astype(np.float32)
    jv, jok = JB.blot_image(img, px, py, interp=interp, expout=2.5,
                            fill=-1.0, sinscl=sinscl)
    tv, tok = TB.blot_image(img, px, py, interp=interp, expout=2.5,
                            fill=-1.0, sinscl=sinscl, device="cpu")
    assert tuple(tv.shape) == (20, 30)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5 * float(np.abs(jv).max()))


@pytest.mark.parametrize("units", [("rate", "rate"), ("rate", "counts"),
                                   ("counts", "rate"), ("counts", "counts")])
def test_blot_cutout_matches_jax(units):
    img = _scene_image()
    src_units, img_units = units
    jsrc_wcs = _wcs("tan", size=96)
    jimg_wcs = jsrc_wcs.with_shifted_crpix(10.3, 7.6)
    jsrc = JCutout(img, jsrc_wcs, exptime=100.0, data_units=src_units)
    jimg = JCutout(np.zeros((40, 36), np.float32), jimg_wcs, blc=(7, 10),
                   exptime=300.0, data_units=img_units)
    tsrc = Cutout(img, wcs_from_reference(jsrc_wcs), exptime=100.0,
                  data_units=src_units)
    timg = Cutout(np.zeros((40, 36), np.float32),
                  wcs_from_reference(jimg_wcs), blc=(7, 10), exptime=300.0,
                  data_units=img_units)
    jo = JB.blot_cutout(jsrc, jimg)
    to = TB.blot_cutout(tsrc, timg, device="cpu")
    assert to.data_units == jo.data_units and to.blc == jo.blc
    np.testing.assert_array_equal(to.mask, np.asarray(jo.mask))
    np.testing.assert_allclose(to.data, np.asarray(jo.data), rtol=0,
                               atol=1e-5 * float(np.abs(jo.data).max()))
    assert float(np.abs(to.data).max()) > 0


def test_blot_image_identity_pixmap_returns_image():
    """blot_image samples where the pixmap says: through a frame's own
    device pixmap it returns the image (poly5 reproduces it at the
    nodes), valid away from the edges."""
    img = _scene_image()
    w = wcs_from_reference(_wcs("tan", size=96))
    px, py = TB.compute_pixmap_device(w, w, img.shape, device="cpu")
    v, ok = TB.blot_image(torch.from_numpy(img), px, py, interp="poly5")
    assert v.device.type == "cpu"
    # f32 coordinates a hair below a node take the footprint one px left
    assert bool(ok[3:-4, 3:-4].all()) and not bool(ok[0].any())
    np.testing.assert_allclose(v[3:-4, 3:-4].numpy(), img[3:-4, 3:-4],
                               atol=1e-4)
