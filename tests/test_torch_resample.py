"""Port parity: the rest of ``resample`` vs ``subpixal_tpu.resample``.

The same numpy exposures go through the JAX package (on the CPU: its
per-frame XLA deposit, and its stacked one-program execute with the
Pallas deposit in interpret mode) and through the port on
``device="cpu"`` (the plain version of kernel B1). Covered: B1's
per-plane outputs, the stacked and per-frame ``execute`` with the
per-exposure cache, fast add / drop / replace, the context map,
``Drizzle(config=...)``, ``match_sky``, the static mask, ``reject_cr``
(host branches against host branches; the port's tensor branches against
the JAX package's ``jax.Array`` branches) and the NaN-median helper.

Tolerances: B1's per-plane plain version on the JAX package's own pixmaps
agrees with its stacks to ``REL_TOL`` (float32 evaluations of the same
cell formulas); with each package's own float32 device pixmaps (a few
1e-6 px apart) to ``STACK_TOL``. The host stages are numpy in both
packages and agree exactly; the tensor branches' sigma-clipped statistics
sum in another order, so their CR flags are held to the JAX package's own
bar between its branches (planted hits identical, totals within 2).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subpixal_tpu.blot as JB
from subpixal_tpu.blot import compute_pixmap_device_stack as j_pixmap_stack
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.resample import make_static_mask as j_static_mask
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import resample as R
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack
from subpixal_tpu_torch.resample import (Drizzle, Exposure, Resample,
                                         make_static_mask, nanmedian)

torch.set_num_threads(2)

#: per-plane plain version against the JAX stacks on the same pixmaps,
#: relative to the largest value (at least 1)
REL_TOL = 1e-5
#: each package's stacked execute on its own f32 device pixmaps
STACK_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def _weighted_stack(n_exp=3, shape=(96, 96), seed=3):
    """JAX-package exposures of a simulated field with per-exposure
    exptimes and bad-pixel weights."""
    exps, _ = j_simulate(n_exp=n_exp, shape=shape, n_stars=6, seed=seed)
    for k, e in enumerate(exps):
        e.exptime = 50.0 + 25.0 * k
        e.weight = (np.random.default_rng(k).random(shape) > 0.1).astype(
            np.float32)
    return exps


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX package's stacked execute (device pixmaps forced on the
    CPU, Pallas deposit in interpret mode) on ``_weighted_stack``."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "device_pixmap_min_pixels", lambda: 1)
    try:
        jexps = _weighted_stack()
        jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
        jd._ensure_output_grid()
        jd._warm_combine()
        out = jd._execute_stack(jd._shared_tile(), _interpret=True)
        assert out is not None, "the JAX stacked path did not engage"
        px, py = j_pixmap_stack([e.wcs for e in jexps], jd._owcs, (96, 96))
    finally:
        mp.undo()
    return dict(exps=jexps, drizzle=jd, planes=[np.asarray(a) for a in out],
                pixmaps=(np.asarray(px), np.asarray(py)))


@pytest.fixture
def stacked(monkeypatch):
    """Force the port's stacked execute on the CPU."""
    monkeypatch.setattr(R, "device_pixmap_min_pixels", lambda device: 1)


def test_per_plane_plain_matches_jax_stack(jax_stack):
    """B1's per-plane plain version on the JAX package's pixmaps, data,
    weights and ratios, each plane times its exptime, equals the JAX
    stacked execute's per-exposure planes."""
    jexps, jd = jax_stack["exps"], jax_stack["drizzle"]
    sci_s, wht_s, _, _ = jax_stack["planes"]
    px, py = jax_stack["pixmaps"]
    data = np.stack([np.asarray(e.data) for e in jexps])
    wht = np.stack([e.weight for e in jexps])
    ratios = tuple(round(float(e.wcs.pscale / jd._owcs.pscale), 6)
                   for e in jexps)
    s, w = drizzle_deposit_stack(
        *(torch.tensor(a) for a in (data, wht, px, py)),
        tuple(jd._oshape), pscale_ratio=ratios, per_plane=True)
    assert tuple(s.shape) == sci_s.shape == (3,) + tuple(jd._oshape)
    sc = np.array([e.exptime for e in jexps], np.float32)[:, None, None]
    assert _rel(s.numpy() * sc, sci_s) < REL_TOL
    assert _rel(w.numpy() * sc, wht_s) < REL_TOL
    assert float(wht_s.sum()) > 0


@pytest.mark.parametrize("kernel", ["square", "point", "gaussian",
                                    "lanczos3", "tophat"])
def test_per_plane_is_the_stack_of_single_deposits(kernel):
    """Plane e of the per-plane stack is exactly the single-plane deposit
    of plane e, and the planes sum to the summed launch to float
    rounding."""
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit

    rng = np.random.default_rng(4)
    E, H, W = 3, 20, 24
    t = [torch.tensor(rng.uniform(0.5, 2.0, (E, H, W)), dtype=torch.float32)
         for _ in range(2)]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x = torch.tensor(np.stack([xx * r + 2.3 + e for e, r in
                               enumerate((1.0, 0.5, 2.0))]))
    y = torch.tensor(np.stack([yy * r + 1.7 for r in (1.0, 0.5, 2.0)]))
    oshape = (60, 64)
    kw = dict(pixfrac=0.8, pscale_ratio=(1.0, 0.5, 2.0), kernel=kernel)
    s, w = drizzle_deposit_stack(t[0], t[1], x, y, oshape, per_plane=True,
                                 **kw)
    for e, r in enumerate(kw["pscale_ratio"]):
        se, we = drizzle_deposit(t[0][e], t[1][e], x[e], y[e], oshape,
                                 pixfrac=0.8, pscale_ratio=r, kernel=kernel)
        assert torch.equal(s[e], se) and torch.equal(w[e], we)
    ss, sw = drizzle_deposit_stack(t[0], t[1], x, y, oshape, **kw)
    assert _rel(s.sum(0), ss) < REL_TOL and _rel(w.sum(0), sw) < REL_TOL


def test_stacked_execute_matches_jax(jax_stack, stacked):
    """The port's stacked execute (one deposit of the whole stack with
    per-exposure planes) against the JAX package's: planes, sums, the
    per-exposure cache and the kept rate-data stack."""
    jexps = jax_stack["exps"]
    sci_s, wht_s, sci, wht = jax_stack["planes"]
    td = Drizzle(exposures_from_reference(jexps), device="cpu")
    td.execute()
    assert {"wcs_params", "deposit_stack"} <= set(td.last_execute_breakdown)
    assert td.output_shape == tuple(jax_stack["drizzle"].output_shape)
    for e, exp in enumerate(td.exposures):
        ts, tw = td._per_exp[exp.name]
        assert _rel(ts, sci_s[e]) < STACK_TOL
        assert _rel(tw, wht_s[e]) < STACK_TOL
    assert _rel(td._sci_acc, sci) < STACK_TOL
    assert _rel(td._wht_acc, wht) < STACK_TOL
    assert td._data_stack_key == R._exposure_stack_key(td.exposures)
    np.testing.assert_array_equal(
        td._data_stack.numpy(), np.stack([e.data for e in td.exposures]))


def test_stacked_execute_matches_per_frame(stacked):
    """Stacked (f32 device pixmaps) and per-frame (f64 host pixmaps)
    execute of one stack agree up to the pixmaps' f32 rounding, and the
    stacked planes sum to the accumulators."""
    exps = exposures_from_reference(_weighted_stack())
    td = Drizzle([e.copy() for e in exps], device="cpu")
    td.execute()
    assert td._data_stack is not None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "device_pixmap_min_pixels", lambda device: 1 << 30)
        tf = Drizzle([e.copy() for e in exps], device="cpu")
        tf.execute()
    assert tf._data_stack is None and "deposits" in tf.last_execute_breakdown
    assert _rel(td.output_sci, tf.output_sci) < STACK_TOL
    assert _rel(td.output_wht, tf.output_wht) < STACK_TOL
    planes = torch.stack([td._per_exp[e.name][0] for e in td.exposures])
    assert _rel(planes.sum(0), td._sci_acc) < 1e-6


def _jax_scene(n=3, shape=(40, 44), seed=4):
    """Small rotated, dithered JAX-package exposures with weights."""
    rng = np.random.default_rng(seed)
    s = 0.05 / 3600.0
    exps = []
    for e in range(n):
        th = np.deg2rad(rng.uniform(-0.5, 0.5))
        cd = s * np.array([[-np.cos(th), np.sin(th)],
                           [np.sin(th), np.cos(th)]])
        wcs = JTanWCS(crpix=np.array([22.0, 20.0]) + rng.uniform(-4, 4, 2),
                      crval=np.array([150.0, 2.0]), cd=cd)
        data = rng.normal(5.0, 1.0, shape).astype(np.float32)
        weight = (rng.random(shape) > 0.1).astype(np.float32)
        exps.append(JExposure(data, wcs, weight=weight,
                              exptime=100.0 + 10 * e, name=f"x{e}"))
    return exps


@pytest.mark.parametrize("mode", ["per_frame", "stacked"])
def test_fast_add_drop_replace_match_rebuild_and_jax(mode, monkeypatch):
    """fast_drop / fast_add / fast_replace equal a rebuild of the same
    stack, in the port and in the JAX package; duplicate names raise."""
    if mode == "stacked":
        monkeypatch.setattr(R, "device_pixmap_min_pixels", lambda d: 1)
    jexps = _jax_scene()
    texps = exposures_from_reference(jexps)
    moved = texps[2].wcs.replace(crpix=texps[2].wcs.crpix + [0.3, -0.2])
    jmoved = jexps[2].wcs.replace(crpix=jexps[2].wcs.crpix + [0.3, -0.2])
    td = Drizzle(texps, device="cpu")
    td.execute()
    jd = JDrizzle(list(jexps), use_pallas=False)
    jd.execute()
    owcs, oshape = td.output_wcs, td.output_shape
    td.fast_drop_image("x1")
    jd.fast_drop_image("x1")
    td.fast_replace_image(Exposure(texps[2].data, moved, name="x2",
                                   weight=texps[2].weight, exptime=120.0))
    jd.fast_replace_image(JExposure(jexps[2].data, jmoved, name="x2",
                                    weight=jexps[2].weight, exptime=120.0))
    td.fast_add_image(texps[1])
    jd.fast_add_image(jexps[1])
    assert [e.name for e in td.exposures] == ["x0", "x2", "x1"]
    rebuilt = Drizzle([texps[0], Exposure(texps[2].data, moved, name="x2",
                                          weight=texps[2].weight,
                                          exptime=120.0), texps[1]],
                      output_wcs=owcs, output_shape=oshape, device="cpu")
    rebuilt.execute()
    np.testing.assert_allclose(td.output_sci, rebuilt.output_sci, atol=1e-4)
    np.testing.assert_allclose(td.output_wht, rebuilt.output_wht, atol=1e-3)
    np.testing.assert_allclose(td.output_sci, np.asarray(jd.output_sci),
                               rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="already in the stack"):
        td.fast_add_image(Exposure(texps[0].data, texps[0].wcs, name="x1"))
    with pytest.raises(KeyError):
        td.fast_drop_image("nope")
    with pytest.raises(ValueError, match="duplicate"):
        Drizzle([texps[0], texps[0]], device="cpu")


@pytest.mark.parametrize("n", [3, 33])
def test_output_ctx_matches_jax(n):
    """The context map equals the JAX package's: one int32 plane up to 32
    exposures, then 32 exposures a plane."""
    jexps = _jax_scene(n=n, shape=(16, 18), seed=n)
    jd = JDrizzle(jexps, use_pallas=False)
    td = Drizzle(exposures_from_reference(jexps), device="cpu")
    jc, tc = np.asarray(jd.output_ctx), td.output_ctx
    assert tc.dtype == np.int32 and tc.shape == jc.shape
    assert tc.shape == ((2,) if n > 32 else ()) + tuple(td.output_shape)
    np.testing.assert_array_equal(tc, jc)
    assert td.texptime == jd.texptime


@pytest.mark.parametrize("config", [
    {"final_pixfrac": 0.8, "final_kernel": "gaussian",
     "final_wht_type": "IVM", "final_fillval": -1.0},
    {"final_fillval": "INDEF", "final_wht_type": "ERR", "pixfrac": 0.6},
    {"final_pixfrac": 0.9, "skymethod": "match", "driz_cr": True,
     "driz_cr_snr": "3.5 3.0", "combine_type": "median", "final_rot": 0.0,
     "in_memory": True},
    {"final_pixfrc": 0.9},
    {"final_bogus": 1, "driz_sep_kernel": "turbo"},
])
def test_drizzle_config_matches_jax(config):
    """Drizzle(config=...) maps, warns and raises as the JAX package."""
    def build(cls, **kw):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                d = cls(config=config, **kw)
            except ValueError as err:
                return None, str(err), [str(w.message) for w in rec]
        return d, None, [str(w.message) for w in rec]

    jd, jerr, jwarn = build(JDrizzle)
    td, terr, twarn = build(Drizzle, device="cpu")
    assert terr == jerr and twarn == jwarn
    if jd is not None:
        for k in ("pixfrac", "kernel", "fillval", "pscale", "pscale_ratio",
                  "wht_type"):
            assert getattr(td, k) == getattr(jd, k), k


def _sky_scene(device_data=None):
    """JAX-package exposures with per-exposure sky offsets, two counts
    exposures of other exptimes, shared dead pixels and planted CR hits
    (the scene of tests/test_drizzle.py, mixed units)."""
    rng = np.random.default_rng(3)
    s = 0.05 / 3600.0
    stars = [(15.0, 18.0), (40.0, 22.0), (28.0, 44.0)]
    yy, xx = np.mgrid[0:56, 0:60].astype(np.float64)
    exps = []
    for e, (off, t, units) in enumerate([(0.7, 1.0, "rate"),
                                         (-0.3, 40.0, "counts"),
                                         (1.5, 1.0, "rate"),
                                         (0.1, 25.0, "counts")]):
        dx, dy = rng.uniform(-2, 2, 2)
        wcs = JTanWCS(crpix=np.array([30.0 + dx, 28.0 + dy]),
                      crval=np.array([150.0, 2.0]),
                      cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]))
        img = rng.normal(0, 0.02, (56, 60))
        for x0, y0 in stars:
            img += 30.0 * np.exp(-((xx - x0 - dx) ** 2 + (yy - y0 - dy) ** 2)
                                 / (2 * 1.8 ** 2))
        img = img + off
        for y, x in [(7, 9), (33, 41)]:
            img[y, x] = -5.0
        scale = t if units == "counts" else 1.0
        exps.append(JExposure((img * scale).astype(np.float32), wcs,
                              exptime=t, data_units=units, name=f"d{e}"))
    hits = [(20, 30), (40, 15), (11, 44)]
    for k, (y, x) in enumerate(hits):
        e = exps[k % len(exps)]
        e.data[y, x] += 500.0 * (e.exptime if e.data_units == "counts"
                                 else 1.0)
    return exps, hits


@pytest.mark.parametrize("skymethod", ["match", "localmin"])
def test_match_sky_matches_jax(skymethod):
    """Host branches: equal skies (rate units) and equal data after the
    subtraction, with counts exposures of other exptimes in the stack."""
    jexps, _ = _sky_scene()
    texps = exposures_from_reference(jexps)
    jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
    td = Drizzle(texps, device="cpu")
    np.testing.assert_array_equal(td.match_sky(skymethod=skymethod),
                                  jd.match_sky(skymethod=skymethod))
    for a, b in zip(jd.exposures, td.exposures):
        np.testing.assert_array_equal(b.data, np.asarray(a.data))
    with pytest.raises(ValueError, match="skymethod"):
        td.match_sky(skymethod="globalmin")


def test_static_mask_matches_jax():
    jexps, _ = _sky_scene()
    texps = exposures_from_reference(jexps)
    want = j_static_mask(jexps)
    got = make_static_mask(texps)
    np.testing.assert_array_equal(got, want)
    assert got[7, 9] and got[33, 41] and got.sum() == 2
    td = Drizzle(texps, device="cpu")
    jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
    np.testing.assert_array_equal(td.apply_static_mask(),
                                  jd.apply_static_mask())
    for a, b in zip(jd.exposures, td.exposures):
        np.testing.assert_array_equal(b.weight, a.weight)


def test_reject_cr_host_matches_jax():
    """Host branch: the same CR masks, the same re-drizzled product, and
    the planted hits flagged."""
    jexps, hits = _sky_scene()
    jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
    td = Drizzle(exposures_from_reference(jexps), device="cpu")
    for d in (jd, td):
        d.match_sky()
        d.apply_static_mask()
        d.execute()
    jm = jd.reject_cr(snr=5.0)
    tm = td.reject_cr(snr=5.0)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b, a)
    for k, (y, x) in enumerate(hits):
        assert tm[k % 4][y, x]
    np.testing.assert_allclose(td.output_sci, np.asarray(jd.output_sci),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match=">= 3"):
        Drizzle(td.exposures[:2], device="cpu").reject_cr()


def test_tensor_branches_match_jax_array_branches():
    """match_sky, the static mask and reject_cr on tensor exposures
    against the JAX package's jax.Array exposures (and the port's host
    branch): skies within 1e-4, equal masks, planted hits identical and
    CR totals within 2; tensors are never written in place."""
    jexps, hits = _sky_scene()
    texps = exposures_from_reference(jexps)
    host = [e.copy() for e in texps]
    for e in jexps:
        e.data = jnp.asarray(e.data)
    for e in texps:
        e.data = torch.tensor(e.data)
    orig = [e.data.clone() for e in texps]
    jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
    td = Drizzle([e.copy() for e in texps], device="cpu")
    hd = Drizzle(host, device="cpu")
    sk = td.match_sky()
    np.testing.assert_allclose(sk, jd.match_sky(), atol=1e-4)
    np.testing.assert_allclose(sk, hd.match_sky(), atol=1e-4)
    assert isinstance(td.exposures[0].data, torch.Tensor)
    m = td.apply_static_mask()
    np.testing.assert_array_equal(m, jd.apply_static_mask())
    np.testing.assert_array_equal(m, hd.apply_static_mask())
    assert isinstance(td.exposures[0].weight, torch.Tensor)
    for d in (jd, td, hd):
        d.execute()
    crs = [d.reject_cr(snr=5.0) for d in (jd, td, hd)]
    assert isinstance(td.exposures[0].weight, torch.Tensor)
    for k, (y, x) in enumerate(hits):
        assert all(c[k % 4][y, x] for c in crs)
    tot = [sum(int(np.asarray(c).sum()) for c in cr) for cr in crs]
    assert abs(tot[1] - tot[0]) <= 2 and abs(tot[1] - tot[2]) <= 2
    for e, o in zip(texps, orig):  # the caller's tensors are untouched
        assert torch.equal(e.data, o) and e.weight is None


@pytest.mark.parametrize("shape,axis", [((7,), None), ((8,), None),
                                        ((5, 6), 0), ((6, 5), 0),
                                        ((4, 9, 3), 1), ((8, 3, 4), 0)])
def test_nanmedian_matches_numpy(shape, axis):
    """Averages the middle pair of an even count, skips NaNs, NaN for an
    all-NaN slice: exactly np.nanmedian."""
    rng = np.random.default_rng(int(np.prod(shape)))
    x = rng.normal(3.0, 2.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = np.nan
    if axis is not None:
        idx = [slice(None)] * len(shape)
        idx[1 if axis == 0 else 0] = 0
        x[tuple(idx)] = np.nan  # an all-NaN slice
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.nanmedian(x, axis=axis)
    got = nanmedian(torch.tensor(x), dim=axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_exposure_copy_resample_and_texptime():
    rng = np.random.default_rng(0)
    w = JTanWCS(crpix=np.array([4.0, 4.0]), crval=np.array([10.0, 0.0]),
                cd=(0.05 / 3600.0) * np.eye(2))
    (te,) = exposures_from_reference([JExposure(
        rng.normal(size=(8, 9)), w, weight=np.ones((8, 9)), exptime=3.0,
        name="a")])
    c = te.copy()
    assert c.data is not te.data and c.weight is not te.weight
    np.testing.assert_array_equal(c.data, te.data)
    np.testing.assert_array_equal(c.wcs.crpix, te.wcs.crpix)
    assert (c.name, c.exptime) == ("a", 3.0)
    t = Exposure(torch.ones(8, 9, dtype=torch.float64), te.wcs, name="t")
    assert t.data.dtype == torch.float32 and t.copy().data is t.data
    assert Drizzle([te, t], device="cpu").texptime == 4.0
    for attr in ("output_sci", "output_wht", "output_wcs"):
        with pytest.raises(NotImplementedError):
            getattr(Resample(), attr)
    with pytest.raises(NotImplementedError):
        Resample().execute()
