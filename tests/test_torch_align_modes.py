"""Port parity: the device source finder in setup and the host loop, vs
``subpixal_tpu.align_images``.

``device_catalog='device'`` runs the device finder on the drizzled
reference (on the CPU here, as the JAX package's own test forces it), and
setup then takes the primary cutouts from the catalog table alone and the
segmentation plane from the device. ``device_loop=False`` (and
``verbose``) runs the host loop, which reads each iteration's fit back,
records it, polices the sparse live set and then tests ``eps_shift``. Each
goes through both packages on the CPU with the same inputs: the same
iterations, convergence and ``nmatches``, and every iteration's shifts
within ``SHIFT_TOL`` px.
"""

import json

import numpy as np
import pytest
import torch

import subpixal_tpu.align as JA
from subpixal_tpu.catalogs import ImageSourceCatalog as JCatalog
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch import catalogs_device as TCD
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.testing import pairwise_shift_errors

torch.set_num_threads(2)

#: the acceptance bound: every iteration's shifts (px)
SHIFT_TOL = 1e-3


def _assert_same_run(jr, tr):
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    assert len(tr.history) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)


def _catalog_scene():
    """tests/test_align.py · test_device_catalog_align_matches_host."""
    return j_simulate(n_exp=4, shape=(256, 256), n_stars=25, seed=7)


@pytest.fixture(scope="module")
def catalog_runs():
    """Both packages with each finder on the same scene, once a module."""
    exps, planted = _catalog_scene()
    runs = {}
    for mode in ("host", "device"):
        runs["jax", mode] = JA.align_images(exposures=exps, nclip=1,
                                            device_catalog=mode)
        runs["port", mode] = TA.align_images(
            exposures=exposures_from_reference(exps), device="cpu", nclip=1,
            device_catalog=mode)
    return runs, planted


def test_device_catalog_align_matches_jax(catalog_runs):
    runs, planted = catalog_runs
    _assert_same_run(runs["jax", "device"], runs["port", "device"])
    assert pairwise_shift_errors(runs["port", "device"].shifts,
                                 planted) < 5e-3


def test_device_catalog_agrees_with_host_finder(catalog_runs):
    """The reference's own bar between the finders: 3 mpix."""
    runs, _ = catalog_runs
    _assert_same_run(runs["jax", "host"], runs["port", "host"])
    assert np.abs(runs["port", "host"].shifts
                  - runs["port", "device"].shifts).max() < 3e-3


def test_device_catalog_setup_never_fetches_the_mosaic(monkeypatch):
    """Under the device finder setup builds no host mosaic and no host
    cutouts; the segmentation plane stays a tensor."""
    seen = []
    real = TCD.find_sources_device

    def spy(image, **kw):
        seen.append(type(image))
        return real(image, **kw)

    def refuse(*a, **k):
        raise AssertionError("the host path ran under the device finder")

    monkeypatch.setattr(TCD, "find_sources_device", spy)
    monkeypatch.setattr(TA, "create_primary_cutouts", refuse)
    monkeypatch.setattr(Drizzle, "output_sci", property(refuse))
    exps, _ = j_simulate(n_exp=2, shape=(128, 128), n_stars=8, seed=2)
    res = TA.align_images(exposures=exposures_from_reference(exps),
                          device="cpu", device_catalog="device",
                          max_iterations=2)
    assert seen == [torch.Tensor] and res.n_iterations == 2


def test_auto_catalog_on_cpu_takes_the_host_finder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the device finder ran on the CPU under 'auto'")

    monkeypatch.setattr(TCD, "find_sources_device", refuse)
    exps, _ = j_simulate(n_exp=2, shape=(128, 128), n_stars=8, seed=2)
    res = TA.align_images(exposures=exposures_from_reference(exps),
                          device="cpu", max_iterations=2)
    assert res.n_iterations == 2


def test_prim_meta_matches_jax():
    """The table-only primary cutouts, against the JAX package's, on a
    table with small, large, clipped and out-of-frame footprints."""
    from subpixal_tpu.catalogs import Table as JTable
    from subpixal_tpu_torch.catalogs import Table

    rng = np.random.default_rng(3)
    n = 40
    x0 = rng.integers(-30, 250, n)
    y0 = rng.integers(-30, 250, n)
    cols = dict(id=np.arange(1, n + 1), x=x0 + rng.uniform(0, 3, n),
                y=y0 + rng.uniform(0, 3, n), flux=rng.uniform(1, 9, n),
                xmin=x0, xmax=x0 + rng.integers(0, 600, n),
                ymin=y0, ymax=y0 + rng.integers(0, 40, n))
    cols["ymax"][:3] = -1                 # no footprint: a fixed box
    want = JA._prim_meta_from_catalog(JTable(dict(cols)), (256, 256))
    got = TA._prim_meta_from_catalog(Table(dict(cols)), (256, 256))
    assert 0 < len(got) == len(want) < n
    for a, b in zip(want, got):
        assert (b.data.shape, b.src_id, b.src_pos_parent, b.src_weight) == (
            a.data.shape, a.src_id, a.src_pos_parent, a.src_weight)


def _loop_scene():
    """tests/test_align.py · test_device_loop_matches_host_loop's scene
    kind: 2 x 256² with a planted shift."""
    return j_simulate(n_exp=2, shape=(256, 256), n_stars=12, seed=4)[0]


LOOP = dict(fitgeom="shift", max_iterations=6, eps_shift=0.004, usfac=1,
            fit_type="gaussian", min_sources=5)


def test_host_loop_matches_jax_and_the_device_loop():
    exps = _loop_scene()
    jr = JA.align_images(exposures=exps, device_loop=False, **LOOP)
    tr = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", device_loop=False, **LOOP)
    _assert_same_run(jr, tr)
    td = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", device_loop=True, **LOOP)
    assert td.n_iterations == tr.n_iterations and td.converged == tr.converged
    np.testing.assert_allclose(td.shifts, tr.shifts, atol=1e-5)
    for recs_d, recs_h in zip(td.history, tr.history):
        for d, h in zip(recs_d, recs_h):
            assert d.nmatches == h.nmatches
            np.testing.assert_allclose(d.shift, h.shift, atol=1e-5)
            assert h.iter_s > 0


def test_verbose_prints_each_record(capsys):
    """``verbose`` takes the host loop ('auto') and prints E JSON records
    an iteration; asking for the device loop too warns and takes it."""
    exps = exposures_from_reference(_loop_scene())
    kw = dict(LOOP, max_iterations=3, eps_shift=1e-9)
    res = TA.align_images(exposures=exps, device="cpu", verbose=True, **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * res.n_iterations == 6
    recs = [json.loads(s) for s in lines]
    assert [(r["iteration"], r["name"]) for r in recs] == [
        (it, e.name) for it in range(3) for e in exps]
    assert recs[-1]["shift"] == list(res.history[-1][1].shift)
    with pytest.warns(UserWarning, match="host loop"):
        TA.align_images(exposures=exps, device="cpu", verbose=True,
                        device_loop=True, **dict(kw, max_iterations=1))
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def _heal_scene():
    """tests/test_sparse_deposit.py's self-heal scene: a wide frame with
    sources on its left, a 30 px planted error on one of four frames."""
    rng = np.random.default_rng(21)
    shape = (512, 1024)
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(60, 380, 8),
                      rng.uniform(60, shape[0] - 60, 8)], 1)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    exps = []
    for e in range(4):
        dx = rng.uniform(-0.3, 0.3)
        img = rng.normal(0, 0.01, shape).astype(np.float32)
        for sx, sy in stars:
            r2 = (xx - sx - dx) ** 2 + (yy - sy) ** 2
            img += np.where(r2 < 64.0, 20.0 * np.exp(-r2 / (2 * 1.6 ** 2)),
                            0.0).astype(np.float32)
        crpix = np.array([shape[1] / 2 + (30.0 if e == 3 else 0.0),
                          shape[0] / 2])
        exps.append(JExposure(img, JTanWCS(crpix=crpix,
                                           crval=np.array([150.0, 2.0]),
                                           cd=cd), name=f"s{e}"))
    return exps


def test_host_loop_sparse_self_heal_matches_jax():
    """The live set goes stale after the first correction: the host loop
    heals, re-enters and converges as the JAX package's host loop does."""
    clean = JDrizzle([_heal_scene()[0]])
    clean.execute()
    sci = np.asarray(clean.output_sci)
    kw = dict(fitgeom="shift", max_iterations=8, usfac=2,
              fit_type="gaussian", cutout_shape=(96, 96), min_sources=3,
              combine_seg_mask=False, peak_search_box=None,
              sparse_deposit=True, device_loop=False)
    jr = JA.align_images([JCatalog(sci)], JDrizzle(_heal_scene()), **kw)
    tr = TA.align_images([ImageSourceCatalog(sci)],
                         Drizzle(exposures_from_reference(_heal_scene()),
                                 device="cpu"), device="cpu", **kw)
    assert tr.setup_breakdown["sparse_heals"] >= 1
    assert tr.setup_breakdown["sparse_heals"] == \
        jr.setup_breakdown["sparse_heals"]
    assert tr.setup_breakdown["sparse_live_frac"] == \
        jr.setup_breakdown["sparse_live_frac"]
    _assert_same_run(jr, tr)
    assert tr.converged
    rel = tr.shifts[3] - tr.shifts[:3].mean(0)
    assert abs(rel[0] - 30.0) < 0.15, rel
