"""Port parity: the align path with device pixmaps, the sparse deposit and
the windowed measurement, vs ``subpixal_tpu.align_images``.

The JAX package's own align configuration (``bench.py``'s align smoke:
shift fit, ``usfac`` 8, Gaussian peak) runs through both packages on the
CPU with ``cutout_pixmaps='device'`` and ``sparse_deposit=True``: the JAX
package with its XLA deposit on compacted blocks, the port with the plain
versions of kernels B1-B3. They must find the same sources, run the same
number of iterations, agree on convergence and on every iteration's
shifts within ``SHIFT_TOL`` px. The live-set helpers are held to the JAX
package's exactly, and the self-heal must fire as often as there.
"""

import warnings

import jax.numpy as jnp
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
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import (exposures_from_reference,
                                        wcs_from_reference)
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.testing import pairwise_shift_errors

torch.set_num_threads(2)

#: the acceptance bound: every iteration's shifts (px)
SHIFT_TOL = 1e-3

#: the JAX package's align configuration (bench.py's align smoke)
NEW_PATH = dict(fitgeom="shift", usfac=8, fit_type="gaussian",
                cutout_pixmaps="device", sparse_deposit=True)


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


def _wide_scene(E=2, shape=(512, 1024), ns=8, seed=13):
    """tests/test_sparse_deposit.py's scene: a wide frame with sources in
    its left part only, so the live set leaves most blocks out."""
    rng = np.random.default_rng(seed)
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(60, 380, ns),
                      rng.uniform(60, shape[0] - 60, ns)], 1)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    exps = []
    for e in range(E):
        dx = rng.uniform(-0.3, 0.3)
        img = rng.normal(0, 0.01, shape).astype(np.float32)
        for sx, sy in stars:
            r2 = (xx - sx - dx) ** 2 + (yy - sy) ** 2
            img += np.where(r2 < 64.0,
                            20.0 * np.exp(-r2 / (2 * 1.6 ** 2)),
                            0.0).astype(np.float32)
        exps.append(JExposure(
            img, JTanWCS(crpix=np.array([shape[1] / 2, shape[0] / 2]),
                         crval=np.array([150.0, 2.0]), cd=cd),
            name=f"s{e}"))
    return exps


def test_live_set_helpers_match_jax():
    exps = _wide_scene(E=3, seed=5)
    twcs = [e.wcs for e in exposures_from_reference(exps)]
    ref = JDrizzle(exps).output_wcs
    tref = wcs_from_reference(ref)
    shape = exps[0].data.shape
    jbb = JA._block_bboxes_wcs([e.wcs for e in exps], ref, shape)
    tbb = TA._block_bboxes_wcs(twcs, tref, shape)
    for a, b in zip(jbb, tbb):
        np.testing.assert_array_equal(b, a)
    rng = np.random.default_rng(0)
    y0 = rng.uniform(40, 400, (3, 6))
    x0 = rng.uniform(40, 300, (3, 6))
    cut_bb = (y0, y0 + 33.0, x0, x0 + 33.0)
    out_shape = (560, 1080)
    kw = dict(blot_margin=16.0, corr_margin=13.6)
    ji, jv = JA._live_block_indices(jbb, cut_bb, out_shape, **kw)
    ti, tv = TA._live_block_indices(tbb, cut_bb, out_shape, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert ti.shape[1] < 0.85 * jbb[0].shape[1]  # compaction would pay
    assert not tv.all()  # some padded slots, weight-0'd below

    E, H, W = 3, 50, 300  # ragged: neither axis is a multiple of a block
    planes = [rng.normal(size=(E, H, W)).astype(np.float32)
              for _ in range(4)]
    nb = -(-H // 16) * -(-W // 128)
    idx = rng.integers(0, nb, (E, 5))
    valid = rng.random((E, 5)) > 0.3
    jout = JA._compact_blocks(*(jnp.asarray(p) for p in planes),
                              jnp.asarray(idx), jnp.asarray(valid))
    tout = TA._compact_blocks(*(torch.from_numpy(p) for p in planes),
                              torch.from_numpy(idx), torch.from_numpy(valid))
    for a, b in zip(jout, tout):
        assert tuple(b.shape) == (E, 5 * 16, 128)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_new_path_matches_jax():
    """The slice as a whole on a 3 x 256², 12-star scene."""
    exps, planted = j_simulate(n_exp=3, shape=(256, 256), n_stars=12,
                               seed=5)
    jr = JA.align_images(exposures=exps, max_iterations=6, **NEW_PATH)
    tr = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", max_iterations=6, **NEW_PATH)
    _assert_same_run(jr, tr)
    assert tr.history[0][0].nmatches == 12
    assert pairwise_shift_errors(tr.shifts, planted) < 0.005
    assert "cutout_pixmaps" in tr.setup_breakdown
    # 32 blocks per 256² frame: the live set rounds up to all of them,
    # so compaction does not pay, in both packages
    assert tr.setup_breakdown["sparse_live_set"] == 1.0
    assert "sparse_live_frac" not in tr.setup_breakdown
    assert "sparse_live_frac" not in jr.setup_breakdown


def test_new_path_sparse_compaction_matches_jax():
    """A scene where the live set leaves most blocks out: both packages
    compact to the same fraction and run the same iterations."""
    exps = _wide_scene()
    kw = dict(NEW_PATH, max_iterations=4, cutout_shape=(64, 64),
              min_sources=3)
    jr = JA.align_images(exposures=exps, **kw)
    tr = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", **kw)
    frac = tr.setup_breakdown["sparse_live_frac"]
    assert frac == jr.setup_breakdown["sparse_live_frac"] < 0.85
    assert tr.setup_breakdown["sparse_live_set"] == frac
    _assert_same_run(jr, tr)
    # and the compacted deposit agrees with the dense one
    dense = TA.align_images(exposures=exposures_from_reference(exps),
                            device="cpu", **dict(kw, sparse_deposit=False))
    np.testing.assert_allclose(tr.shifts, dense.shifts, atol=SHIFT_TOL)


def _heal_scene():
    """tests/test_sparse_deposit.py's self-heal scene: a 30 px planted
    error on one of four frames, far beyond the live-set margin."""
    exps = _wide_scene(E=4, seed=21)
    e3 = exps[3]
    bad = e3.wcs.replace(crpix=e3.wcs.crpix + np.array([30.0, 0.0]))
    return exps[:3] + [JExposure(e3.data.copy(), bad, name=e3.name)]


@pytest.fixture(scope="module")
def heal_runs():
    clean = JDrizzle([_heal_scene()[0]])
    clean.execute()
    sci = np.asarray(clean.output_sci)
    kw = dict(fitgeom="shift", max_iterations=8, usfac=2,
              fit_type="gaussian", cutout_shape=(96, 96), min_sources=3,
              combine_seg_mask=False, peak_search_box=None,
              sparse_deposit=True)
    jr = JA.align_images([JCatalog(sci)], JDrizzle(_heal_scene()), **kw)
    tr = TA.align_images([ImageSourceCatalog(sci)],
                         Drizzle(exposures_from_reference(_heal_scene()),
                                 device="cpu"), device="cpu", **kw)
    return jr, tr


def test_sparse_self_heal_matches_jax(heal_runs):
    """The live set goes stale after the first correction and self-heals
    as in the JAX package: same heal count and live fraction, same run."""
    jr, tr = heal_runs
    assert tr.setup_breakdown.get("sparse_heals", 0) >= 1
    assert tr.setup_breakdown["sparse_heals"] == \
        jr.setup_breakdown["sparse_heals"]
    assert tr.setup_breakdown["sparse_live_frac"] == \
        jr.setup_breakdown["sparse_live_frac"]
    _assert_same_run(jr, tr)


def test_sparse_self_heal_recovers_planted_error(heal_runs):
    _, tr = heal_runs
    assert tr.converged
    rel = tr.shifts[3] - tr.shifts[:3].mean(0)
    assert abs(rel[0] - 30.0) < 0.15, rel


def test_sparse_breach_after_two_heals_warns(monkeypatch):
    """A correction that keeps outgrowing every healed margin heals twice,
    then warns (the step's max_corr is inflated to force it)."""
    real = TA._step
    calls = [0]

    def step(*a, **k):
        newM, newt, info = real(*a, **k)
        calls[0] += 1
        return newM, newt, dict(
            info, max_corr=torch.tensor(99.0 * 10.0 ** (calls[0] - 1)))

    monkeypatch.setattr(TA, "_step", step)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = TA.align_images(
            exposures=exposures_from_reference(_wide_scene()), device="cpu",
            fitgeom="shift", max_iterations=2, usfac=2, fit_type="gaussian",
            cutout_shape=(64, 64), min_sources=3, sparse_deposit=True)
    assert res.setup_breakdown["sparse_heals"] == 2
    assert res.n_iterations >= 3  # the loop re-entered after each heal
    assert any("sparse-deposit live-set margin" in str(w.message)
               for w in rec)
