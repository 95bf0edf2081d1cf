"""Port parity: the align loop at 48² cutouts vs ``subpixal_tpu.align_images``.

Broader stars (sigma 3.0 px) give segmentation footprints that make both
packages' auto-sizing pick 48² cutouts, the shape the CUDA port measures
with its mixed-radix B3 kernel (on the CPU the port runs the plain
versions). Both packages run the same 3 x 256², 12-star scene; they must
pick the same cutout shape with no oversized bucket, find the same
sources and agree on every iteration's shifts within ``SHIFT_TOL`` px.
"""

import numpy as np
import pytest
import torch

import subpixal_tpu.align as JA
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.testing import pairwise_shift_errors

torch.set_num_threads(2)

#: the acceptance bound: every iteration's shifts (px)
SHIFT_TOL = 1e-3

CONFIGS = {
    # the JAX package's align configuration (bench.py's align smoke)
    "new_path": dict(fitgeom="shift", usfac=8, fit_type="gaussian",
                     cutout_pixmaps="device", sparse_deposit=True),
    # the AlignConfig defaults (NCC, general fit, quadratic peak, usfac 1)
    "defaults": dict(),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_48_cutouts_match_jax(config, monkeypatch):
    exps, planted = j_simulate(n_exp=3, shape=(256, 256), n_stars=12,
                               seed=6, sigma=3.0)
    shapes = {"jax": [], "port": []}
    j_build, t_step = JA._build_step_cached, TA._step

    def j_spy(cfg, out_shape, cut_shape, *a):
        shapes["jax"].append((tuple(cut_shape), a[-1]))
        return j_build(cfg, out_shape, cut_shape, *a)

    def t_spy(cfg, out_shape, cut_shape, dri_ratios, big_shape, *a, **k):
        shapes["port"].append((tuple(cut_shape), big_shape))
        return t_step(cfg, out_shape, cut_shape, dri_ratios, big_shape, *a,
                      **k)

    monkeypatch.setattr(JA, "_build_step_cached", j_spy)
    monkeypatch.setattr(TA, "_step", t_spy)
    kw = dict(CONFIGS[config], max_iterations=4, eps_shift=1e-7)
    jr = JA.align_images(exposures=exps, **kw)
    tr = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", **kw)
    # 48² cutouts and no oversized bucket, in both packages
    assert set(shapes["jax"]) == {((48, 48), None)}
    assert set(shapes["port"]) == {((48, 48), None)}
    assert tr.n_iterations == jr.n_iterations == 4
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)
    assert tr.history[0][0].nmatches >= 10
    assert pairwise_shift_errors(tr.shifts, planted) < 0.005
