"""Port parity: the device loop (``device_loop=True``, the default without
``verbose``) against ``subpixal_tpu.align_images(device_loop=True)``.

The JAX package runs the fixed point as one ``lax.while_loop`` and reads
the host once an entry; the port (``align._fixed_point``) runs the same
masked step (the iteration that converges keeps its result, the steps
after it change nothing), replaying a CUDA graph of the step on a card
and reading the host every ``READ_EVERY`` iterations and at the end (so
too under a mesh, on gloo, and there on two spawned CPU ranks), and on
one CPU calling the step and reading every iteration. Each case goes
through both packages on the CPU with the same inputs: the same
iterations, convergence, history length, records and ``nmatches``, and
every iteration's shifts within ``SHIFT_TOL`` px; the port's own step
and read counts follow the cadence.
"""

import numpy as np
import pytest
import torch

import subpixal_tpu.align as JA
from subpixal_tpu.catalogs import ImageSourceCatalog as JCatalog
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.ops import correlate, interp, peaks
from subpixal_tpu_torch.resample import Drizzle
from test_torch_align import _planted_scene
from test_torch_align_modes import LOOP, _heal_scene, _loop_scene
from test_torch_align_otf import OTF, planted_scene

torch.set_num_threads(2)

#: the bound on every iteration's shifts (px): two float32 spacings at the
#: 128-256 px reference coordinates at which the fits' translations are
#: taken. Both packages compute in float32 and round those translations
#: to neighbouring values (one spacing, 2**-16 = 1.53e-5 px, apart), so a
#: bar of 1e-5 px lies below what float32 resolves there
SHIFT_TOL = 2.0 ** -15


def _assert_same_run(jr, tr):
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    assert len(tr.history) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr.history):
        assert len(trecs) == len(jrecs)
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
            assert b.iter_s > 0
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)


def _cadence(res, T):
    """The port's masked steps and host reads on the CPU for one entry of
    up to T iterations that took ``res.n_iterations``: one step and one
    read an iteration, no step past the one that converged."""
    n = res.n_iterations
    assert res.converged or n == T
    assert res.setup_breakdown["loop_steps"] == n
    assert res.setup_breakdown["loop_host_reads"] == n
    # no graph on the CPU: nothing captured, nothing replayed
    assert "loop_graphs" not in res.setup_breakdown


def _both(exps, **kw):
    jr = JA.align_images(exposures=exps, device_loop=True, **kw)
    tr = TA.align_images(exposures=exposures_from_reference(exps),
                         device="cpu", device_loop=True, **kw)
    return jr, tr


@pytest.mark.parametrize("case", ["converges", "short_last_chunk",
                                  "no_convergence", "no_iteration"])
def test_device_loop_matches_jax(case):
    """Convergence at an iteration that is not a multiple of 4;
    ``max_iterations=6`` without convergence (on a card: reads at 4 and
    6, the last chunk short); ``max_iterations=3`` without convergence;
    and ``max_iterations=0``: no iteration, the initial state. There the
    JAX package's device loop fails while tracing (it indexes its empty
    history), so the port is held to the JAX package's host loop, which
    runs no iteration."""
    # eps_shift 0 never passes: max_shift is a root mean square
    kw = {"converges": dict(LOOP, max_iterations=10),
          "short_last_chunk": dict(LOOP, max_iterations=6, eps_shift=0.0),
          "no_convergence": dict(LOOP, max_iterations=3, eps_shift=0.0),
          "no_iteration": dict(LOOP, max_iterations=0)}[case]
    if case == "no_iteration":
        exps = _loop_scene()
        jr = JA.align_images(exposures=exps, device_loop=False, **kw)
        tr = TA.align_images(exposures=exposures_from_reference(exps),
                             device="cpu", device_loop=True, **kw)
    else:
        jr, tr = _both(_loop_scene(), **kw)
    _assert_same_run(jr, tr)
    if case == "no_iteration":
        assert (tr.n_iterations, tr.converged, tr.history) == (0, False, [])
        np.testing.assert_array_equal(tr.shifts, 0.0)
        np.testing.assert_array_equal(tr.matrices, np.eye(2)[None].repeat(
            len(tr.exposures), 0))
        assert "loop_steps" not in tr.setup_breakdown
        return
    _cadence(tr, kw["max_iterations"])
    if case == "converges":
        assert tr.converged and tr.n_iterations % TA.READ_EVERY != 0
    else:
        assert not tr.converged
        assert tr.n_iterations == kw["max_iterations"]


def test_device_loop_otf_matches_jax():
    """``wcsupdate='otf'``: the per-exposure step in the masked loop."""
    err = np.array([(0.0, 0.0), (1.1, -0.6), (-0.8, 0.4)])
    jr, tr = _both(planted_scene(err), usfac=1, **OTF)
    _assert_same_run(jr, tr)
    _cadence(tr, OTF["max_iterations"])
    assert tr.converged


def test_device_loop_bucket_matches_jax():
    """The oversized-footprint bucket: its re-measured rows in the masked
    loop."""
    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    kw = dict(fitgeom="shift", max_iterations=8, eps_shift=0.004,
              fit_type="gaussian", min_sources=5, max_cut_size=48,
              use_weights=False)
    jr, tr = _both(_planted_scene(2, err), **kw)
    assert "big_bucket_stage" in tr.setup_breakdown
    _assert_same_run(jr, tr)
    _cadence(tr, kw["max_iterations"])


def test_device_loop_sparse_self_heal_matches_jax():
    """The live set goes stale after the first correction: the device
    loop's entry ends, heals, and re-enters from the current state with a
    fresh loop, as the JAX package's ``while True`` does."""
    clean = JDrizzle([_heal_scene()[0]])
    clean.execute()
    sci = np.asarray(clean.output_sci)
    kw = dict(fitgeom="shift", max_iterations=8, usfac=2,
              fit_type="gaussian", cutout_shape=(96, 96), min_sources=3,
              combine_seg_mask=False, peak_search_box=None,
              sparse_deposit=True, device_loop=True)
    jr = JA.align_images([JCatalog(sci)], JDrizzle(_heal_scene()), **kw)
    tr = TA.align_images([ImageSourceCatalog(sci)],
                         Drizzle(exposures_from_reference(_heal_scene()),
                                 device="cpu"), device="cpu", **kw)
    heals = tr.setup_breakdown["sparse_heals"]
    assert heals >= 1 and heals == jr.setup_breakdown["sparse_heals"]
    assert tr.setup_breakdown["sparse_live_frac"] == \
        jr.setup_breakdown["sparse_live_frac"]
    _assert_same_run(jr, tr)
    assert tr.converged
    # one step and one read an iteration over all the entries
    assert tr.setup_breakdown["loop_host_reads"] == tr.n_iterations
    assert tr.setup_breakdown["loop_steps"] == tr.n_iterations


def test_masked_step_keeps_the_converged_state():
    """``_fixed_point`` on a scripted step, at a card's read cadence (every
    ``READ_EVERY`` iterations): the iteration whose ``max_shift`` passes
    keeps its own result, the steps after it (to the next read) change
    neither the state nor the history; at the CPU's (every iteration) no
    step runs past it; and ``max_iterations`` 0 runs none."""
    calls = []

    def step(b, Ms, ts):
        assert b is None
        calls.append(len(calls))
        k = float(len(calls))
        info = dict(G_t=ts + k, max_shift=torch.tensor(1.0 / k))
        return Ms * 2.0, ts + k, info

    def run(T, eps, **kw):
        calls.clear()
        bd = {}
        out = TA._fixed_point(step, None, torch.ones(1, 2, 2),
                              torch.zeros(1, 2),
                              dict(G_t=((1, 2), torch.float32)), T, eps,
                              bd, **kw)
        return out, bd

    every = dict(every=TA.READ_EVERY)
    (Ms, ts, n, done, hist, iter_s), bd = run(10, 0.3, **every)
    # max_shift 1, 1/2, 1/3, 1/4: the fourth iteration passes eps 0.3
    assert (n, done, len(calls)) == (4, True, 4)
    assert float(Ms[0, 0, 0]) == 16.0 and float(ts[0, 0]) == 10.0
    np.testing.assert_array_equal(hist["G_t"][:, 0, 0], [1, 3, 6, 10])
    assert bd == dict(loop_steps=4, loop_host_reads=1)
    (Ms, ts, n, done, hist, _), bd = run(10, 0.45, **every)
    # converged at 3; the fourth step runs (the read comes at 4) and
    # changes nothing
    assert (n, done, len(calls)) == (3, True, 4)
    assert float(Ms[0, 0, 0]) == 8.0 and float(ts[0, 0]) == 6.0
    assert hist["G_t"].shape == (3, 1, 2)
    assert bd == dict(loop_steps=4, loop_host_reads=1)
    # reads at 4 and at the end (6): the last chunk is short
    (*_, n, done, hist, _), bd = run(6, 0.0, **every)
    assert (n, done, len(calls)) == (6, False, 6)
    assert bd == dict(loop_steps=6, loop_host_reads=2)
    # the CPU's cadence: a read an iteration, nothing past convergence
    (*_, n, done, _, _), bd = run(10, 0.45)
    assert (n, done, len(calls)) == (3, True, 3)
    assert bd == dict(loop_steps=3, loop_host_reads=3)
    (Ms, ts, n, done, hist, iter_s), bd = run(0, 0.45)
    assert (n, done, len(calls), bd, iter_s) == (0, False, 0, {}, 0.0)
    assert float(Ms[0, 0, 0]) == 1.0 and hist["G_t"].shape == (0, 1, 2)


@pytest.mark.parametrize("what", ["hermitian", "power", "bspline"])
def test_capture_safe_constants_are_cached(what):
    """The step's constant tables are built once per (shape, dtype,
    device) and reused: two calls return one tensor, equal to the table
    a fresh build gives."""
    dev = torch.device("cpu")
    if what == "hermitian":
        a, b = (correlate._hermitian_weights(10, dev) for _ in range(2))
        want = torch.tensor([1.0, 2.0, 2.0, 2.0, 2.0, 1.0])
    elif what == "power":
        a, b = (peaks._power_tables_on(9, 5, torch.float32, dev)
                for _ in range(2))
        want = torch.as_tensor(peaks._power_tables(9, 5))
    else:
        a, b = (interp._bspline3_powers(7, torch.float32, dev)
                for _ in range(2))
        want = torch.tensor([interp._BSPLINE3_POLE ** k for k in range(7)])
    assert a is b
    assert torch.equal(a, want)


def test_fft_frequencies_built_on_the_device():
    """``_us_dft_kernel``'s signed frequencies, now built with device ops,
    are numpy's ``fftfreq`` times the period, for even and odd periods
    and every prefix length the measurement asks for."""
    for period in (7, 8, 32, 33):
        for nfreq in (period // 2 + 1, period):
            re, im = correlate._us_dft_kernel(
                torch.zeros(1, dtype=torch.int32), torch.ones(1), nfreq,
                period)
            f = np.rint(np.fft.fftfreq(period) * period)[:nfreq]
            ang = 2.0 * np.pi * f / period
            np.testing.assert_allclose(re[0, 0].numpy(), np.cos(ang),
                                       atol=1e-5)
            np.testing.assert_allclose(im[0, 0].numpy(), np.sin(ang),
                                       atol=1e-5)


#: two gloo ranks on the CPU: ``_fixed_point`` under their mesh on a
#: scripted step whose update is an ``all_reduce`` (each rank adds its
#: rank + 1; the sum is the same on both), T = 6, ``max_shift`` 1/k at
#: iteration k, converging at 3 under eps 0.45, at the mesh's cadence
#: (every READ_EVERY) and at one read an iteration; then the ranks'
#: agreement on a cached graph with each rank in turn lacking it, and
#: with neither
_MESH_LOOP = r"""
import json, sys
import torch
import torch.distributed as dist
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch.parallel import init_distributed, make_mesh

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh(world, device="cpu")
calls = []


def step(b, Ms, ts):
    calls.append(1)
    part = torch.full((1,), float(rank + 1))
    dist.all_reduce(part, group=mesh.group())
    newt = ts + part / (world * (world + 1) / 2)
    return Ms * 2.0, newt, dict(G_t=newt, max_shift=1.0 / newt[0, 0])


out = {}
for name, every in (("mesh", None), ("every", 1)):
    calls.clear()
    bd = {}
    Ms, ts, n, done, hist, _ = TA._fixed_point(
        step, None, torch.ones(1, 2, 2), torch.zeros(1, 2),
        dict(G_t=((1, 2), torch.float32)), 6, 0.45, bd, every=every,
        mesh=mesh)
    out[name] = dict(Ms=Ms.tolist(), ts=ts.tolist(), n=n, done=done,
                     G_t=hist["G_t"].tolist(), calls=len(calls), bd=bd)
out["agree"] = {str(lacks): TA._all_ranks_hold(rank != lacks, mesh, "cpu")
                for lacks in (-1, 0, 1)}
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def mesh_loop():
    """Each of two gloo ranks' record of ``_MESH_LOOP``."""
    import json

    from subpixal_tpu_torch.testing import SpawnedRanks

    outs = SpawnedRanks(_MESH_LOOP, 2).wait(timeout=120)
    return [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]


def test_mesh_loop_reads_every_fourth_iteration_on_gloo_ranks(mesh_loop):
    """Under a mesh ``_fixed_point`` reads every ``READ_EVERY`` iterations
    and at the end, on gloo too: the records equal those of one read an
    iteration, the fourth (masked) step past convergence changes nothing,
    and every rank runs as many steps, so the collectives stay in step."""
    for r in mesh_loop:
        fast, slow = r["mesh"], r["every"]
        assert (fast["n"], fast["done"]) == (slow["n"], slow["done"]) \
            == (3, True)
        assert (fast["G_t"], fast["Ms"], fast["ts"]) == (
            slow["G_t"], slow["Ms"], slow["ts"])
        assert fast["G_t"] == [[[k, k]] for k in (1.0, 2.0, 3.0)]
        assert fast["bd"] == dict(loop_steps=4, loop_host_reads=1)
        assert slow["bd"] == dict(loop_steps=3, loop_host_reads=3)
        assert (fast["calls"], slow["calls"]) == (4, 3)
    assert mesh_loop[0]["mesh"] == mesh_loop[1]["mesh"]


@pytest.mark.parametrize("lacks", [-1, 0, 1])
def test_one_rank_without_the_graph_makes_every_rank_capture(mesh_loop,
                                                              lacks):
    """The ranks' agreement (``_all_ranks_hold``): where one rank's cache
    lacks the loop's graph, every rank takes the capture branch; where
    every rank holds it (``lacks`` -1), every rank replays."""
    assert [r["agree"][str(lacks)] for r in mesh_loop] == [lacks < 0] * 2
