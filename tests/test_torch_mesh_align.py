"""Port parity: ``align_images(mesh=...)`` over a ``torch.distributed``
process group against ``subpixal_tpu.align_images(mesh=make_mesh(D))``.

tests/test_mesh_align.py's scenes (3 × 256², and 6 × 256² at D = 4), its
oversized-footprint bucket, ``wcsupdate='otf'``, and the sparse deposit
with a self-heal go through the port on D = 2 and D = 4 gloo ranks on the
CPU (spawned processes that import only torch and the port; the plain
versions of the kernels) and through the JAX package's mesh on D of the
virtual CPU devices (tests/conftest.py). The JAX mesh runs each case at
D = 4 only, as tests/test_mesh_align.py does (its compiles take most of
this file's time), and the port's runs at D = 2 and 4 are both held to
it: the JAX package's own mesh runs agree across D within its mesh bar.
Every iteration's shifts agree
within ``SHIFT_TOL`` px with equal ``nmatches``, and the port's mesh run
is held to its own one-device run by the JAX package's mesh bar
(tests/test_mesh_align.py: shifts within 5e-4 px, matrices within 5e-5,
equal iteration counts). Every rank returns the same result.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from subpixal_tpu.align import align_images as j_align
from subpixal_tpu.catalogs import ImageSourceCatalog as JCatalog
from subpixal_tpu.parallel import make_mesh as j_make_mesh
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align_images
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.testing import SpawnedRanks

torch.set_num_threads(2)

#: the slices' acceptance bound: every iteration's shifts (px)
SHIFT_TOL = 1e-3
#: tests/test_mesh_align.py's bar between a mesh run and one device
MESH_SHIFT_TOL = 5e-4
MESH_MATRIX_TOL = 5e-5

#: tests/test_mesh_align.py's configuration
COMMON = dict(fitgeom="shift", max_iterations=3, usfac=4,
              fit_type="gaussian", cutout_shape=(24, 24), min_sources=3)
#: tests/test_torch_sparse.py's self-heal configuration, at 64² cutouts
HEAL = dict(fitgeom="shift", max_iterations=8, usfac=2, fit_type="gaussian",
            cutout_shape=(64, 64), min_sources=3, combine_seg_mask=False,
            peak_search_box=None, sparse_deposit=True)


def _scene(E=3, shape=(256, 256), nstars=12, seed=7):
    """tests/test_mesh_align.py's scene."""
    rng = np.random.default_rng(seed)
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(25, shape[1] - 25, nstars),
                      rng.uniform(25, shape[0] - 25, nstars)], 1)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    exps, planted = [], []
    for e in range(E):
        dx, dy = rng.uniform(-0.4, 0.4, 2)
        planted.append((dx, dy))
        img = rng.normal(0, 0.01, shape).astype(np.float32)
        for x0, y0 in stars:
            r2 = (xx - x0 - dx) ** 2 + (yy - y0 - dy) ** 2
            img += np.where(r2 < 64.0, 20.0 * np.exp(-r2 / (2 * 1.6 ** 2)),
                            0.0).astype(np.float32)
        wcs = JTanWCS(crpix=np.array([shape[1] / 2, shape[0] / 2]),
                      crval=np.array([150.0, 2.0]), cd=cd)
        exps.append(JExposure(img, wcs, name=f"m{e}"))
    return exps, planted


def _bucket_scene():
    """tests/test_mesh_align.py's bucket scene: one giant source."""
    exps, planted = _scene(seed=31)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    for e, (dx, dy) in zip(exps, planted):
        e.data = e.data + (60.0 * np.exp(
            -((xx - 70 - dx) ** 2 + (yy - 180 - dy) ** 2)
            / (2 * 7.0 ** 2))).astype(np.float32)
    return exps


def _heal_scene(E=4, shape=(512, 1024), ns=8, seed=21):
    """tests/test_torch_sparse.py's self-heal scene: sources in the left
    part of a wide frame (the live set leaves half the blocks out) and a
    30 px planted error on the last frame, beyond the live-set margin."""
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
            img += np.where(r2 < 64.0, 20.0 * np.exp(-r2 / (2 * 1.6 ** 2)),
                            0.0).astype(np.float32)
        wcs = JTanWCS(crpix=np.array([shape[1] / 2, shape[0] / 2]),
                      crval=np.array([150.0, 2.0]), cd=cd)
        if e == E - 1:
            wcs = wcs.replace(crpix=wcs.crpix + np.array([30.0, 0.0]))
        exps.append(JExposure(img, wcs, name=f"s{e}"))
    clean = JDrizzle([exps[0]])
    clean.execute()
    return exps, np.asarray(clean.output_sci)


#: each case and the mesh sizes it runs at
SIZES = dict(batch=(2, 4), six_frames=(4,), otf=(2, 4), bucket=(2, 4),
             heal=(2, 4))
CASES = [(name, D) for name, Ds in SIZES.items() for D in Ds]
#: the JAX mesh's size
JAX_D = 4


def _cases():
    """name -> (exposures, reference catalog image or None, config, the
    mesh sizes it runs at)."""
    heal, heal_cat = _heal_scene()
    cases = {
        "batch": (_scene()[0], None, COMMON),
        "six_frames": (_scene(E=6, seed=17)[0], None, COMMON),
        "otf": (_scene()[0], None, dict(COMMON, wcsupdate="otf")),
        "bucket": (_bucket_scene(), None, dict(COMMON, use_weights=False)),
        # the host loop re-enters after each heal, in both packages
        "heal": (heal, heal_cat, dict(HEAL, device_loop=False)),
    }
    return {k: v + (SIZES[k],) for k, v in cases.items()}

#: one rank: every case of the mesh size it is given, on the CPU
_RANK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from subpixal_tpu_torch import align_images
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.parallel import init_distributed, make_mesh
from subpixal_tpu_torch.resample import Exposure
from subpixal_tpu_torch.wcs import TanWCS

rank, world, addr, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
assert init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh(world, device="cpu")
out = {}
for name, case in json.load(open(spec)).items():
    if world not in case["sizes"]:
        continue
    z = np.load(case["scene"])
    exps = [Exposure(z["data"][e], TanWCS(crpix=z["crpix"][e],
                                          crval=z["crval"][e], cd=z["cd"][e]),
                     name=n) for e, n in enumerate(case["names"])]
    cats = ([ImageSourceCatalog(z["catalog"])] if "catalog" in z.files
            else None)
    r = align_images(cats, exposures=exps, mesh=mesh, device="cpu",
                     **case["config"])
    out[name] = dict(
        shifts=r.shifts.tolist(), matrices=r.matrices.tolist(),
        n_iterations=r.n_iterations, converged=r.converged,
        truncated=r.truncated_sources,
        bucket="big_bucket_stage" in r.setup_breakdown,
        breakdown={k: r.setup_breakdown[k] for k in (
            "sparse_live_set", "sparse_live_frac", "sparse_heals")
            if k in r.setup_breakdown},
        history=[[(x.name, x.iteration, x.nmatches, list(x.shift))
                  for x in recs] for recs in r.history])
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def port_mesh(cases, tmp_path_factory):
    """Starts D = 2 and D = 4 ranks (all cases each) at once; ``result(D)``
    collects them (the JAX runs go on meanwhile) and checks that every
    rank returned the same."""
    root = tmp_path_factory.mktemp("mesh_align")
    spec = {}
    for name, (exps, cat, cfg, sizes) in cases.items():
        path = str(root / f"{name}.npz")
        arrays = dict(data=np.stack([e.data for e in exps]),
                      crpix=np.stack([e.wcs.crpix for e in exps]),
                      crval=np.stack([e.wcs.crval for e in exps]),
                      cd=np.stack([e.wcs.cd for e in exps]))
        if cat is not None:
            arrays["catalog"] = cat
        np.savez(path, **arrays)
        spec[name] = dict(scene=path, names=[e.name for e in exps],
                          config=cfg, sizes=list(sizes))
    spec_path = str(root / "cases.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    worlds = {D: SpawnedRanks(_RANK, D, args=(spec_path,)) for D in (2, 4)}
    cache = {}

    def result(D):
        if D not in cache:
            cache[D] = [json.loads(next(ln for ln in o.splitlines()
                                        if ln.startswith("RESULT "))[7:])
                        for o in worlds[D].wait(timeout=400)]
        outs = cache[D]
        assert all(o == outs[0] for o in outs[1:]), "ranks disagree"
        return outs[0]

    yield result
    for w in worlds.values():
        w.kill()


@pytest.fixture(scope="module")
def one_device(cases):
    """The port's run of each case on one device (the CPU)."""
    cache = {}

    def run(name):
        if name not in cache:
            exps, cat, cfg, _ = cases[name]
            cats = None if cat is None else [ImageSourceCatalog(cat)]
            cache[name] = align_images(
                cats, exposures=exposures_from_reference(exps), device="cpu",
                **cfg)
        return cache[name]

    return run


@pytest.fixture(scope="module")
def jax_mesh(cases, port_mesh):
    """The JAX package's mesh runs, all made here while the port's ranks
    (started by ``port_mesh``) run, so that waiting for them costs
    little."""
    runs = {}
    for name, (exps, cat, cfg, _) in cases.items():
        cats = None if cat is None else [JCatalog(cat)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # the host loop compiles the mesh step alone (a fraction of
            # the device loop's compile on the CPU); the iterations are
            # the same
            runs[name] = j_align(cats, exposures=exps,
                                 mesh=j_make_mesh(JAX_D),
                                 **dict(cfg, device_loop=False))
    return runs


@pytest.mark.parametrize("name,D", CASES)
def test_mesh_matches_jax_mesh(port_mesh, jax_mesh, name, D):
    jr = jax_mesh[name]
    tr = port_mesh(D)[name]
    assert tr["n_iterations"] == jr.n_iterations
    assert tr["converged"] == jr.converged
    assert len(tr["history"]) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr["history"]):
        for a, (nm, it, nmatches, shift) in zip(jrecs, trecs):
            assert (nm, it, nmatches) == (a.name, a.iteration, a.nmatches)
            assert np.hypot(*np.subtract(shift, a.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr["shifts"], jr.shifts, atol=SHIFT_TOL)
    assert tr["truncated"] == jr.truncated_sources == []
    for key in ("sparse_heals", "sparse_live_frac"):
        assert tr["breakdown"].get(key) == jr.setup_breakdown.get(key)


@pytest.mark.parametrize("name,D", CASES)
def test_mesh_matches_one_device(port_mesh, one_device, name, D):
    one = one_device(name)
    tr = port_mesh(D)[name]
    assert tr["n_iterations"] == one.n_iterations
    assert np.abs(np.asarray(tr["shifts"]) - one.shifts).max() \
        < MESH_SHIFT_TOL
    np.testing.assert_allclose(tr["matrices"], one.matrices,
                               atol=MESH_MATRIX_TOL)
    for recs1, recs2 in zip(one.history, tr["history"]):
        assert [r.nmatches for r in recs1] == [r[2] for r in recs2]


def test_mesh_cases_engage_their_branches(port_mesh):
    """The bucket, the sparse compaction and its heal, and otf (which
    lands elsewhere than batch on this scene) really ran under the mesh."""
    for D in (2, 4):
        runs = port_mesh(D)
        assert runs["bucket"]["bucket"]
        assert runs["heal"]["breakdown"]["sparse_live_frac"] < 0.85
        assert runs["heal"]["breakdown"]["sparse_heals"] >= 1
        rel = np.asarray(runs["heal"]["shifts"])
        assert abs(rel[3, 0] - rel[:3, 0].mean() - 30.0) < 0.15
        assert np.abs(np.subtract(runs["otf"]["shifts"],
                                  runs["batch"]["shifts"])).max() > 1e-6
