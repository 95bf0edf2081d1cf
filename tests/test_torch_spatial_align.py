"""Port parity: ``align_images`` through ``Drizzle(spatial_mesh=...)``
against ``subpixal_tpu``'s spatial align.

The JAX package's spatial scenes (tests/test_spatial.py,
test_spatial_sparse.py, test_spatial_catalog.py): batch, otf and the
host loop on 3 × 96²; the band-local sparse deposit on a tall 3 × 1024 ×
256 scene whose stars fill the top rows; its self-heal (a frame planted
30 px off, 3 × 256 × 1024, a given catalog); the oversized-footprint
bucket (a giant source on 2 × 256²); the 2-D (2, 2) mesh; and the
band-local catalog (``device_catalog='device'``). The port runs on
spawned gloo ranks on the CPU, D = 2 and D = 4 on a 1-D rows mesh and
(2, 2) in the D = 4 program, one program per world size; the JAX package
on its virtual CPU mesh in this process while the ranks run, once a
case: at D = 4 (the spatial align's values do not depend on D, as the
JAX package's own tests hold), on (2, 2), and for the band-local catalog
at D = 2 (detection depends on the band layout). Every iteration's
shifts within ``SHIFT_TOL`` px with equal ``nmatches``; every run within
``SPATIAL_TOL`` px of the port's own run without a spatial mesh (the
JAX package's bar, tests/test_spatial.py); every rank returns the same.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from subpixal_tpu.align import align_images as j_align
from subpixal_tpu.catalogs import ImageSourceCatalog as JCatalog
from subpixal_tpu.parallel import make_mesh as j_make_mesh
from subpixal_tpu.parallel import make_mesh2d as j_make_mesh2d
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu_torch import align_images
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.parallel.sharding import Mesh
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.testing import SpawnedRanks

torch.set_num_threads(2)

#: the slices' bound: every iteration's shifts (px) against the JAX
#: package's spatial run
SHIFT_TOL = 1e-3
#: tests/test_spatial.py's bar between a spatial run and the plain one
SPATIAL_TOL = 2e-3

#: tests/test_spatial.py's configuration
SMALL = dict(fitgeom="shift", max_iterations=3, usfac=4, fit_type="gaussian",
             cutout_shape=(16, 16), min_sources=3)
#: tests/test_spatial_sparse.py's self-heal configuration
HEAL = dict(fitgeom="shift", max_iterations=8, usfac=2, fit_type="gaussian",
            cutout_shape=(96, 96), min_sources=3, combine_seg_mask=False,
            peak_search_box=None, sparse_deposit=True, device_loop=False)
#: tests/test_spatial_sparse.py's bucket configuration
BUCKET = dict(fitgeom="shift", max_iterations=6, eps_shift=0.004, usfac=4,
              fit_type="gaussian", min_sources=5, max_cut_size=32,
              use_weights=False)

#: case -> the port's meshes it runs on, and the JAX mesh it is held to
CASES = {
    "batch": (("rows2", "rows4", "2x24"), "rows4"),
    "otf": (("rows2", "rows4"), "rows4"),
    "host_loop": (("rows2", "rows4"), "rows4"),
    "sparse": (("rows2", "rows4", "2x24"), "rows4"),
    "heal": (("rows2", "rows4"), "rows4"),
    "bucket": (("rows2", "rows4"), "rows4"),
    "mesh2d": (("2x24",), "2x2"),
    "catalog": (("rows2", "2x24"), "rows2"),
    # the bucket under the band-local catalog: the JAX package stages the
    # bucket's segmentation masks from a 1 x 1 zero plane there
    # (subpixal_tpu/align.py:1984-1990), so its bucket sources drop out
    # of the fit; the port samples them from the bands, and is held to
    # its own run without a spatial mesh only
    "catalog_bucket": (("rows2", "rows4"), None),
}
PAIRS = [(c, m) for c, (ms, _) in CASES.items() for m in ms]
JAX_PAIRS = [(c, m) for c, m in PAIRS if CASES[c][1] is not None]
#: mesh label -> its number of row bands
BANDS = {"rows2": 2, "rows4": 4, "2x24": 2, "2x2": 2}


def _small():
    return j_simulate(n_exp=3, shape=(96, 96), n_stars=6, seed=21)[0]


def _tall():
    return j_simulate(n_exp=3, shape=(1024, 256), n_stars=6, seed=7,
                      star_box=(40, 216, 40, 300))[0]


def _heal():
    """tests/test_spatial_sparse.py's self-heal scene and its catalog
    image (one clean frame drizzled)."""
    from test_sparse_deposit import _warning_scene

    exps = _warning_scene(shape=(256, 1024), E=3, seed=21)
    e2 = exps[2]
    bad = e2.wcs.replace(crpix=e2.wcs.crpix + np.array([30.0, 0.0]))
    exps = exps[:2] + [JExposure(e2.data.copy(), bad, name=e2.name)]
    clean = JDrizzle([exps[0]])
    clean.execute()
    return exps, np.asarray(clean.output_sci)


def _bucket():
    exps, _ = j_simulate(n_exp=2, shape=(256, 256), n_stars=12, seed=31)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    for exp in exps:
        exp.data = exp.data + (300.0 * np.exp(
            -((xx - 70.0) ** 2 + (yy - 180.0) ** 2)
            / (2 * 8.0 ** 2))).astype(np.float32)
    return exps


def _cases():
    """case -> (JAX exposures, catalog image or None, config)."""
    heal, heal_cat = _heal()
    return {
        "batch": (_small(), None, SMALL),
        "otf": (_small(), None, dict(SMALL, max_iterations=4,
                                     wcsupdate="otf")),
        "host_loop": (_small(), None, dict(SMALL, device_loop=False)),
        "sparse": (_tall(), None, dict(SMALL, max_iterations=2,
                                       sparse_deposit=True)),
        "heal": (heal, heal_cat, HEAL),
        "bucket": (_bucket(), None, BUCKET),
        "mesh2d": (_small(), None, SMALL),
        # auto-sized cutouts: no source outgrows them
        "catalog": (_small(), None, dict(SMALL, cutout_shape=None,
                                         device_catalog="device",
                                         catalog_window=16)),
        "catalog_bucket": (_small(), None, dict(SMALL,
                                                device_catalog="device",
                                                catalog_window=16)),
    }


_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from subpixal_tpu_torch import align_images
from subpixal_tpu_torch.catalogs import ImageSourceCatalog
from subpixal_tpu_torch.parallel import (init_distributed, make_mesh,
                                         make_mesh2d)
from subpixal_tpu_torch.resample import Drizzle, Exposure
from subpixal_tpu_torch.wcs import TanWCS

rank, world, addr, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
assert init_distributed(addr, world, rank, backend="gloo")
meshes = {f"rows{world}": make_mesh(world, axis_name="rows", device="cpu")}
if world == 4:
    meshes["2x24"] = make_mesh2d(2, 2, device="cpu")
out = {}
for name, case in json.load(open(spec)).items():
    z = np.load(case["scene"])
    for label in case["meshes"]:
        if label not in meshes:
            continue
        exps = [Exposure(z["data"][e], TanWCS(
            crpix=z["crpix"][e], crval=z["crval"][e], cd=z["cd"][e]),
            name=n) for e, n in enumerate(case["names"])]
        cats = ([ImageSourceCatalog(z["catalog"])] if "catalog" in z.files
                else None)
        r = align_images(cats, Drizzle(exps, spatial_mesh=meshes[label]),
                         device="cpu", **case["config"])
        out[f"{name}/{label}"] = dict(
            shifts=r.shifts.tolist(), n_iterations=r.n_iterations,
            converged=r.converged, truncated=r.truncated_sources,
            bucket="big_bucket_stage" in r.setup_breakdown,
            breakdown={k: r.setup_breakdown[k] for k in (
                "sparse_live_frac", "sparse_heals", "loop_steps",
                "loop_host_reads") if k in r.setup_breakdown},
            spatial=r.drizzle.spatial_mesh is meshes[label],
            history=[[(x.name, x.iteration, x.nmatches, list(x.shift))
                      for x in recs] for recs in r.history])
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def port_spatial(cases, tmp_path_factory):
    """Starts the D = 2 and D = 4 programs (every case each) at once;
    ``result(label)`` collects them and checks that the ranks agree;
    ``result(label, every_rank=True)`` returns each rank's records."""
    root = tmp_path_factory.mktemp("spatial_align")
    spec = {}
    for name, (exps, cat, cfg) in cases.items():
        path = str(root / f"{name}.npz")
        arrays = dict(data=np.stack([e.data for e in exps]),
                      crpix=np.stack([e.wcs.crpix for e in exps]),
                      crval=np.stack([e.wcs.crval for e in exps]),
                      cd=np.stack([e.wcs.cd for e in exps]))
        if cat is not None:
            arrays["catalog"] = cat
        np.savez(path, **arrays)
        spec[name] = dict(scene=path, names=[e.name for e in exps],
                          config=cfg, meshes=list(CASES[name][0]))
    spec_path = str(root / "cases.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    worlds = {D: SpawnedRanks(_RANK, D, args=(spec_path,)) for D in (2, 4)}
    cache = {}

    def result(label, every_rank=False):
        D = int(label[-1])
        if D not in cache:
            cache[D] = [json.loads(next(ln for ln in o.splitlines()
                                        if ln.startswith("RESULT "))[7:])
                        for o in worlds[D].wait(timeout=500)]
        outs = cache[D]
        if every_rank:
            return outs
        assert all(o == outs[0] for o in outs[1:]), "ranks disagree"
        return outs[0]

    yield result
    for w in worlds.values():
        w.kill()


@pytest.fixture(scope="module")
def jax_spatial(cases, port_spatial):
    """The JAX package's spatial runs, made here while the port's ranks
    (started by ``port_spatial``) run."""
    meshes = {"rows4": j_make_mesh(4, axis_name="rows"),
              "rows2": j_make_mesh(2, axis_name="rows"),
              "2x2": j_make_mesh2d(2, 2)}
    runs = {}
    for name, (exps, cat, cfg) in cases.items():
        if CASES[name][1] is None:
            continue
        cats = None if cat is None else [JCatalog(cat)]
        d = JDrizzle([e.copy() for e in exps],
                     spatial_mesh=meshes[CASES[name][1]])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[name] = j_align(cats, d, **cfg)
    return runs


@pytest.fixture(scope="module")
def one_device(cases):
    """The port's run of each case without a spatial mesh (the CPU)."""
    cache = {}

    def run(name):
        if name not in cache:
            exps, cat, cfg = cases[name]
            cats = None if cat is None else [ImageSourceCatalog(cat)]
            cache[name] = align_images(
                cats, exposures=exposures_from_reference(exps), device="cpu",
                **cfg)
        return cache[name]

    return run


@pytest.mark.parametrize("name,label", JAX_PAIRS)
def test_spatial_align_matches_jax(port_spatial, jax_spatial, name, label):
    """Every iteration's shifts within SHIFT_TOL px of the JAX package's
    spatial run, with equal nmatches and iteration counts, and at the
    same band count equal sparse fractions and heals (each band's live
    set depends on its rows); the final Drizzle keeps the spatial
    mesh."""
    jr = jax_spatial[name]
    tr = port_spatial(label)[f"{name}/{label}"]
    assert tr["n_iterations"] == jr.n_iterations
    assert tr["converged"] == jr.converged
    assert len(tr["history"]) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr["history"]):
        for a, (nm, it, nmatches, shift) in zip(jrecs, trecs):
            assert (nm, it, nmatches) == (a.name, a.iteration, a.nmatches)
            assert np.hypot(*np.subtract(shift, a.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr["shifts"], jr.shifts, atol=SHIFT_TOL)
    assert tr["truncated"] == jr.truncated_sources == []
    if BANDS[label] == BANDS[CASES[name][1]]:
        for key in ("sparse_heals", "sparse_live_frac"):
            assert tr["breakdown"].get(key) == jr.setup_breakdown.get(key)
    assert tr["spatial"]


@pytest.mark.parametrize("name,label", PAIRS)
def test_spatial_align_matches_one_device(port_spatial, one_device, name,
                                          label):
    """The spatial run lands on the port's own run without a spatial mesh
    (same catalog finder: the band-local one against the device one)."""
    one = one_device(name)
    tr = port_spatial(label)[f"{name}/{label}"]
    assert tr["n_iterations"] == one.n_iterations
    assert np.abs(np.asarray(tr["shifts"]) - one.shifts).max() < SPATIAL_TOL
    assert [r[2] for r in tr["history"][0]] == [
        r.nmatches for r in one.history[0]]


def test_spatial_cases_engage_their_branches(port_spatial):
    """The band-compacted deposit, its heal (at 4 bands: at 2 the heal
    scene's band live sets keep every block), the bucket and otf (which
    lands elsewhere than batch) really ran under the spatial meshes."""
    for label in ("rows2", "rows4"):
        runs = {k.split("/")[0]: v for k, v in port_spatial(label).items()
                if k.endswith("/" + label)}
        assert runs["sparse"]["breakdown"]["sparse_live_frac"] <= 0.5
        assert runs["heal"]["converged"]
        assert runs["bucket"]["bucket"] and runs["catalog_bucket"]["bucket"]
        assert np.abs(np.subtract(runs["otf"]["shifts"],
                                  runs["batch"]["shifts"])).max() > 1e-6
    assert not port_spatial("rows2")["catalog/rows2"]["bucket"]
    heal = port_spatial("rows4")["heal/rows4"]["breakdown"]
    assert heal["sparse_live_frac"] <= 0.5 and heal["sparse_heals"] >= 1


#: the pairs that run the device loop (host_loop and heal run the host
#: loop)
LOOP_PAIRS = [(c, m) for c, m in PAIRS if c not in ("host_loop", "heal")]


@pytest.mark.parametrize("name,label", LOOP_PAIRS)
def test_spatial_device_loop_reads_every_fourth_iteration(port_spatial,
                                                          name, label):
    """Under a spatial mesh the device loop reads the host every
    ``READ_EVERY`` (4) iterations and at the end of an entry, on gloo
    too: at most ⌈n/4⌉ + 1 reads an entry, and every rank runs as many
    masked steps (the collectives of the band exchange and the MAX
    reductions stay in step)."""
    runs = [r[f"{name}/{label}"]
            for r in port_spatial(label, every_rank=True)]
    n = runs[0]["n_iterations"]
    bd = runs[0]["breakdown"]
    entries = 1 + bd.get("sparse_heals", 0)
    assert [r["breakdown"]["loop_steps"] for r in runs] == \
        [bd["loop_steps"]] * len(runs)
    assert n <= bd["loop_steps"] <= n + 3 * entries
    for r in runs:
        assert 0 < r["breakdown"]["loop_host_reads"] <= entries * (
            -(-n // 4) + 1)


def test_mesh_and_spatial_mesh_are_exclusive():
    """mesh= (frames and cutouts sharded) with a spatial Drizzle (the
    plane's rows sharded) is refused before any collective."""
    mesh = Mesh(None, 0, 1, "cpu", ("rows",))
    d = Drizzle(exposures_from_reference(_small()), spatial_mesh=mesh)
    assert d.device.type == "cpu"
    with pytest.raises(ValueError, match="mutually exclusive"):
        align_images(resample=d, mesh=mesh, device="cpu",
                     cutout_shape=(16, 16))
