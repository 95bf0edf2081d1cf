"""Port parity: the band-local source finder (``catalogs_spatial.py``)
against ``subpixal_tpu.catalogs.spatial``.

tests/test_spatial_catalog.py's scenes: the contaminated plane of its
statistics test, and its starfield (random stars and sources planted
across band boundaries). The port runs on spawned gloo ranks on the CPU,
D = 2 and D = 4 on a 1-D rows mesh and a (2, 2) mesh (whose rows axis
makes 2 bands), one program per world size; the JAX package on
``make_mesh(D, axis_name="rows")`` on the conftest's virtual CPU devices,
in this process while the ranks run. The statistics agree within 1e-5
relative (the port counts in int64 and sums in float64, the JAX package
in float32); the catalogs have equal rows, ids, areas and bboxes,
positions within 1e-4 px and fluxes within 1e-5 relative; the gathered
segmentation planes are equal; each source planted on a band boundary
is found once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.catalogs.spatial import (
    find_sources_spatial as j_find, sigma_clipped_stats_spatial as j_stats)
from subpixal_tpu.parallel import gather_rows as j_gather
from subpixal_tpu.parallel import make_mesh as j_make_mesh
from subpixal_tpu.parallel import shard_rows as j_shard
from subpixal_tpu_torch.testing import SpawnedRanks

torch.set_num_threads(2)

STATS_TOL = 1e-5
POS_TOL = 1e-4
FLUX_TOL = 1e-5
#: the port's meshes: (label, world size, bands)
MESHES = (("rows", 2, 2), ("rows", 4, 4), ("2x2", 4, 2))
EXACT = ("id", "area", "xmin", "xmax", "ymin", "ymax")


def _starfield(H=128, W=96, seed=3, n=12, boundary_rows=(16, 64)):
    """tests/test_spatial_catalog.py's starfield: random stars plus
    sources planted on band boundaries (64 is one at D = 2 and D = 4)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = rng.normal(0, 0.05, (H, W))
    pts = []
    for _ in range(n):
        x0 = rng.uniform(8, W - 8)
        y0 = rng.uniform(8, H - 8)
        if min(abs(y0 - b) for b in boundary_rows) < 6:
            y0 += 8.0
        pts.append((x0, y0, rng.uniform(30, 80)))
    for b in boundary_rows:
        pts.append((rng.uniform(10, W - 10), b + rng.uniform(-0.4, 0.4),
                    60.0))
    for x0, y0, a in pts:
        img += a * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 1.8 ** 2))
    return img.astype(np.float32), pts


def _contaminated():
    """tests/test_spatial_catalog.py's statistics plane."""
    rng = np.random.default_rng(0)
    img = rng.normal(5.0, 2.0, (128, 64)).astype(np.float32)
    img[:40] += 30.0 * (rng.random((40, 64)) > 0.97)
    return img


_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from subpixal_tpu_torch.catalogs_spatial import (
    SpatialSourceCatalog, find_sources_spatial, sigma_clipped_stats_spatial)
from subpixal_tpu_torch.parallel import (gather_rows, init_distributed,
                                         make_mesh, make_mesh2d, shard_rows)

rank, world, addr, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
assert init_distributed(addr, world, rank, backend="gloo")
z = np.load(path + "inputs.npz")
meshes = {"rows": make_mesh(world, axis_name="rows", device="cpu")}
if world == 4:
    meshes["2x2"] = make_mesh2d(2, 2, device="cpu")
out = {}
for label, mesh in meshes.items():
    key = f"{label}{world}"
    stats = sigma_clipped_stats_spatial(
        mesh, shard_rows(mesh, z["contaminated"]), 128)
    out[key + "/stats"] = np.asarray([float(v) for v in stats])
    band = shard_rows(mesh, z["starfield"])
    for name, kw in (("auto", dict(nsigma=5.0, npixels=5, window=16)),
                     ("thr50", dict(threshold=50.0, window=16))):
        cat, seg = find_sources_spatial(mesh, band, 128, **kw)
        for col in cat.colnames:
            out[f"{key}/{name}/{col}"] = np.asarray(cat[col])
        out[f"{key}/{name}/seg"] = gather_rows(seg, 128, mesh=mesh)
    c = SpatialSourceCatalog(mesh, band, 128, nsigma=5.0, window=16)
    out[key + "/facade_len"] = np.asarray(len(c))
    out[key + "/facade_seg"] = c.segmentation
    out[key + "/facade_seg_band"] = np.asarray(
        c.segmentation_device.shape)
if rank == 0:
    np.savez(path + f"out{world}.npz", **out)
print("RESULT ok", flush=True)
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("catalogs_spatial")) + "/"
    img, pts = _starfield()
    np.savez(root + "inputs.npz", starfield=img, contaminated=_contaminated())
    worlds = {D: SpawnedRanks(_RANK, D, args=(root,)) for D in (2, 4)}
    cache = {}

    def result(D):
        if D not in cache:
            worlds[D].wait(timeout=400)
            cache[D] = dict(np.load(root + f"out{D}.npz"))
        return cache[D]

    yield (img, pts), result
    for w in worlds.values():
        w.kill()


@pytest.fixture(scope="module")
def jax_runs(port):
    """The JAX package's statistics (at D = 4) and catalogs (at D = 2 and
    4: band-local detection depends on the band layout)."""
    (img, _), _ = port
    out = {}
    for nb in (2, 4):
        m = j_make_mesh(nb, axis_name="rows")
        band = j_shard(m, jnp.asarray(img))
        for name, kw in (("auto", dict(nsigma=5.0, npixels=5, window=16)),
                         ("thr50", dict(threshold=50.0, window=16))):
            cat, seg = j_find(m, band, 128, **kw)
            out[(nb, name)] = (cat, j_gather(seg, 128))
        if nb == 4:
            out["stats"] = [float(v) for v in j_stats(
                m, j_shard(m, jnp.asarray(_contaminated())), 128)]
    return out


@pytest.mark.parametrize("label,D,nb", MESHES)
def test_spatial_stats_match_jax(port, jax_runs, label, D, nb):
    """(mean, median, std): reduced counts and moments, and the 40-step
    bisection median."""
    _, result = port
    got = result(D)[f"{label}{D}/stats"]
    want = np.asarray(jax_runs["stats"])
    np.testing.assert_allclose(got, want, rtol=STATS_TOL)


@pytest.mark.parametrize("label,D,nb", MESHES)
@pytest.mark.parametrize("name", ["auto", "thr50"])
def test_spatial_finder_matches_jax(port, jax_runs, label, D, nb, name):
    """find_sources_spatial (the derived threshold, and an explicit one
    that keeps the bright half): equal rows, ids, areas, bboxes and
    segmentation ids; positions within POS_TOL px, fluxes within
    FLUX_TOL relative."""
    _, result = port
    r = result(D)
    key = f"{label}{D}/{name}"
    cat, seg = jax_runs[(nb, name)]
    assert len(r[key + "/id"]) == len(cat) > 0
    for col in EXACT:
        np.testing.assert_array_equal(r[f"{key}/{col}"], np.asarray(cat[col]))
    for col in ("x", "y"):
        np.testing.assert_allclose(r[f"{key}/{col}"], np.asarray(cat[col]),
                                   rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(r[key + "/flux"], np.asarray(cat["flux"]),
                               rtol=FLUX_TOL)
    np.testing.assert_array_equal(r[key + "/seg"], seg)


@pytest.mark.parametrize("label,D,nb", MESHES)
def test_straddlers_found_once(port, label, D, nb):
    """Every planted source is found, and the source planted on the
    boundary of two bands once, with its own id at its peak."""
    (img, pts), result = port
    r = result(D)
    key = f"{label}{D}/auto"
    assert len(r[key + "/id"]) == len(pts)
    ys = r[key + "/y"]
    for b in (16, 64):
        assert (np.abs(ys - b) < 1.0).sum() == 1
    seg = r[key + "/seg"]
    for i, x, y in zip(r[key + "/id"], r[key + "/x"], ys):
        assert seg[int(round(y)), int(round(x))] == i


@pytest.mark.parametrize("label,D,nb", MESHES)
def test_spatial_catalog_facade(port, label, D, nb):
    """SpatialSourceCatalog: its length, the gathered segmentation plane
    and each rank's band of it."""
    (img, pts), result = port
    r = result(D)
    key = f"{label}{D}"
    assert int(r[key + "/facade_len"]) == len(pts)
    assert r[key + "/facade_seg"].shape == img.shape
    np.testing.assert_array_equal(r[key + "/facade_seg"],
                                  r[key + "/auto/seg"])
    assert tuple(r[key + "/facade_seg_band"]) == (-(-128 // nb), 96)
