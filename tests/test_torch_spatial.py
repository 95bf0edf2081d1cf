"""Port parity: the spatial mosaics (``parallel/spatial.py``) and
``Drizzle(spatial_mesh=...)`` against ``subpixal_tpu``'s.

The port runs on spawned gloo ranks on the CPU (processes that import
only torch and the port): D = 2 and D = 4 on a 1-D rows mesh, and a
(2, 2) ``make_mesh2d`` mesh in the D = 4 program; every case of a world
size is computed by one program, and rank 0 writes the gathered results.
The JAX package runs as its own tests run it (tests/test_spatial.py,
test_spatial_sparse.py): ``make_mesh(D, axis_name="rows")`` and
``make_mesh2d(2, 2)`` on the conftest's virtual CPU devices, in this
process while the ranks run. The band layout (``band_rows``,
``shard_rows`` with its row padding, ``gather_rows``, ``halo_exchange``
with both edges) and the band live sets must be equal; the deposits,
the gathers (every interpolant, on queries across the bands' boundaries
and past every edge) and the Drizzle products within ``REL_TOL`` of the
largest value, with equal validity, context maps and CR masks. A sum of
per-band partials is exact in value but may round in another order, so
the values and products are compared at the JAX package's D = 4 (or
(2, 2)) and the port's at every D.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.align import _block_bboxes as j_block_bboxes
from subpixal_tpu.align import _compact_blocks_bands as j_compact_bands
from subpixal_tpu.align import _live_block_indices as j_live
from subpixal_tpu.parallel import band_rows as j_band_rows
from subpixal_tpu.parallel import (drizzle_deposit_sparse_spatial as
                                   j_dep_sparse)
from subpixal_tpu.parallel import drizzle_deposit_spatial as j_dep
from subpixal_tpu.parallel import drizzle_deposit_stack_spatial as j_dep_stack
from subpixal_tpu.parallel import gather_rows as j_gather
from subpixal_tpu.parallel import halo_exchange as j_halo
from subpixal_tpu.parallel import make_mesh as j_make_mesh
from subpixal_tpu.parallel import make_mesh2d as j_make_mesh2d
from subpixal_tpu.parallel import sample_spatial as j_sample
from subpixal_tpu.parallel import shard_rows as j_shard
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch.align import _live_block_indices
from subpixal_tpu_torch.parallel import drizzle_deposit_stack_spatial
from subpixal_tpu_torch.parallel.sharding import Mesh
from subpixal_tpu_torch.testing import SpawnedRanks

torch.set_num_threads(2)

#: B1's plain version and the gather sum in the JAX package's order up to
#: the bands' partials and the y - row0 shift in float32
REL_TOL = 1e-5

#: the deposit kernels tests/test_spatial.py holds the band deposit to
KERNELS = ("square", "turbo", "point", "gaussian", "lanczos3", "tophat")
INTERPS = ("nearest", "linear", "poly3", "poly5", "sinc", "spline3")
#: the port's meshes: (label, world size)
MESHES = (("rows", 2), ("rows", 4), ("2x2", 4))
H, W = 100, 64       # not divisible by 4 or 8: the last band pads
HALO = 3
SPLINE_HALO = 9      # within band_rows - pad at every mesh here
SINSCL = 2.0         # the rank program's sinc scale off 1
#: a plane whose bands (4 rows at D = 2, 2 at D = 4) are thinner than
#: poly5's 6-row footprint, and (interp, spline_halo) sampled from it:
#: spline3's halo of 2 is below its 4-row footprint
THIN_H = 8
THIN = (("poly5", 32), ("poly3", 32), ("sinc", 32), ("spline3", 2))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= REL_TOL * max(1.0,
                                                     np.abs(want).max())


def _pixmap(h, w, sx=1.03, sy=1.11, tx=1.7, ty=2.3):
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    return gx * sx + tx, gy * sy + ty


def _drizzle_scene(n=3, shape=(40, 36), seed=11, cr=False):
    """tests/test_spatial.py's Drizzle scene (and its planted CR)."""
    rng = np.random.default_rng(seed)
    s = 0.05 / 3600.0
    out = []
    for k in range(n):
        out.append(dict(
            data=rng.random(shape).astype(np.float32),
            crpix=[shape[1] / 2 + 0.3 * k, shape[0] / 2 - 0.2 * k],
            exptime=1.0 + k, name=f"s{k}"))
    if cr:
        out[1]["data"][20, 18] += 50.0
    cd = s * np.array([[-1.0, 0.0], [0.0, 1.0]])
    return out, cd


def _j_exposures(scene, sky=0.0):
    recs, cd = scene
    return [JExposure(r["data"] + np.float32(sky), JTanWCS(
        crpix=np.array(r["crpix"]), crval=np.array([150.0, 2.0]), cd=cd),
        exptime=r["exptime"], name=r["name"]) for r in recs]


def _sparse_scene(E=3, H=256, W=256, n_cut=3, h=24, w=24, seed=5):
    """tests/test_spatial_sparse.py's scene."""
    rng = np.random.default_rng(seed)
    data = rng.normal(1.0, 0.1, (E, H, W)).astype(np.float32)
    wht = np.ones((E, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    px = np.stack([xx + 0.3 * e + 1e-3 * yy for e in range(E)])
    py = np.stack([yy - 0.2 * e + 1e-3 * xx for e in range(E)])
    cyy, cxx = np.mgrid[0:h, 0:w].astype(np.float32)
    centers = rng.uniform(40, min(H, W) - 40, (n_cut, 2)).astype(np.float32)
    cut_px = np.stack([np.stack([cx - w / 2 + cxx for cx, _ in centers])
                       for _ in range(E)])
    cut_py = np.stack([np.stack([cy - h / 2 + cyy for _, cy in centers])
                       for _ in range(E)])
    bb = tuple(np.asarray(v) for v in j_block_bboxes(jnp.asarray(px),
                                                     jnp.asarray(py)))
    cut_bb = (cut_py.min((2, 3)), cut_py.max((2, 3)),
              cut_px.min((2, 3)), cut_px.max((2, 3)))
    return data, wht, px, py, bb, cut_bb


def _inputs():
    """Every case's inputs, as numpy."""
    rng = np.random.default_rng(5)
    z = dict(plane=rng.random((H, W)).astype(np.float32),
             rows=np.broadcast_to(np.arange(H, dtype=np.float32)[:, None],
                                  (H, W)).copy())
    # deposit: a frame mapped onto the whole output, every band touched
    img = rng.random((80, 60)).astype(np.float32)
    wht = rng.random((80, 60)).astype(np.float32)
    gx, gy = _pixmap(80, 60)
    z.update(dep_data=img, dep_wht=wht, dep_x=gx, dep_y=gy)
    # stack deposit (2-D mesh): 3 frames, mixed ratios
    st = np.random.default_rng(12)
    z.update(st_data=st.random((3, 40, 36)).astype(np.float32),
             st_wht=st.random((3, 40, 36)).astype(np.float32),
             st_x=np.stack([_pixmap(40, 36, tx=1.0 + 2 * k)[0]
                            for k in range(3)]),
             st_y=np.stack([_pixmap(40, 36, ty=2.0 - k)[1]
                            for k in range(3)]))
    # queries across every band boundary and past every edge
    # the thin plane, queried across each band boundary and past the edges
    z.update(thin=rng.random((THIN_H, W)).astype(np.float32),
             tqx=rng.uniform(-3, W + 2, (200,)).astype(np.float32),
             tqy=np.concatenate([
                 rng.uniform(-3, THIN_H + 2, (160,)),
                 np.repeat([1.5, 2.0, 3.99, 4.0, 5.3, 6.0, 7.5, 7.0],
                           5)]).astype(np.float32))
    z.update(qx=rng.uniform(-3, W + 2, (400,)).astype(np.float32),
             qy=np.concatenate([rng.uniform(-3, H + 2, (340,)),
                                np.repeat([24.5, 25.0, 49.9, 50.0, 75.2],
                                          12)]).astype(np.float32))
    # the band-compacted sparse deposit, per band count
    data, wht_s, px, py, bb, cut_bb = _sparse_scene()
    for nb in (2, 4):
        idx, valid = j_live(bb, cut_bb, (256, 256), blot_margin=24.0,
                            corr_margin=2.0,
                            bands=(nb, -(-256 // nb)))
        for k, v in zip(("data", "wht", "x", "y"), j_compact_bands(
                jnp.asarray(data), jnp.asarray(wht_s), jnp.asarray(px),
                jnp.asarray(py), jnp.asarray(idx), jnp.asarray(valid))):
            z[f"sp{nb}_{k}"] = np.asarray(v)
    return z


#: one rank: every case of its world size
_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from subpixal_tpu_torch.parallel import (
    band_rows, drizzle_deposit_sparse_spatial, drizzle_deposit_spatial,
    drizzle_deposit_stack_spatial, gather_rows, halo_exchange,
    init_distributed, make_mesh, make_mesh2d, sample_spatial, shard_rows)
from subpixal_tpu_torch.resample import Drizzle, Exposure
from subpixal_tpu_torch.wcs import TanWCS

SINSCL = 2.0
rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(sys.argv[4]))
assert init_distributed(addr, world, rank, backend="gloo")
z = {k: torch.tensor(v) for k, v in np.load(spec["inputs"]).items()}
meshes = {"rows": make_mesh(world, axis_name="rows", device="cpu")}
if world == 4:
    meshes["2x2"] = make_mesh2d(2, 2, device="cpu")
out = {}
H = z["plane"].shape[0]


def exposures(name, sky=0.0):
    return [Exposure(np.asarray(r["data"], np.float32) + np.float32(sky),
                     TanWCS(crpix=np.array(r["crpix"]),
                            crval=np.array([150.0, 2.0]),
                            cd=np.array(spec["cd"])),
                     exptime=r["exptime"], name=r["name"])
            for r in spec[name]]


for label, mesh in meshes.items():
    def put(key, band, rows=None):
        out[f"{label}{world}/{key}"] = gather_rows(band, rows, mesh=mesh)

    out[f"{label}{world}/band_rows"] = np.asarray(band_rows(mesh, H))
    band = shard_rows(mesh, z["plane"])
    put("shard", band)
    put("gather", band, H)
    rows = shard_rows(mesh, z["rows"])
    for edge in ("mirror", "zero"):
        put("halo_" + edge, halo_exchange(rows, spec["halo"], mesh,
                                          edge=edge))
    for kernel in spec["kernels"]:
        s, w = drizzle_deposit_spatial(
            mesh, z["dep_data"], z["dep_wht"], z["dep_x"], z["dep_y"],
            (H, 64), kernel=kernel, pixfrac=0.8)
        put("dep_sci_" + kernel, s, H)
        put("dep_wht_" + kernel, w, H)
    nb = mesh.shape["rows"]
    s, w = drizzle_deposit_sparse_spatial(
        mesh, *(z[f"sp{nb}_{k}"] for k in ("data", "wht", "x", "y")),
        (256, 256))
    put("sparse_sci", s, 256)
    put("sparse_wht", w, 256)
    if label == "2x2":
        for name, ratios in (("stack", 1.0), ("stack_mixed",
                                              (1.0, 0.7, 0.7))):
            s, w = drizzle_deposit_stack_spatial(
                mesh, z["st_data"], z["st_wht"], z["st_x"], z["st_y"],
                (H, 48), pixfrac=0.9, pscale_ratio=ratios)
            put(name + "_sci", s, H)
            put(name + "_wht", w, H)
    for interp in spec["interps"]:
        v, ok = sample_spatial(mesh, band, z["qx"], z["qy"], interp=interp,
                               fill=-7.0, logical_rows=H,
                               spline_halo=spec["spline_halo"])
        out[f"{label}{world}/sample_{interp}"] = v.numpy()
        out[f"{label}{world}/valid_{interp}"] = ok.numpy()
    v, ok = sample_spatial(mesh, band, z["qx"], z["qy"], interp="sinc",
                           sinscl=SINSCL, fill=-7.0, logical_rows=H)
    out[f"{label}{world}/sample_sinc_sinscl"] = v.numpy()
    out[f"{label}{world}/valid_sinc_sinscl"] = ok.numpy()
    if label == "rows":  # bands thinner than the interpolant's footprint
        thin = shard_rows(mesh, z["thin"])
        for interp, sh in spec["thin"]:
            v, ok = sample_spatial(mesh, thin, z["tqx"], z["tqy"],
                                   interp=interp, fill=-7.0,
                                   spline_halo=sh)
            out[f"rows{world}/thin_{interp}"] = v.numpy()
            out[f"rows{world}/thin_valid_{interp}"] = ok.numpy()
            try:  # an explicit use_pallas=True raises on the CPU
                sample_spatial(mesh, thin, z["tqx"], z["tqy"],
                               interp=interp, spline_halo=sh,
                               use_pallas=True)
            except ValueError:
                out[f"rows{world}/thin_forced_raises_{interp}"] = True
    # Drizzle(spatial_mesh=...): execute and the products
    d = Drizzle(exposures("scene"), spatial_mesh=mesh)
    d.execute()
    out[f"{label}{world}/execute_sci"] = d.output_sci
    out[f"{label}{world}/execute_wht"] = d.output_wht
    out[f"{label}{world}/execute_ctx"] = d.output_ctx
    # fast replace of a moved exposure, drop and add back
    moved = exposures("scene")[1]
    moved.wcs = moved.wcs.replace(crpix=moved.wcs.crpix
                                  + np.array([0.4, -0.3]))
    d.fast_replace_image(moved)
    out[f"{label}{world}/replace_sci"] = d.output_sci
    d.fast_drop_image("s0")
    out[f"{label}{world}/drop_sci"] = d.output_sci
    d.fast_add_image(exposures("scene")[0])
    out[f"{label}{world}/add_sci"] = d.output_sci
    # reject_cr: the band median blotted back by sample_spatial
    d = Drizzle(exposures("cr_scene"), spatial_mesh=mesh)
    d.execute()
    for e, m in enumerate(d.reject_cr()):
        out[f"{label}{world}/cr_mask{e}"] = m
    out[f"{label}{world}/cr_sci"] = d.output_sci
    # the stages that act on the exposures
    d = Drizzle(exposures("sky_scene", sky=0.25), spatial_mesh=mesh)
    d.execute()
    out[f"{label}{world}/skies"] = d.match_sky()
    out[f"{label}{world}/sky_sci"] = d.output_sci
    out[f"{label}{world}/static_mask"] = d.apply_static_mask()
if rank == 0:
    np.savez(spec["out"] + f"{world}.npz", **out)
print("RESULT ok", flush=True)
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Starts the D = 2 and D = 4 programs at once; ``result(D)`` waits
    for one and loads rank 0's results."""
    root = tmp_path_factory.mktemp("spatial")
    z = _inputs()
    np.savez(str(root / "inputs.npz"), **z)
    scene, cd = _drizzle_scene()
    spec = dict(inputs=str(root / "inputs.npz"), out=str(root / "out"),
                halo=HALO, spline_halo=SPLINE_HALO, kernels=KERNELS,
                thin=THIN,
                interps=INTERPS, cd=cd.tolist(),
                scene=[dict(r, data=r["data"].tolist()) for r in scene],
                cr_scene=[dict(r, data=r["data"].tolist())
                          for r in _drizzle_scene(n=4, seed=31, cr=True)[0]],
                sky_scene=[dict(r, data=r["data"].tolist())
                           for r in _drizzle_scene(seed=41)[0]])
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    worlds = {D: SpawnedRanks(_RANK, D, args=(str(root / "spec.json"),))
              for D in (2, 4)}
    cache = {}

    def result(D):
        if D not in cache:
            worlds[D].wait(timeout=400)
            cache[D] = dict(np.load(spec["out"] + f"{D}.npz"))
        return cache[D]

    yield z, result
    for w in worlds.values():
        w.kill()


@pytest.fixture(scope="module")
def jax_runs(port):
    """The JAX package's results: the layout at every D, the values at
    D = 4 and on (2, 2)."""
    z, _ = port
    out = {}
    meshes = {("rows", 2): j_make_mesh(2, axis_name="rows"),
              ("rows", 4): j_make_mesh(4, axis_name="rows"),
              ("2x2", 4): j_make_mesh2d(2, 2)}
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    for (label, D), m in meshes.items():
        key = f"{label}{D}"
        out[key + "/band_rows"] = j_band_rows(m, H)
        sp = j_shard(m, jnp.asarray(z["plane"]))
        out[key + "/shard"] = np.asarray(sp)
        out[key + "/gather"] = j_gather(sp, H)
        if label == "rows":
            rows = j_shard(m, jnp.asarray(z["rows"]))
            for edge in ("mirror", "zero"):
                out[key + "/halo_" + edge] = np.asarray(jax.jit(
                    jax.shard_map(lambda b, e=edge: j_halo(b, HALO, "rows",
                                                           edge=e),
                                  mesh=m, in_specs=P("rows", None),
                                  out_specs=P("rows", None)))(rows))
        nb = m.shape["rows"]
        s, w = j_dep_sparse(m, *(z[f"sp{nb}_{k}"]
                                 for k in ("data", "wht", "x", "y")),
                            (256, 256))
        out[key + "/sparse_sci"] = j_gather(s, 256)
        out[key + "/sparse_wht"] = j_gather(w, 256)
    m4, m22 = meshes[("rows", 4)], meshes[("2x2", 4)]
    for kernel in KERNELS:
        s, w = j_dep(m4, z["dep_data"], z["dep_wht"], z["dep_x"],
                     z["dep_y"], (H, 64), kernel=kernel, pixfrac=0.8)
        out["dep_sci_" + kernel] = j_gather(s, H)
        out["dep_wht_" + kernel] = j_gather(w, H)
    for name, ratios in (("stack", 1.0), ("stack_mixed", (1.0, 0.7, 0.7))):
        s, w = j_dep_stack(m22, z["st_data"], z["st_wht"], z["st_x"],
                           z["st_y"], (H, 48), pixfrac=0.9,
                           pscale_ratio=ratios)
        out[name + "_sci"] = j_gather(s, H)
        out[name + "_wht"] = j_gather(w, H)
    sp4 = j_shard(m4, jnp.asarray(z["plane"]))
    for interp in INTERPS:
        v, ok = j_sample(m4, sp4, z["qx"], z["qy"], interp=interp,
                         fill=-7.0, logical_rows=H, spline_halo=SPLINE_HALO)
        out["sample_" + interp] = np.asarray(v)
        out["valid_" + interp] = np.asarray(ok)
    v, ok = j_sample(m4, sp4, z["qx"], z["qy"], interp="sinc",
                     sinscl=SINSCL, fill=-7.0, logical_rows=H)
    out["sample_sinc_sinscl"] = np.asarray(v)
    out["valid_sinc_sinscl"] = np.asarray(ok)
    for D in (2, 4):  # the JAX package's default use_pallas=False
        m = meshes[("rows", D)]
        thin = j_shard(m, jnp.asarray(z["thin"]))
        for interp, sh in THIN:
            v, ok = j_sample(m, thin, z["tqx"], z["tqy"], interp=interp,
                             fill=-7.0, spline_halo=sh)
            out[f"rows{D}/thin_{interp}"] = np.asarray(v)
            out[f"rows{D}/thin_valid_{interp}"] = np.asarray(ok)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, m in (("rows", m4), ("2x2", m22)):
            d = JDrizzle(_j_exposures(_drizzle_scene()), spatial_mesh=m)
            d.execute()
            out[label + "/execute_sci"] = d.output_sci
            out[label + "/execute_wht"] = d.output_wht
            out[label + "/execute_ctx"] = d.output_ctx
        exps = _j_exposures(_drizzle_scene())
        d = JDrizzle(exps, spatial_mesh=m4)
        d.execute()
        moved = exps[1].copy()
        moved.wcs = moved.wcs.replace(crpix=moved.wcs.crpix
                                      + np.array([0.4, -0.3]))
        d.fast_replace_image(moved)
        out["replace_sci"] = d.output_sci
        d.fast_drop_image("s0")
        out["drop_sci"] = d.output_sci
        d.fast_add_image(_j_exposures(_drizzle_scene())[0])
        out["add_sci"] = d.output_sci
        d = JDrizzle(_j_exposures(_drizzle_scene(n=4, seed=31, cr=True)),
                     spatial_mesh=m4)
        d.execute()
        out["cr_masks"] = [np.asarray(m) for m in d.reject_cr()]
        out["cr_sci"] = d.output_sci
        d = JDrizzle(_j_exposures(_drizzle_scene(seed=41), sky=0.25),
                     spatial_mesh=m4)
        d.execute()
        out["skies"] = d.match_sky()
        out["sky_sci"] = d.output_sci
        out["static_mask"] = np.asarray(d.apply_static_mask())
    return out


@pytest.mark.parametrize("label,D", MESHES)
def test_band_layout_matches_jax(port, jax_runs, label, D):
    """band_rows, shard_rows with its zero row padding, gather_rows:
    equal."""
    _, result = port
    r = result(D)
    key = f"{label}{D}"
    assert int(r[key + "/band_rows"]) == jax_runs[key + "/band_rows"]
    np.testing.assert_array_equal(r[key + "/shard"], jax_runs[key + "/shard"])
    np.testing.assert_array_equal(r[key + "/gather"],
                                  jax_runs[key + "/gather"])
    np.testing.assert_array_equal(r[key + "/gather"], port[0]["plane"])


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("edge", ["mirror", "zero"])
def test_halo_exchange_matches_jax(port, jax_runs, D, edge):
    """Every band extended by its neighbours' rows, the mirror or zero
    edge at the plane's top and bottom: equal."""
    _, result = port
    key = f"rows{D}/halo_{edge}"
    np.testing.assert_array_equal(result(D)[key], jax_runs[key])


@pytest.mark.parametrize("label,D", MESHES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_band_deposit_matches_jax(port, jax_runs, label, D, kernel):
    """drizzle_deposit_spatial: the bands' union within REL_TOL."""
    _, result = port
    r = result(D)
    for part in ("sci", "wht"):
        got = r[f"{label}{D}/dep_{part}_{kernel}"]
        want = jax_runs[f"dep_{part}_{kernel}"]
        assert float(np.abs(want).sum()) > 0
        assert _close(got, want)


@pytest.mark.parametrize("label,D", MESHES)
def test_sparse_band_deposit_matches_jax(port, jax_runs, label, D):
    """drizzle_deposit_sparse_spatial on the JAX package's band-compacted
    stacks (summed over the frames axis on the 2-D mesh)."""
    _, result = port
    r = result(D)
    for part in ("sci", "wht"):
        key = f"{label}{D}/sparse_{part}"
        assert _close(r[key], jax_runs[key])


@pytest.mark.parametrize("name", ["stack", "stack_mixed"])
def test_stack_deposit_on_2d_mesh_matches_jax(port, jax_runs, name):
    """drizzle_deposit_stack_spatial on (2, 2): each rank's frames in one
    deposit, summed over the frames axis; one ratio, and mixed ratios."""
    _, result = port
    r = result(4)
    for part in ("sci", "wht"):
        assert _close(r[f"2x24/{name}_{part}"], jax_runs[f"{name}_{part}"])


def test_stack_deposit_wants_2d_mesh():
    mesh = Mesh(None, 0, 1, "cpu", ("rows",))
    z = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="2-D"):
        drizzle_deposit_stack_spatial(mesh, z, None, z, z, (16, 16))


@pytest.mark.parametrize("label,D", MESHES)
@pytest.mark.parametrize("interp", INTERPS)
def test_sample_spatial_matches_jax(port, jax_runs, label, D, interp):
    """sample_spatial on queries across the bands' boundaries and past
    every edge: equal validity, values within REL_TOL (spline3: each
    band's prefilter over a mirror-remapped halo)."""
    _, result = port
    r = result(D)
    np.testing.assert_array_equal(r[f"{label}{D}/valid_{interp}"],
                                  jax_runs["valid_" + interp])
    assert _close(r[f"{label}{D}/sample_{interp}"],
                  jax_runs["sample_" + interp])


@pytest.mark.parametrize("label,D", MESHES)
def test_sample_spatial_sinc_sinscl_matches_jax(port, jax_runs, label, D):
    """sample_spatial(interp='sinc', sinscl=2) on the CPU's plain partials
    honours the sinc scale as the JAX package does: equal validity,
    values within REL_TOL, and not the sinscl=1 values."""
    _, result = port
    r = result(D)
    np.testing.assert_array_equal(r[f"{label}{D}/valid_sinc_sinscl"],
                                  jax_runs["valid_sinc_sinscl"])
    assert _close(r[f"{label}{D}/sample_sinc_sinscl"],
                  jax_runs["sample_sinc_sinscl"])
    assert not _close(r[f"{label}{D}/sample_sinc_sinscl"],
                      jax_runs["sample_sinc"])


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("interp,spline_halo", THIN)
def test_sample_spatial_thin_bands_match_jax(port, jax_runs, D, interp,
                                             spline_halo):
    """sample_spatial on bands thinner than the interpolant's footprint
    (8 rows over 2 and 4 bands), and spline3 with a spline_halo below it,
    under the default use_pallas: a result, against the JAX package's
    default (use_pallas=False) at the same band count, with equal
    validity and values within REL_TOL. An explicit use_pallas=True
    raises ValueError here, off CUDA (its refusal of these shapes on the
    card is tests/test_torch_cuda.py's)."""
    _, result = port
    r = result(D)
    key = f"rows{D}/thin_"
    np.testing.assert_array_equal(r[key + "valid_" + interp],
                                  jax_runs[key + "valid_" + interp])
    assert r[key + "valid_" + interp].any()
    assert _close(r[key + interp], jax_runs[key + interp])
    assert bool(r[key + "forced_raises_" + interp])


@pytest.mark.parametrize("label,D", MESHES)
def test_spatial_drizzle_execute_matches_jax(port, jax_runs, label, D):
    """Drizzle(spatial_mesh=...).execute: output_sci, output_wht (the
    bands gathered) within REL_TOL, output_ctx equal."""
    _, result = port
    r = result(D)
    jl = "2x2" if label == "2x2" else "rows"
    for part in ("sci", "wht"):
        assert _close(r[f"{label}{D}/execute_{part}"],
                      jax_runs[f"{jl}/execute_{part}"])
    np.testing.assert_array_equal(r[f"{label}{D}/execute_ctx"],
                                  jax_runs[f"{jl}/execute_ctx"])


@pytest.mark.parametrize("label,D", MESHES)
def test_spatial_drizzle_fast_paths_match_jax(port, jax_runs, label, D):
    """fast_replace_image, fast_drop_image and fast_add_image on the band
    accumulators."""
    _, result = port
    r = result(D)
    for key in ("replace_sci", "drop_sci", "add_sci"):
        assert _close(r[f"{label}{D}/{key}"], jax_runs[key])


@pytest.mark.parametrize("label,D", MESHES)
def test_spatial_reject_cr_matches_jax(port, jax_runs, label, D):
    """reject_cr under a spatial mesh: the bands' median blotted back by
    sample_spatial flags the same pixels (the planted CR among them),
    and the re-drizzled product agrees."""
    _, result = port
    r = result(D)
    assert r[f"{label}{D}/cr_mask1"][20, 18]
    for e, want in enumerate(jax_runs["cr_masks"]):
        np.testing.assert_array_equal(r[f"{label}{D}/cr_mask{e}"], want)
    assert _close(r[f"{label}{D}/cr_sci"], jax_runs["cr_sci"])


@pytest.mark.parametrize("label,D", MESHES)
def test_spatial_stages_match_jax(port, jax_runs, label, D):
    """match_sky and apply_static_mask compose with band accumulators."""
    _, result = port
    r = result(D)
    np.testing.assert_allclose(r[f"{label}{D}/skies"], jax_runs["skies"],
                               rtol=1e-6, atol=1e-7)
    assert _close(r[f"{label}{D}/sky_sci"], jax_runs["sky_sci"])
    np.testing.assert_array_equal(r[f"{label}{D}/static_mask"],
                                  jax_runs["static_mask"])


@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_band_live_sets_match_jax(n_bands):
    """align._live_block_indices(bands=...): each band's live blocks,
    equal to the JAX package's; their union is the one live set."""
    _, _, _, _, bb, cut_bb = _sparse_scene()
    kw = dict(blot_margin=24.0, corr_margin=2.0)
    bands = (n_bands, -(-256 // n_bands))
    idx, valid = _live_block_indices(bb, cut_bb, (256, 256), bands=bands,
                                     **kw)
    j_idx, j_valid = j_live(bb, cut_bb, (256, 256), bands=bands, **kw)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(valid, j_valid)
    one, one_v = _live_block_indices(bb, cut_bb, (256, 256), **kw)
    for e in range(idx.shape[1]):
        union = set().union(*(set(idx[b, e][valid[b, e]])
                              for b in range(n_bands)))
        assert union == set(one[e][one_v[e]])
