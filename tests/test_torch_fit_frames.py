"""Port parity: the per-frame and sharded fits, and the sharded
measurement of ``parallel.sharding``, against the JAX package.

On one process ``iter_linear_fit_frames`` and ``iter_linear_fit_sharded``
(no group) are held to the JAX package's fits to ``FIT_TOL`` px
(``MATRIX_FIT_TOL`` for the fits with a matrix) with equal ``nmatches``. Then two ranks of a real ``torch.distributed`` gloo
group (spawned processes that import only torch and the port) run the
frames fit, the sharded fit, ``sharded_find_displacement``,
``sharded_measure_and_fit`` and ``make_sharded_align_step`` on halves of
the same inputs, against the JAX package's own functions under
``shard_map`` on 2 of the virtual CPU devices (tests/conftest.py). The
moment sums are the ranks' partial sums added (``psum`` / ``all_reduce``),
so the fits agree to the same bounds; the measurements differ by the two
packages' float32 transforms, ``MEAS_TOL`` px as in
tests/test_torch_correlate.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from subpixal_tpu.ops.fit import iter_linear_fit_frames as j_frames
from subpixal_tpu.ops.fit import iter_linear_fit_sharded as j_sharded
from subpixal_tpu.parallel import make_mesh as j_make_mesh
from subpixal_tpu.parallel import make_sharded_align_step as j_step
from subpixal_tpu.parallel import sharded_find_displacement as j_sfd
from subpixal_tpu.parallel import sharded_measure_and_fit as j_smf
from subpixal_tpu_torch.ops.fit import (iter_linear_fit_frames,
                                        iter_linear_fit_sharded)
from subpixal_tpu_torch.testing import SpawnedRanks

torch.set_num_threads(2)

#: fits of the same points: float32 sums in another order (px). The
#: rscale and general fits solve a matrix from second moments of ~4e4,
#: and 3 ulp of it (3.6e-7) move the shift of points 60 px from the
#: origin by 2.3e-5 px
FIT_TOL = 1e-5
MATRIX_FIT_TOL = 5e-5
#: displacements measured by the two packages' transforms (px)
MEAS_TOL = 2e-4
GEOMS = ("shift", "rscale", "general")


def _fit_scene(E=3, n=40, seed=4):
    """A flattened (frame, source) batch: per-frame planted affines,
    noise, two outliers per frame and some zero weights."""
    rng = np.random.default_rng(seed)
    xy, uv, fid = [], [], []
    for e in range(E):
        p = rng.uniform(10, 110, (n, 2))
        M = np.eye(2) + rng.normal(0, 4e-4, (2, 2))
        q = p @ M.T + rng.uniform(-0.5, 0.5, 2) + rng.normal(0, 0.005, p.shape)
        q[[3, 17]] += [[6.0, -2.0], [-5.0, 4.0]]
        xy.append(q)
        uv.append(p)
        fid.append(np.full(n, e))
    w = rng.uniform(0.5, 1.0, E * n)
    w[[5, 50]] = 0.0
    return (np.concatenate(xy).astype(np.float32),
            np.concatenate(uv).astype(np.float32),
            np.concatenate(fid).astype(np.int32), w.astype(np.float32))


def _pairs(B=9, n=32, seed=0):
    """tests/test_sharding.py's Gaussian pairs (B not a multiple of 2)."""
    rng = np.random.default_rng(seed)
    dxs, dys = rng.uniform(-0.5, 0.5, (2, B))
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    ref = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / 8.0)
    img = np.exp(-((xx[None] - n / 2 - dxs[:, None, None]) ** 2
                   + (yy[None] - n / 2 - dys[:, None, None]) ** 2) / 8.0)
    return (np.broadcast_to(ref, img.shape).astype(np.float32),
            img.astype(np.float32))


def _step_scene(E=2, N=4, h=24, seed=6):
    """A 128² reference with N stars and, per frame, image cutouts of the
    stars shifted by the frame's planted offset, their pixmaps into the
    reference, Jacobians, weights and frame ids (B = E·N rows)."""
    rng = np.random.default_rng(seed)
    stars = rng.uniform(30, 98, (N, 2))

    def render(x, y, sx, sy):
        out = np.zeros(np.broadcast(x, y).shape)
        for cx, cy in stars:
            out += 20.0 * np.exp(-((x - cx - sx) ** 2 + (y - cy - sy) ** 2)
                                 / (2 * 1.8 ** 2))
        return out

    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    drz = render(xx, yy, 0.0, 0.0)
    gy, gx = np.mgrid[0:h, 0:h].astype(np.float64)
    rows = dict(px=[], py=[], img=[], xy0=[], fid=[])
    for e in range(E):
        off = rng.uniform(-0.4, 0.4, 2)
        for cx, cy in stars:
            x0, y0 = np.floor(cx + 0.5) - h // 2, np.floor(cy + 0.5) - h // 2
            rows["px"].append(gx + x0)
            rows["py"].append(gy + y0)
            rows["img"].append(render(gx + x0, gy + y0, *off))
            rows["xy0"].append((cx, cy))
            rows["fid"].append(e)
    B = E * N
    return dict(drz=drz.astype(np.float32),
                cut_px=np.asarray(rows["px"], np.float32),
                cut_py=np.asarray(rows["py"], np.float32),
                img=np.asarray(rows["img"], np.float32),
                msk=np.ones((B, h, h), bool),
                xy0=np.asarray(rows["xy0"], np.float32),
                jac=np.tile(np.eye(2, dtype=np.float32), (B, 1, 1)),
                w=np.ones(B, np.float32),
                fid=np.asarray(rows["fid"], np.int32))


@pytest.mark.parametrize("fitgeom", GEOMS)
def test_frames_fit_one_process_matches_jax(fitgeom):
    xy, uv, fid, w = _fit_scene()
    j = j_frames(xy, uv, jnp.asarray(fid), 3, wxy=w, fitgeom=fitgeom)
    t = iter_linear_fit_frames(torch.from_numpy(xy), torch.from_numpy(uv),
                               torch.from_numpy(fid), 3,
                               wxy=torch.from_numpy(w), fitgeom=fitgeom)
    _same_fit(t, j, _tol(fitgeom))
    # the outliers clipped, the zero weights left out
    assert t.nmatches.tolist() == [37, 37, 38]


@pytest.mark.parametrize("fitgeom", GEOMS)
def test_sharded_fit_one_process_matches_jax(fitgeom):
    """Without a group the sharded fit is the one-process fit; the JAX
    package's needs a mesh axis, so it runs under shard_map on one
    device."""
    xy, uv, _, w = _fit_scene()
    mesh = j_make_mesh(1)
    run = jax.jit(jax.shard_map(
        lambda a, b, c: tuple(j_sharded(a, b, c, "cutouts", fitgeom=fitgeom)),
        mesh=mesh, in_specs=(P("cutouts"),) * 3,
        out_specs=(P(),) * 6 + (P("cutouts"),)))
    j = run(xy, uv, w)
    t = iter_linear_fit_sharded(torch.from_numpy(xy), torch.from_numpy(uv),
                                torch.from_numpy(w), fitgeom=fitgeom)
    _same_fit(t, j, _tol(fitgeom))


def _tol(fitgeom):
    return FIT_TOL if fitgeom == "shift" else MATRIX_FIT_TOL


def _same_fit(t, j, tol):
    """``t``: the port's LinearFitResult (tensors or lists), ``j`` the JAX
    package's (or its tuple)."""
    def a(v):
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)

    np.testing.assert_allclose(a(t[1]), np.asarray(j[1]), atol=tol)
    np.testing.assert_allclose(a(t[0]), np.asarray(j[0]), atol=1e-6)
    np.testing.assert_allclose(a(t[2]), np.asarray(j[2]), atol=tol)
    np.testing.assert_array_equal(a(t[5]), np.asarray(j[5]))
    np.testing.assert_array_equal(a(t[6]) > 0, np.asarray(j[6]) > 0)


#: the program each rank runs: the functions of this file on its half
_RANK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from subpixal_tpu_torch.ops.fit import (iter_linear_fit_frames,
                                        iter_linear_fit_sharded)
from subpixal_tpu_torch.parallel import (init_distributed, make_mesh,
                                         make_sharded_align_step,
                                         pad_to_multiple,
                                         sharded_find_displacement,
                                         sharded_measure_and_fit,
                                         stage_global)

rank, world, addr, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
assert init_distributed(addr, world, rank, backend="gloo")
mesh = make_mesh(world, device="cpu")
z = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
out = {}


def tolist(res):
    return [v.tolist() for v in res]


local = out["local"] = {}  # this rank's final weights
for g in ("shift", "rscale", "general"):
    xy, uv, fid, w = (stage_global(z[k], mesh)
                      for k in ("xy", "uv", "fid", "w"))
    for key, fit in (
            ("frames_" + g, iter_linear_fit_frames(
                xy, uv, fid, 3, wxy=w, fitgeom=g, group=mesh.group)),
            ("sharded_" + g, iter_linear_fit_sharded(
                xy, uv, w, group=mesh.group, fitgeom=g))):
        out[key] = tolist(fit[:6])
        local[key] = fit.weights.tolist()
d = sharded_find_displacement(z["ref"], z["img"], mesh=mesh, cc_type="NCC",
                              usfac=4, fit_type="gaussian")
out["find"] = tolist(d)
d, fit = sharded_measure_and_fit(
    z["ref"], z["img"], z["mask"], z["mxy"], z["mw"], mesh=mesh, usfac=4,
    fit_type="gaussian", fitgeom="shift")
out["measure_fit"] = [tolist(d), tolist(fit)]
step = make_sharded_align_step(mesh, 2, usfac=4, fit_type="gaussian",
                               fitgeom="shift")
M, t, fit = step(torch.eye(2).repeat(2, 1, 1), torch.zeros(2, 2),
                 z["drz"], *(z[k] for k in ("cut_px", "cut_py", "simg",
                                            "msk", "xy0", "jac", "sw",
                                            "sfid")))
out["step"] = [M.tolist(), t.tolist(), tolist(fit)]
p, n = pad_to_multiple(torch.ones(5, 3), 2)
out["pad"] = [list(p.shape), n]
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Starts the two ranks on the shared inputs; ``wait()`` collects their
    results (the JAX side runs meanwhile)."""
    xy, uv, fid, w = _fit_scene()
    ref, img = _pairs()
    rng = np.random.default_rng(8)
    st = _step_scene()
    inputs = dict(xy=xy, uv=uv, fid=fid, w=w, ref=ref, img=img,
                  mask=(rng.random(ref.shape) > 0.02).astype(np.float32),
                  mxy=rng.uniform(10, 110, (9, 2)).astype(np.float32),
                  mw=np.ones(9, np.float32), drz=st["drz"],
                  cut_px=st["cut_px"], cut_py=st["cut_py"], simg=st["img"],
                  msk=st["msk"], xy0=st["xy0"], jac=st["jac"], sw=st["w"],
                  sfid=st["fid"])
    path = str(tmp_path_factory.mktemp("fit_ranks") / "inputs.npz")
    np.savez(path, **inputs)
    ranks = SpawnedRanks(_RANK, 2, args=(path,))
    cache = {}

    def wait():
        if not cache:
            outs = ranks.wait(timeout=240)
            res = [json.loads(next(ln for ln in o.splitlines()
                                   if ln.startswith("RESULT "))[7:])
                   for o in outs]
            # every rank returns the same global results; the final
            # weights of the fits are each rank's own half
            glob = [{k: v for k, v in r.items() if k != "local"}
                    for r in res]
            assert all(g == glob[0] for g in glob[1:])
            cache.update(res[0], local=[r["local"] for r in res])
        return cache

    yield inputs, wait
    ranks.kill()


def _jmesh2():
    return j_make_mesh(2)


@pytest.mark.parametrize("fitgeom", GEOMS)
def test_two_ranks_frames_and_sharded_fits_match_jax(two_ranks, fitgeom):
    z, wait = two_ranks
    spec = P("cutouts")
    frames = jax.jit(jax.shard_map(
        lambda a, b, f, c: tuple(j_frames(a, b, f, 3, wxy=c, fitgeom=fitgeom,
                                          axis_name="cutouts")),
        mesh=_jmesh2(), in_specs=(spec,) * 4,
        out_specs=(P(),) * 6 + (spec,)))
    sharded = jax.jit(jax.shard_map(
        lambda a, b, c: tuple(j_sharded(a, b, c, "cutouts", fitgeom=fitgeom)),
        mesh=_jmesh2(), in_specs=(spec,) * 3,
        out_specs=(P(),) * 6 + (spec,)))
    jf = frames(z["xy"], z["uv"], jnp.asarray(z["fid"]), z["w"])
    js = sharded(z["xy"], z["uv"], z["w"])
    got = wait()
    for key, j in (("frames_", jf), ("sharded_", js)):
        w = sum((r[key + fitgeom] for r in got["local"]), [])  # rank order
        _same_fit(got[key + fitgeom] + [w], j, _tol(fitgeom))


def test_two_ranks_sharded_find_displacement_matches_jax(two_ranks):
    z, wait = two_ranks
    j = j_sfd(z["ref"], z["img"], mesh=_jmesh2(), cc_type="NCC", usfac=4,
              fit_type="gaussian")
    t = wait()["find"]
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a, np.asarray(b), atol=MEAS_TOL)
    np.testing.assert_array_equal(t[3], np.asarray(j.fit_ok))
    assert len(t[0]) == 9  # the padded row is stripped


def test_two_ranks_sharded_measure_and_fit_matches_jax(two_ranks):
    z, wait = two_ranks
    jd, jfit = j_smf(z["ref"], z["img"], z["mask"], z["mxy"], z["mw"],
                     mesh=_jmesh2(), usfac=4, fit_type="gaussian",
                     fitgeom="shift")
    td, tfit = wait()["measure_fit"]
    np.testing.assert_allclose(td[0], np.asarray(jd.dx), atol=MEAS_TOL)
    _same_fit(tfit, jfit, tol=MEAS_TOL)


def test_two_ranks_sharded_align_step_matches_jax(two_ranks):
    """The multi-device step (blot, measure, per-frame fits, compose)."""
    z, wait = two_ranks
    step = j_step(_jmesh2(), 2, usfac=4, fit_type="gaussian",
                  fitgeom="shift")
    jM, jt, jfit = step(jnp.tile(jnp.eye(2)[None], (2, 1, 1)),
                        jnp.zeros((2, 2)), z["drz"],
                        *(jnp.asarray(z[k]) for k in (
                            "cut_px", "cut_py", "simg", "msk", "xy0", "jac",
                            "sw", "sfid")))
    tM, tt, tfit = wait()["step"]
    np.testing.assert_allclose(tt, np.asarray(jt), atol=MEAS_TOL)
    np.testing.assert_allclose(tM, np.asarray(jM), atol=1e-6)
    _same_fit(tfit, jfit, tol=MEAS_TOL)
    assert np.abs(np.asarray(tt)).max() > 0.05  # the planted offsets
    assert wait()["pad"] == [[6, 3], 1]
