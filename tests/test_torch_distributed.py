"""Port parity: ``parallel.distributed`` on ``torch.distributed``.

Mirrors tests/test_distributed.py. A real 2-process gloo group (spawned
processes that import only torch and the port) joins through the
``SUBPIXAL_TPU_*`` environment variables, gathers each rank's half of a
displacement batch, and runs the sharded sigma-clipped fit over the
group: the result must agree with the single-process fit of both
packages. A lone process builds its one-rank mesh on an in-memory store.
This process itself never joins a group: ``init_distributed()`` with no
arguments and no variables is a no-op.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subpixal_tpu.ops.fit import iter_linear_fit as j_fit
from subpixal_tpu_torch.ops.fit import iter_linear_fit
from subpixal_tpu_torch.parallel import init_distributed, process_info
from subpixal_tpu_torch.testing import SpawnedRanks

ENV = ("SUBPIXAL_TPU_COORDINATOR", "SUBPIXAL_TPU_NUM_PROCESSES",
       "SUBPIXAL_TPU_PROCESS_ID")


def _scene(seed=4):
    """tests/test_distributed.py's matched positions: a planted affine and
    two outliers the clip must reject globally."""
    rng = np.random.default_rng(seed)
    N = 48
    uv = rng.uniform(0, 200, (N, 2))
    M = np.array([[1.0005, -3e-4], [2.5e-4, 0.9996]])
    t = np.array([0.31, -0.22])
    xy = uv @ M.T + t + rng.normal(0, 0.005, (N, 2))
    xy[3] += 8.0
    xy[17] -= 6.0
    return xy.astype(np.float32), uv.astype(np.float32), np.ones(N, np.float32)


#: a rank of the 2-process group: joins through the environment variables
_ENV_RANK = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
rank, world, addr, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
os.environ["SUBPIXAL_TPU_COORDINATOR"] = addr[len("tcp://"):]
os.environ["SUBPIXAL_TPU_NUM_PROCESSES"] = str(world)
os.environ["SUBPIXAL_TPU_PROCESS_ID"] = str(rank)
from subpixal_tpu_torch.ops.fit import iter_linear_fit_sharded
from subpixal_tpu_torch.parallel import (global_batch_from_local,
                                         init_distributed, make_global_mesh,
                                         process_info, stage_global)

assert init_distributed(backend="gloo") is True
assert init_distributed() is True  # idempotent
mesh = make_global_mesh()
z = np.load(path)
N = len(z["w"])
lo, hi = rank * N // world, (rank + 1) * N // world
xy = global_batch_from_local(z["xy"][lo:hi], mesh)
uv = global_batch_from_local(z["uv"][lo:hi], mesh)
w = global_batch_from_local(z["w"][lo:hi], mesh)
xy_l, uv_l, w_l = (stage_global(a, mesh) for a in (xy, uv, w))
fit = iter_linear_fit_sharded(xy_l, uv_l, w_l, group=mesh.group())
print("RESULT " + json.dumps(dict(
    info=list(process_info()), size=mesh.size, rank=mesh.rank,
    device=str(mesh.device), gathered=bool(np.array_equal(xy.numpy(),
                                                          z["xy"])),
    staged=bool(np.array_equal(xy_l.numpy(), z["xy"][lo:hi])),
    matrix=fit.matrix.tolist(), shift=fit.shift.tolist(),
    nmatches=int(fit.nmatches), weights=fit.weights.tolist())), flush=True)
"""

#: a lone process: its one-rank mesh on an in-memory store
_LONE = r"""
import json, sys
import torch
import torch.distributed as dist
from subpixal_tpu_torch.parallel import (init_distributed, make_mesh,
                                         process_info)

assert init_distributed() is False and process_info() == (0, 1)
try:
    make_mesh(2, device="cpu")
    raise SystemExit("make_mesh(2) in a lone process did not raise")
except ValueError:
    pass
mesh = make_mesh(1, device="cpu")
t = torch.arange(3.0)
dist.all_reduce(t, group=mesh.group())
print("RESULT " + json.dumps(dict(
    backend=dist.get_backend(), size=mesh.size, shape=mesh.shape,
    devices=int(mesh.devices.size), again=init_distributed(),
    sum=t.tolist())), flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 2-process group and the lone process together."""
    xy, uv, w = _scene()
    path = str(tmp_path_factory.mktemp("dist") / "scene.npz")
    np.savez(path, xy=xy, uv=uv, w=w)
    env = SpawnedRanks(_ENV_RANK, 2, args=(path,))
    lone = SpawnedRanks(_LONE, 1)
    cache = {}

    def result(name):
        if name not in cache:
            ranks = dict(env=env, lone=lone)[name]
            cache[name] = [json.loads(next(
                ln for ln in o.splitlines() if ln.startswith("RESULT "))[7:])
                for o in ranks.wait(timeout=180)]
        return cache[name]

    yield (xy, uv, w), result
    env.kill()
    lone.kill()


def test_init_distributed_noop_single_process(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert init_distributed() is False
    assert not dist.is_initialized() and process_info() == (0, 1)
    with pytest.raises(ValueError, match="process"):
        init_distributed("127.0.0.1:1")  # no count, no id: nothing joined
    assert not dist.is_initialized()


def test_two_process_psum_fit_matches_single_process(runs):
    (xy, uv, w), result = runs
    ref = j_fit(xy, uv, wxy=w, fitgeom="general", nclip=3, sigma=3.0)
    one = iter_linear_fit(torch.from_numpy(xy), torch.from_numpy(uv),
                          torch.from_numpy(w))
    got = result("env")
    for r in got:
        np.testing.assert_allclose(r["matrix"], np.asarray(ref.matrix),
                                   atol=2e-5)
        np.testing.assert_allclose(r["shift"], np.asarray(ref.shift),
                                   atol=2e-3)
        np.testing.assert_allclose(r["matrix"], one.matrix.numpy(),
                                   atol=2e-5)
        # the planted outliers were clipped globally, not per shard
        assert r["nmatches"] == int(ref.nmatches) == int(one.nmatches) == 46
    assert got[0]["matrix"] == got[1]["matrix"]
    weights = got[0]["weights"] + got[1]["weights"]
    np.testing.assert_array_equal(np.asarray(weights) > 0,
                                  np.asarray(ref.weights) > 0)


def test_env_variable_path_and_global_batch(runs):
    """The ranks joined through the variables alone; each gathered the
    whole batch from the halves and staged its own block back."""
    _, result = runs
    for rank, r in enumerate(result("env")):
        assert r["info"] == [rank, 2] and (r["rank"], r["size"]) == (rank, 2)
        assert r["device"] == "cpu"
        assert r["gathered"] and r["staged"]


def test_lone_process_mesh_on_an_in_memory_store(runs):
    _, result = runs
    (r,) = result("lone")
    assert r["backend"] == "gloo" and r["size"] == 1 and r["devices"] == 1
    assert r["shape"] == {"cutouts": 1} and r["again"] is True
    assert r["sum"] == [0.0, 1.0, 2.0]
