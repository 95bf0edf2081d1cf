"""Port parity: public names and parameters that the port carries from
the JAX package (``simulate_stack``'s ``star_box`` and ``device``,
``wcs.fit_wcs_offset``, ``Table.copy``, ``init_distributed``'s
``local_device_ids`` and the exported ``find_displacement``'s
parameters).

The host paths are numpy in both packages and must agree EXACTLY on the
same inputs. The device render of ``simulate_stack`` evaluates each star
patch in float32 where the host render takes float64, so its frames are
held to the JAX package's device render and to the host render within
``RENDER_TOL``: a few float32 ulps of the star amplitude.
"""

import numpy as np
import pytest
import torch

import subpixal_tpu
import subpixal_tpu_torch
from subpixal_tpu.cc import find_displacement as j_find_displacement
from subpixal_tpu.catalogs import Table as JTable
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import DistGrid as JDistGrid
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu.wcs.wcs import fit_wcs_offset as j_fit_wcs_offset
from subpixal_tpu_torch.catalogs import Table
from subpixal_tpu_torch.convert import wcs_from_reference
from subpixal_tpu_torch.testing import SpawnedRanks, simulate_stack
from subpixal_tpu_torch.wcs import fit_wcs_offset

torch.set_num_threads(2)

AMP = 25.0
#: float32 rounding of the patch offsets and exponent, at the amplitude
RENDER_TOL = 8 * float(np.spacing(np.float32(AMP)))
#: tests/test_torch_correlate.py's bar for the float32 FFT pipelines
SHIFT_TOL = 2e-4

_SCENE = dict(n_exp=3, shape=(96, 128), n_stars=6, seed=3, amp=AMP)
_BOXES = [None, (20, 60, 30, 50)]


@pytest.mark.parametrize("star_box", _BOXES)
def test_simulate_stack_host_frames_equal_jax(star_box):
    """The host render, with and without star_box, is the JAX package's
    draw for draw: equal frames, planted shifts and WCSs."""
    je, jp = j_simulate(star_box=star_box, **_SCENE)
    te, tp = simulate_stack(star_box=star_box, **_SCENE)
    assert tp == jp
    for a, b in zip(je, te):
        assert isinstance(b.data, np.ndarray) and b.name == a.name
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.wcs.crpix, a.wcs.crpix)
        np.testing.assert_array_equal(b.wcs.cd, a.wcs.cd)
    if star_box is not None:
        # every star peak inside the box (each frame's brightest pixels)
        frame = te[0].data
        ys, xs = np.nonzero(frame > 0.5 * AMP)
        x0, x1, y0, y1 = star_box
        assert xs.size and (xs >= x0 - 2).all() and (xs <= x1 + 2).all()
        assert (ys >= y0 - 2).all() and (ys <= y1 + 2).all()


@pytest.mark.parametrize("star_box", _BOXES)
def test_simulate_stack_device_render_matches_jax(star_box):
    """simulate_stack(device='cpu', noise=0) against the JAX package's
    device=True render and against the port's own host render: within
    RENDER_TOL; planted identical in every mode; tensors on the device."""
    jd, jp = j_simulate(star_box=star_box, device=True, noise=0.0, **_SCENE)
    td, tp = simulate_stack(star_box=star_box, device="cpu", noise=0.0,
                            **_SCENE)
    th, hp = simulate_stack(star_box=star_box, noise=0.0, **_SCENE)
    assert tp == jp == hp
    for a, b, c in zip(jd, td, th):
        assert isinstance(b.data, torch.Tensor)
        assert b.data.dtype == torch.float32
        assert tuple(b.data.shape) == _SCENE["shape"]
        np.testing.assert_allclose(b.data.numpy(), np.asarray(a.data),
                                   rtol=0, atol=RENDER_TOL)
        np.testing.assert_allclose(b.data.numpy(), c.data, rtol=0,
                                   atol=RENDER_TOL)
        assert float(b.data.max()) > 0.5 * AMP


def test_simulate_stack_device_noise_and_modes(monkeypatch):
    """With noise, the device render's pixels differ from the host's by
    their noise only (the same seed draws the same device noise), and
    planted is the same; device=True without CUDA raises, and
    device=False is the host render."""
    kw = dict(_SCENE, noise=0.5)
    a, pa = simulate_stack(device=torch.device("cpu"), **kw)
    b, pb = simulate_stack(device="cpu", **kw)
    h, ph = simulate_stack(device=False, **kw)
    assert pa == pb == ph
    for x, y, z in zip(a, b, h):
        assert torch.equal(x.data, y.data)
        resid = x.data.numpy() - z.data
        assert 0.6 < float(resid.std()) < 0.8  # two N(0, 0.5) fields
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        simulate_stack(device=True, **kw)


def _make_wcs(crpix):
    """tests/test_wcs.py's make_wcs (TAN, 0.05"/px, rotated 15 deg)."""
    s = 0.05 / 3600.0
    th = np.deg2rad(15.0)
    cd = s * np.array([[-np.cos(th), np.sin(th)], [np.sin(th), np.cos(th)]])
    return JTanWCS(crpix=np.array(crpix, float),
                   crval=np.array([150.0, 2.3]), cd=cd)


def _smooth_grid(gh, gw, amp, seed):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:gh, 0:gw].astype(float)
    gy /= gh - 1
    gx /= gw - 1
    return amp * (np.sin(2.1 * np.pi * gx + rng.uniform(0, 1))
                  * np.cos(1.7 * np.pi * gy + rng.uniform(0, 1)))


def _table_wcs(amp=0.1, seed=5):
    """tests/test_wcs.py's table-distorted WCS (SIP plus a cpdis grid)."""
    cd = (0.05 / 3600.0) * np.array([[-0.9998, 0.02], [0.021, 1.0001]])
    a = np.zeros((4, 4))
    a[0, 2], a[2, 0] = 1e-7, -2e-7
    b = np.zeros((4, 4))
    b[0, 2] = -1e-7
    cpdis = JDistGrid(
        data_x=_smooth_grid(16, 16, amp, seed),
        data_y=_smooth_grid(16, 16, amp, seed + 1),
        crpix=(0.0, 0.0), crval=(0.0, 0.0), cdelt=(1024 / 15, 1024 / 15))
    return JTanWCS(crpix=np.array([512.0, 512.0]),
                   crval=np.array([150.0, 2.0]), cd=cd, a=a, b=b,
                   cpdis=cpdis)


@pytest.mark.parametrize("case", ["cross_frame", "table_distortion"])
def test_fit_wcs_offset_equals_jax(case):
    """tests/test_wcs.py's two fit_wcs_offset cases (test_fit_wcs_offset_
    cross_frame and test_table_distortion_offset_recovery), exactly."""
    if case == "cross_frame":
        wa, wb = _make_wcs((100, 100)), _make_wcs((90, 105))
        x, y = np.array([50.0]), np.array([60.0])
    else:
        wa = _table_wcs()
        wb = wa.with_shifted_crpix(0.37, -0.21)
        x = np.linspace(40, 980, 12)
        y = np.linspace(40, 980, 12)
    want = j_fit_wcs_offset(wa, wb, x, y)
    got = fit_wcs_offset(wcs_from_reference(wa), wcs_from_reference(wb), x, y)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if case == "cross_frame":
        np.testing.assert_allclose(got[0], [40.0], atol=1e-8)
        np.testing.assert_allclose(got[1], [65.0], atol=1e-8)
    assert "fit_wcs_offset" in subpixal_tpu_torch.wcs.__all__


def test_table_copy_is_independent():
    """Table.copy copies every column: writes to either table leave the
    other as it was, in both packages alike."""
    cols = dict(id=np.arange(4), flux=np.array([1.0, 2.0, 3.0, 4.0]))
    for cls in (JTable, Table):
        t = cls({k: v.copy() for k, v in cols.items()})
        c = t.copy()
        assert isinstance(c, cls) and c.colnames == t.colnames
        c["flux"][0] = -1.0
        t["id"][1] = 99
        assert t["flux"][0] == 1.0 and c["id"][1] == 1
        c["extra"] = np.zeros(4)
        assert "extra" not in t
    from subpixal_tpu_torch import catalogs_device

    assert catalogs_device.Table is Table


_RANK = r"""
import json, sys
import torch
from subpixal_tpu_torch.parallel import init_distributed, process_info

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert init_distributed(addr, world, rank, local_device_ids=None,
                        backend="gloo")
t = torch.tensor([float(rank + 1)])
torch.distributed.all_reduce(t)
print("RESULT " + json.dumps(dict(info=process_info(), sum=float(t))),
      flush=True)
"""


def test_init_distributed_takes_local_device_ids_none():
    """Two spawned gloo ranks join through init_distributed(...,
    local_device_ids=None) (before, the name fell through to
    init_process_group and raised TypeError)."""
    import json

    outs = SpawnedRanks(_RANK, 2).wait(timeout=120)
    recs = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]
    assert [r["info"] for r in recs] == [[0, 2], [1, 2]]
    assert all(r["sum"] == 3.0 for r in recs)


@pytest.mark.parametrize("ids,match", [([0, 1], "one device"),
                                       ((0, 1, 2), "one device"),
                                       (0, "CUDA"), ([0], "CUDA")])
def test_init_distributed_local_device_ids_refused(ids, match, monkeypatch):
    """More than one id raises (a rank drives one device), and so does an
    id on a machine without CUDA; nothing is joined."""
    import torch.distributed as dist

    from subpixal_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=match):
        init_distributed("127.0.0.1:1", 2, 0, local_device_ids=ids)
    assert not dist.is_initialized()


@pytest.mark.parametrize("ids", [1, [1], (1,)])
def test_init_distributed_local_device_ids_single_process(ids, monkeypatch):
    """In a single-process run (no coordinator) the named device still
    becomes the current one, and no group is joined."""
    import torch.distributed as dist

    from subpixal_tpu_torch.parallel import init_distributed

    for k in ("SUBPIXAL_TPU_COORDINATOR", "SUBPIXAL_TPU_NUM_PROCESSES",
              "SUBPIXAL_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert init_distributed(local_device_ids=ids) is False
    assert current == [torch.device("cuda", 1)]
    assert not dist.is_initialized()
    current.clear()
    assert init_distributed(local_device_ids=None) is False
    assert current == []


def _pairs(n=32, B=4, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    ref = np.zeros((B, n, n), np.float32)
    img = np.zeros((B, n, n), np.float32)
    for b in range(B):
        dx, dy = rng.uniform(-1.5, 1.5, 2)
        x0, y0 = rng.uniform(0.35 * n, 0.65 * n, 2)
        ref[b] = 9 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 8)
        img[b] = 9 * np.exp(-((xx - x0 - dx) ** 2 + (yy - y0 - dy) ** 2) / 8)
    mask = np.ones((B, n, n), bool)
    mask[:, :2] = False
    return ref, img, mask


@pytest.mark.parametrize("usfac,search", [(1, "fitbox"), (8, "fitbox"),
                                          (8, None), (10, 9)])
def test_exported_find_displacement_parameters_match_jax(usfac, search):
    """The exported find_displacement takes the reference's parameters by
    name and in order: every one given by keyword, and the first three
    positionally, against subpixal_tpu.cc.find_displacement."""
    import jax.numpy as jnp

    ref, img, mask = _pairs()
    kw = dict(usfac=usfac, peak_fit_box=5, fit_type="gaussian",
              peak_search_box=search)
    want = j_find_displacement(
        jnp.asarray(ref), jnp.asarray(img), cc_type="NCC",
        ref_mask=jnp.asarray(mask), img_mask=jnp.asarray(mask), **kw)
    tm = torch.from_numpy(mask)
    for got in (
            subpixal_tpu_torch.find_displacement(
                ref=torch.from_numpy(ref), img=torch.from_numpy(img),
                cc_type="NCC", ref_mask=tm, img_mask=tm, **kw),
            subpixal_tpu_torch.find_displacement(
                torch.from_numpy(ref), torch.from_numpy(img), "NCC",
                ref_mask=tm, img_mask=tm, **kw)):
        np.testing.assert_array_equal(got.fit_ok.numpy(),
                                      np.asarray(want.fit_ok))
        np.testing.assert_allclose(got.dx.numpy(), np.asarray(want.dx),
                                   atol=SHIFT_TOL)
        np.testing.assert_allclose(got.dy.numpy(), np.asarray(want.dy),
                                   atol=SHIFT_TOL)
    assert subpixal_tpu.find_displacement is j_find_displacement
