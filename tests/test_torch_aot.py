"""The port's program cache (``aot``) and its programs vs the JAX package's.

On the CPU ``aot.get_executable`` returns the plain function with its
statics bound, keyed as on a card: one parametrised test holds the key
to each of its fields (the name, each tensor's shape, dtype and device,
the statics, ``key_extra``, the source fingerprint, the matmul
precision) and the LRU to its refresh and its eviction at ``_MEM_MAX``.

Each program's core, called through the port's ``get_executable``, is
held to the JAX package's program, called through
``subpixal_tpu.aot.get_executable`` on the CPU (its Pallas deposit in
interpret mode), on the same seeded numpy inputs:

* ``deposit_stack``: planes and sums within ``STACK_TOL`` relative to the
  largest value (each package's float32 device pixmaps lie a few 1e-6 px
  apart; ``tests/test_torch_resample.py``'s bar);
* ``cutout_pixmaps_stack``: within ``DEV_TOL`` px at coordinates below
  512 px (three float32 ulps there: the same float32 composition, which
  XLA fuses; ``tests/test_torch_pixmaps.py``'s bar);
* ``device_stage``: masks and segmentation masks equal, and the cutouts
  where their masks hold (a cutout lying more than its size off the
  frame takes clamped pixels in the JAX package, zeros in the port,
  under an all-False mask);
* ``cat_count`` / ``cat_count_thr``: counts equal, the threshold within
  ``STATS_RTOL`` (XLA's float32 prefix sums and torch's associate
  differently); ``cat_peaks`` / ``cat_find``: the packed tables' flags,
  areas, bboxes, peak pixels and counts equal, positions within
  ``POS_TOL`` px and fluxes within ``FLUX_RTOL`` (the port sums the
  moments in float64), rank planes equal; ``cat_remap`` equal;
* ``render_stack``: frames within ``RENDER_RTOL`` of each other, element
  by element, with the noise off (the noise streams are the packages' own
  generators; XLA and torch round the float32 Gaussians' squares and
  ``exp`` in their own ways), stars at the right and bottom edges among
  them, whose cells off the frame both packages drop.

The finder, whose floods now run in blocks with a device flag
(``aot.repeat_until``), is held to the JAX finder's tables through both
of its stages' programs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subpixal_tpu.aot as JAOT
import subpixal_tpu.blot as JB
from subpixal_tpu import align as JA
from subpixal_tpu import testing as JT
from subpixal_tpu.catalogs import device as JC
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import _precision, aot
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch import blot as TB
from subpixal_tpu_torch import catalogs_device as TC
from subpixal_tpu_torch import resample as R
from subpixal_tpu_torch import testing as TT
from subpixal_tpu_torch.convert import (exposures_from_reference,
                                        wcs_from_reference)
from test_torch_catalogs_device import SCENES, _assert_same

torch.set_num_threads(2)

STACK_TOL = 1e-4
DEV_TOL = 1e-4
STATS_RTOL = 1e-5
POS_TOL = 1e-4
FLUX_RTOL = 1e-5
RENDER_RTOL = 2e-6


@pytest.fixture
def mem(monkeypatch):
    """An empty program cache for the test."""
    monkeypatch.setattr(aot, "_MEM", {})
    return aot._MEM


def _prog(x, y=None, *, k=1):
    return x * k if y is None else x * k + y


_BASE = dict(name="p", args=(torch.zeros(3, 4),), statics={"k": 2},
             key_extra=())


def _other(field):
    """The base call with one field of its key changed."""
    call = dict(_BASE)
    if field == "name":
        call["name"] = "q"
    elif field == "shape":
        call["args"] = (torch.zeros(3, 5),)
    elif field == "dtype":
        call["args"] = (torch.zeros(3, 4, dtype=torch.float64),)
    elif field == "device":
        call["args"] = (torch.zeros(3, 4, device="meta"),)
    elif field == "statics":
        call["statics"] = {"k": 3}
    elif field == "key_extra":
        call["key_extra"] = ("x",)
    return call


def _get(call, timings=None):
    return aot.get_executable(call["name"], _prog, call["args"],
                              statics=call["statics"],
                              key_extra=call["key_extra"], timings=timings)


@pytest.mark.parametrize("field", ["name", "shape", "dtype", "device",
                                   "statics", "key_extra", "fingerprint",
                                   "precision", "refresh", "evict"])
def test_get_executable_keys_and_lru(mem, monkeypatch, field):
    """The same call is a hit (the same executable, no new timing); a
    change of any one field of the key is a miss that records its
    ``{name}.compile`` and leaves the first entry cached; the LRU keeps
    ``_MEM_MAX`` entries, refreshed on a hit, dropping the oldest."""
    t = {}
    first = _get(_BASE, t)
    assert isinstance(first, functools.partial)
    assert first.keywords == {"k": 2} and "p.compile" in t
    t.clear()
    assert _get(_BASE, t) is first and not t
    if field in ("refresh", "evict"):
        monkeypatch.setattr(aot, "_MEM_MAX", 4)
        fill = [dict(_BASE, name=f"f{i}") for i in range(3)]
        for c in fill:
            _get(c)
        assert len(mem) == 4
        if field == "refresh":
            assert _get(_BASE) is first       # now the newest
        _get(dict(_BASE, name="new"))
        assert len(mem) == 4
        kept = _get(_BASE) is first
        assert kept == (field == "refresh")
        return
    if field == "fingerprint":
        monkeypatch.setattr(aot, "code_fingerprint", lambda: "another")
        other = _get(_BASE, t)
    elif field == "precision":
        assert _precision.matmul_precision()[1]  # cuDNN may take TF32
        with _precision.full_f32():
            other = _get(_BASE, t)
    else:
        other = _get(_other(field), t)
    assert other is not first
    assert f"{'q' if field == 'name' else 'p'}.compile" in t
    assert len(mem) == 2
    if field != "fingerprint":
        assert _get(_BASE) is first


def test_programs_evicted_past_their_share_of_card_memory(mem,
                                                          monkeypatch):
    """Captured programs on one card hold at most ``_MEM_MAX_SHARE`` of
    its memory: past it the oldest of that card's go (the newest stays,
    however large), other cards' programs and plain functions stay."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=1000))
    monkeypatch.setattr(aot, "_MEM_MAX_SHARE", 0.5)

    def prog(nbytes, dev="cuda:0"):
        return types.SimpleNamespace(nbytes=nbytes, dev=torch.device(dev))

    mem.update(a=prog(200), other=prog(400, "cuda:1"), plain=_prog,
               b=prog(200))
    aot._evict()
    assert list(mem) == ["a", "other", "plain", "b"]  # 400 of 500
    mem["c"] = prog(200)
    aot._evict()
    assert list(mem) == ["other", "plain", "b", "c"]
    mem["d"] = prog(900)
    aot._evict()
    assert list(mem) == ["other", "plain", "d"]


def test_cpu_executable_is_the_plain_function(mem):
    """On CPU tensors the executable is the function with its statics
    bound: the same result as a plain call, nothing captured."""
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    exe = aot.get_executable("p", _prog, (a, b), statics={"k": 3})
    assert torch.equal(exe(a, b), _prog(a, b, k=3))


def test_aot_switches_and_dir(monkeypatch, tmp_path):
    """``SUBPIXAL_TPU_AOT_LOOP`` turns the capture on and off as the JAX
    package's switch does; ``SUBPIXAL_TPU_AOT_DIR`` moves the builds."""
    for v, want in (("0", False), ("off", False), ("1", True),
                    ("true", True)):
        monkeypatch.setenv("SUBPIXAL_TPU_AOT_LOOP", v)
        assert aot.aot_enabled() is want
    monkeypatch.delenv("SUBPIXAL_TPU_AOT_LOOP")
    assert aot.aot_enabled() == torch.cuda.is_available()
    monkeypatch.setenv("SUBPIXAL_TPU_AOT_DIR", str(tmp_path / "b"))
    assert aot.aot_dir() == str(tmp_path / "b") and (tmp_path / "b").is_dir()
    from subpixal_tpu_torch.kernels import _build

    assert _build.library_path("blot_gather").startswith(str(tmp_path))
    fp = aot.code_fingerprint()
    assert len(fp) == 16 and fp == aot.code_fingerprint()


@pytest.mark.parametrize("max_blocks", [None, 2])
def test_repeat_until_reads_once_a_block(max_blocks):
    """Eagerly, ``repeat_until`` runs the block until its flag holds (or
    ``max_blocks`` times): one host read a block."""
    x = torch.zeros(())
    done = torch.zeros((), dtype=torch.bool)
    runs = []

    def block():
        runs.append(1)
        x.add_(1)
        done.copy_(x >= 5)

    aot.repeat_until(block, done, max_blocks)
    assert len(runs) == (5 if max_blocks is None else 2)


# --------------------------------------------------------------------- #
# the programs against the JAX package's
# --------------------------------------------------------------------- #

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_deposit_stack_matches_jax(mem, monkeypatch):
    """``deposit_stack`` (pixmaps, B1's per-plane plain version, scales,
    sums) against the JAX package's one-program stacked execute."""
    monkeypatch.setattr(JB, "device_pixmap_min_pixels", lambda: 1)
    jexps, _ = j_simulate(n_exp=3, shape=(96, 96), n_stars=6, seed=3)
    for k, e in enumerate(jexps):
        e.exptime = 50.0 + 25.0 * k
        e.weight = (np.random.default_rng(k).random((96, 96)) > 0.1
                    ).astype(np.float32)
    jd = JDrizzle([e.copy() for e in jexps], use_pallas=False)
    jd._ensure_output_grid()
    jd._warm_combine()
    want = [np.asarray(a) for a in jd._execute_stack(jd._shared_tile(),
                                                      _interpret=True)]
    texps = exposures_from_reference(jexps)
    td = R.Drizzle(texps, device="cpu")
    td._ensure_output_grid()
    scales, whts = zip(*(R._weight_parts(e, td.wht_type) for e in texps))
    data = R._stack_planes([R.exposure_rate_data(e) for e in texps],
                           (96, 96), "cpu")
    wht = R._stack_planes([1.0 if w is None else w for w in whts], (96, 96),
                          "cpu")
    params, modes = TB._stacked_wcs_params([e.wcs for e in texps], td._owcs,
                                           "cpu")
    sc = torch.tensor(scales, dtype=torch.float32)
    ratios = tuple(round(float(e.wcs.pscale / td._owcs.pscale), 6)
                   for e in texps)
    args = (params, data, wht, sc)
    got = aot.get_executable(
        "deposit_stack", R._deposit_stack_core, args,
        statics=dict(shape=(96, 96), modes=modes, oshape=tuple(td._oshape),
                     pixfrac=1.0, kernel="square", ratios=ratios,
                     use_pallas="auto"))(*args)
    assert tuple(td._oshape) == tuple(jd._oshape)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) < STACK_TOL
    assert float(want[1].sum()) > 0


def _stack_wcss():
    a = np.zeros((3, 3))
    a[0, 2], a[2, 0] = 1e-7, -2e-7
    cd = (0.05 / 3600.0) * np.array([[-0.9998, 0.02], [0.021, 1.0001]])
    ws = [JTanWCS(crpix=np.array([256.0 + e, 250.0 - 0.3 * e]),
                  crval=np.array([150.0, 2.0]), cd=cd, a=a, b=-a)
          for e in range(3)]
    ref = JTanWCS(crpix=np.array([260.0, 249.0]),
                  crval=np.array([150.0005, 2.0003]),
                  cd=(0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]]))
    return ws, ref


def test_cutout_pixmaps_stack_matches_jax(mem):
    ws, ref = _stack_wcss()
    blc = np.random.default_rng(2).uniform(0, 300, (3, 5, 2)).astype(
        np.float32)
    jx, jy = JB.compute_cutout_pixmaps_device_stack(ws, ref, blc, (16, 24))
    params, modes = TB._stacked_wcs_params(
        [wcs_from_reference(w) for w in ws], wcs_from_reference(ref), "cpu")
    blc_t = torch.from_numpy(blc)
    tx, ty = aot.get_executable(
        "cutout_pixmaps_stack", TB._cutout_pixmaps_stack_core,
        (params, blc_t), statics=dict(shape=(16, 24), modes=modes))(
            params, blc_t)
    assert tuple(tx.shape) == (3, 5, 16, 24) == np.shape(jx)
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) < DEV_TOL
    assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) < DEV_TOL


@pytest.mark.parametrize("use_seg", [True, False])
def test_device_stage_matches_jax(mem, use_seg):
    """``device_stage``: cutouts (some off the frame), masks and the
    segmentation masks of two catalogs' planes, one catalog without
    segmentation."""
    rng = np.random.default_rng(7)
    E, N, C, H, W, cut = 2, 6, 2, 40, 48, (8, 10)
    inputs = (
        rng.normal(0, 1, (E, H, W)).astype(np.float32),
        np.concatenate([rng.uniform(2, 46, (E, N - 1, 2)),
                        np.full((E, 1, 2), -20.0)], 1).astype(np.float32),
        rng.integers(0, 5, (C, H, W)).astype(np.float32),
        rng.uniform(-3, 50, (E, N) + cut).astype(np.float32),
        rng.uniform(-3, 42, (E, N) + cut).astype(np.float32),
        rng.integers(1, 5, N).astype(np.float32),
        rng.integers(0, C, N).astype(np.int32),
        np.array([True, True, False, True, True, True]))
    want = JA._stage_device_inputs_aot(*(jnp.asarray(a) for a in inputs),
                                       cut_shape=cut, use_seg=use_seg)
    got = TA._stage_device_inputs_aot(*(torch.from_numpy(a) for a in inputs),
                                      cut_shape=cut, use_seg=use_seg)
    mask = got[1].numpy()
    np.testing.assert_array_equal(mask, np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy()[mask],
                                  np.asarray(want[0])[mask])
    assert not mask[:, -1].any() and not got[0][:, -1].any()
    if use_seg:
        assert 0 < float(got[2].mean()) < 1


def _j_exe(name, fn, args, **statics):
    exe = JAOT.get_executable(name, fn, args, statics=statics)
    return exe if exe is not None else functools.partial(fn, **statics)


def _t_exe(name, fn, args, **statics):
    return aot.get_executable(name, fn, args, statics=statics)


@pytest.mark.parametrize("scene", ["field", "crowded"])
def test_counting_programs_match_jax(mem, scene):
    img = SCENES[scene]()
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    jc, jthr = _j_exe("cat_count", JC._count_candidates_auto, (jimg,),
                      nsigma=3.0, npixels=5)(jimg)
    tc, tthr = _t_exe("cat_count", TC._count_candidates_auto, (timg,),
                      nsigma=3.0, npixels=5)(timg)
    assert int(tc) == int(jc) > 0
    assert abs(float(tthr) - float(jthr)) <= STATS_RTOL * abs(float(jthr))
    thr = np.float32(jthr)
    jn = _j_exe("cat_count_thr", JC._count_candidates,
                (jimg, jnp.asarray(thr)), npixels=5)(jimg, jnp.asarray(thr))
    tn = _t_exe("cat_count_thr", TC._count_candidates,
                (timg, torch.tensor(thr)), npixels=5)(timg, torch.tensor(thr))
    assert int(tn) == int(jn) == int(jc)


def _same_packed(t, j):
    t, j = t.numpy(), np.asarray(j)
    exact = [0, 1, 6, 7, 8, 9, 10, 11, 12, 13]
    np.testing.assert_array_equal(t[exact], j[exact])
    keep = j[0] > 0
    assert keep.any()
    assert np.abs(t[3:5][:, keep] - j[3:5][:, keep]).max() < POS_TOL
    np.testing.assert_allclose(t[2][keep], j[2][keep], rtol=FLUX_RTOL)
    np.testing.assert_allclose(t[5], j[5], rtol=FLUX_RTOL, atol=FLUX_RTOL)


@pytest.mark.parametrize("scene,B", [("field", 128), ("crowded", 64)])
def test_peaks_programs_match_jax(mem, scene, B):
    """``cat_peaks`` at the two-stage finder's bucket, ``cat_find`` (the
    threshold derived inside) and ``cat_remap``, as ``_peaks_executables``
    gives them."""
    img = SCENES[scene]()
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    kw = dict(nsigma=3.0, npixels=5, window=32, max_sources=B,
              deblend_nthresh=32, deblend_cont=0.005)
    jf, jp, jr = JC._peaks_executables(img.shape, **kw)
    tf, tp, tr = TC._peaks_executables(img.shape, device="cpu", **kw)
    thr = np.float32(np.median(img) + 3.0 * np.std(img))
    jseg, jpk, jn = jp(jimg, jnp.asarray(thr))
    tseg, tpk, tn = tp(timg, torch.tensor(thr))
    assert int(tn) == int(jn)
    _same_packed(tpk, jpk)
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    jseg, jpk, _, jt = jf(jimg)
    tseg, tpk, _, tt = tf(timg)
    assert abs(float(tt) - float(jt)) <= STATS_RTOL * abs(float(jt))
    _same_packed(tpk, jpk)
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    lut = np.random.default_rng(1).integers(0, 9, B + 1).astype(np.int32)
    np.testing.assert_array_equal(
        tr(tseg, torch.from_numpy(lut)).numpy(),
        np.asarray(jr(jnp.asarray(tseg.numpy()), jnp.asarray(lut))))


@pytest.mark.parametrize("kw", [dict(), dict(max_sources=256),
                                dict(threshold=1.0, max_sources=256)])
def test_finder_through_its_programs_matches_jax(mem, kw):
    """The finder's tables through its programs, the two-stage flow
    (counting, then the bucketed detection), the fused program and the
    explicit threshold, equal the JAX finder's; both stages' programs
    are cached."""
    img = SCENES["crowded"]()
    jc, jseg = JC.find_sources_device(img, **kw)
    tc, tseg = TC.find_sources_device(torch.from_numpy(img), **kw)
    _assert_same((jc, np.asarray(jseg), []), (tc, tseg.numpy(), []),
                 peak_rtol=0 if "threshold" in kw else 1e-5)
    n = len(mem)
    assert n >= 2  # the detection and the remap, at least
    TC.find_sources_device(torch.from_numpy(img), **kw)
    assert len(mem) == n


def test_warm_compile_caches_what_the_finder_takes(mem):
    """``warm_compile`` at the defaults (8192 slots): the counting
    program and the 128 / 256 buckets, which the finder then takes
    without a miss; at 256 slots the fused program."""
    img = torch.from_numpy(SCENES["field"]())
    TC.warm_compile(tuple(img.shape), device="cpu")
    n = len(mem)
    assert n == 5  # cat_count, then cat_peaks and cat_remap twice
    TC.find_sources_device(img)
    assert len(mem) == n
    TC.warm_compile(tuple(img.shape), max_sources=256, device="cpu")
    assert len(mem) == n + 1  # cat_find; the 256 bucket's are cached


def _render(stars, statics):
    """JAX's and the port's render_stack programs on one scene."""
    shifts = np.array([[0.1, -0.2], [-0.3, 0.25]])
    cx = np.round(stars[:, 0]).astype(np.int32)
    cy = np.round(stars[:, 1]).astype(np.int32)
    fx = (stars[:, 0] - cx).astype(np.float32)
    fy = (stars[:, 1] - cy).astype(np.float32)
    jargs = (jax.random.PRNGKey(4), jnp.asarray(shifts), jnp.asarray(fx),
             jnp.asarray(fy), jnp.asarray(cx), jnp.asarray(cy))
    want = np.asarray(_j_exe("render_stack", JT._render_core, jargs,
                             **statics)(*jargs))
    targs = (torch.Generator().manual_seed(4),
             torch.tensor(shifts, dtype=torch.float32),
             torch.from_numpy(fx), torch.from_numpy(fy),
             torch.from_numpy(cx.astype(np.int64)),
             torch.from_numpy(cy.astype(np.int64)))
    got = _t_exe("render_stack", TT._render_core, targs, **statics)(*targs)
    return got.numpy(), want


def test_render_stack_matches_jax(mem):
    """``render_stack`` with the noise off: the same frames, stars at the
    right and bottom edges among them. A star at the left edge: the port
    drops its cells off the frame (the JAX package's scatter takes their
    negative indices from the far edge)."""
    statics = dict(E=2, H=48, W=64, amp=25.0, sigma=1.8, noise=0.0, R=9,
                   r_cut=64.0)
    got, want = _render(np.array([[20.3, 30.7], [62.4, 40.1], [60.6, 46.5],
                                  [33.0, 33.9]]), statics)
    assert got.shape == (2, 48, 64) and float(want.max()) > 20.0
    np.testing.assert_allclose(got, want, rtol=RENDER_RTOL, atol=0)
    left, _ = _render(np.array([[2.2, 20.0]]), statics)
    assert left[:, :, :12].max() > 20.0 and not left[:, :, 40:].any()
