"""Port parity: ``use_pallas`` wherever the JAX package takes it.

``use_pallas=False`` selects the JAX package's XLA path; in the port it
selects the kernels' plain versions on any device. Here, on the CPU, the
port's ``use_pallas=False`` runs are held to the JAX package's
``use_pallas=False`` runs on the same numpy inputs (that they launch no
kernel is held on the card, in tests/test_torch_cuda.py and
chip_smoke.py). ``use_pallas=True`` off the accelerator raises
``ValueError`` in both packages, at the entry points and in the kernels'
wrappers. Tolerances: the align's per-iteration
shifts within ``SHIFT_TOL`` px at equal ``nmatches`` (tests/
test_torch_align.py's bar); ``Drizzle`` products to
tests/test_torch_drizzle.py's bar.
"""

import numpy as np
import pytest
import torch

from subpixal_tpu import align_images as j_align
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align_images, kernels
from subpixal_tpu_torch import resample as R
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.kernels.blot import sample_cutouts
from subpixal_tpu_torch.kernels.drizzle import (drizzle_deposit,
                                                drizzle_deposit_stack)
from subpixal_tpu_torch.kernels.measure import (find_displacement,
                                                measure_window)
from subpixal_tpu_torch.parallel import make_sharded_align_step
from subpixal_tpu_torch.parallel.sharding import Mesh
from subpixal_tpu_torch.parallel.spatial import (drizzle_deposit_spatial,
                                                 sample_spatial)
from subpixal_tpu_torch.resample import Drizzle

torch.set_num_threads(2)

SHIFT_TOL = 1e-3
#: the JAX package's align configuration (bench.py's), which reaches B3
NEW = dict(fitgeom="shift", usfac=8, fit_type="gaussian")


@pytest.mark.parametrize("requested,device,want", [
    (True, None, True), (False, None, False), (False, "cpu", False),
    (False, "cuda", False), (True, "cuda", True), (True, "cuda:1", True),
    ("auto", "cuda", True), ("auto", "cuda:0", True), ("auto", "cpu", False),
    ("auto", "meta", False), (np.bool_(True), "cuda", True), (0, "cuda",
                                                                False)])
def test_use_pallas_truth_table(requested, device, want):
    """True and False force; 'auto' is true on a CUDA device."""
    assert kernels.use_pallas(requested, device) is want


def test_use_pallas_auto_without_device_follows_cuda(monkeypatch):
    for avail in (True, False):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=avail: a)
        assert kernels.use_pallas() is avail
        assert kernels.use_pallas("auto") is avail


@pytest.mark.parametrize("bad", ["yes", "kernel", None, 2])
def test_use_pallas_rejects_other_values(bad):
    with pytest.raises(ValueError, match="use_pallas"):
        kernels.use_pallas(bad)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "meta"])
def test_use_pallas_true_off_cuda_raises(device):
    with pytest.raises(ValueError, match="use_pallas=True"):
        kernels.use_pallas(True, device)


@pytest.fixture(scope="module")
def align_scene():
    exps, planted = j_simulate(n_exp=3, shape=(192, 192), n_stars=10,
                               seed=7)
    return exps, planted


@pytest.mark.parametrize("config", ["defaults", "new"])
def test_align_use_pallas_false_matches_jax(align_scene, config):
    """align_images(use_pallas=False) on the port's CPU against the JAX
    package's use_pallas=False run: every iteration's shifts within
    SHIFT_TOL at equal nmatches, no kernel launched."""
    exps, _ = align_scene
    kw = dict(max_iterations=4, **(NEW if config == "new" else {}))
    jr = j_align(exposures=exps, use_pallas=False, **kw)
    kernels.reset_launch_counts()
    tr = align_images(exposures=exposures_from_reference(exps),
                      device="cpu", use_pallas=False, **kw)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)
    assert tr.drizzle.use_pallas is False


def test_align_use_pallas_false_equals_auto_on_cpu(align_scene):
    """On the CPU the wrappers run the plain versions, so 'auto' and
    False are the same computation: equal shifts to the bit."""
    exps, _ = align_scene
    texps = exposures_from_reference(exps)
    a = align_images(exposures=texps, device="cpu", max_iterations=3, **NEW)
    b = align_images(exposures=texps, device="cpu", max_iterations=3,
                     use_pallas=False, **NEW)
    np.testing.assert_array_equal(a.shifts, b.shifts)
    assert a.n_iterations == b.n_iterations


def _drizzle_scene(seed=3):
    """tests/test_torch_drizzle.py's kind of scene: three rotated, offset
    exposures with bad-pixel weights and exptimes."""
    rng = np.random.default_rng(seed)
    s = 0.05 / 3600.0
    exps = []
    for e, (dx, dy, rot) in enumerate([(0, 0, 0.0), (3.3, -2.1, 0.4),
                                       (-1.7, 4.2, -0.3)]):
        th = np.deg2rad(rot)
        cd = s * np.array([[-np.cos(th), np.sin(th)],
                           [np.sin(th), np.cos(th)]])
        wcs = JTanWCS(crpix=np.array([20.0 + dx, 16.0 + dy]),
                      crval=np.array([150.0, 2.0]), cd=cd)
        data = rng.normal(5.0, 1.0, (32, 40)).astype(np.float32)
        weight = (rng.random((32, 40)) > 0.1).astype(np.float32)
        exps.append(JExposure(data, wcs, weight=weight,
                              exptime=100.0 + 50 * e, name=f"x{e}"))
    return exps


@pytest.mark.parametrize("how", ["keyword", "config"])
@pytest.mark.parametrize("mode", ["per_frame", "stacked"])
def test_drizzle_use_pallas_false_matches_jax(how, mode, monkeypatch):
    """Drizzle(..., use_pallas=False) and Drizzle(config={'use_pallas':
    False}) run B1's plain versions (the stacked one-launch execute and
    the per-frame deposits) and match JDrizzle(..., use_pallas=False)."""
    jexps = _drizzle_scene()
    jd = JDrizzle(jexps, pixfrac=0.8, kernel="gaussian", use_pallas=False)
    if mode == "stacked":
        monkeypatch.setattr(R, "device_pixmap_min_pixels", lambda d: 1)
    kernels.reset_launch_counts()
    texps = exposures_from_reference(jexps)
    td = (Drizzle(texps, pixfrac=0.8, kernel="gaussian", use_pallas=False,
                  device="cpu") if how == "keyword" else
          Drizzle(texps, config={"final_pixfrac": 0.8,
                                 "final_kernel": "gaussian",
                                 "use_pallas": False}, device="cpu"))
    assert td.use_pallas is False
    td.execute()
    assert ("deposit_stack" in td.last_execute_breakdown) == (
        mode == "stacked")
    assert td.output_shape == tuple(jd.output_shape)
    np.testing.assert_allclose(td.output_sci, np.asarray(jd.output_sci),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(td.output_wht, np.asarray(jd.output_wht),
                               rtol=1e-5, atol=1e-3)
    # fast replace takes the plain deposit as well
    td.fast_replace_image(texps[1])
    np.testing.assert_allclose(td.output_sci, np.asarray(jd.output_sci),
                               rtol=1e-5, atol=1e-4)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_use_pallas_true_on_cpu_raises_in_both_packages():
    """The JAX package's Pallas kernels raise on its CPU backend; the
    port's entry points raise before any work for CPU tensors."""
    jexps, _ = j_simulate(n_exp=2, shape=(96, 96), n_stars=4, seed=1)
    with pytest.raises(ValueError):
        j_align(exposures=jexps, use_pallas=True, max_iterations=1)
    with pytest.raises(ValueError):
        JDrizzle(jexps, use_pallas=True).execute()
    texps = exposures_from_reference(jexps)
    with pytest.raises(ValueError, match="use_pallas=True"):
        align_images(exposures=texps, device="cpu", use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        Drizzle(texps, device="cpu", use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        Drizzle(texps, device="cpu", config={"use_pallas": True})
    mesh = Mesh(None, 0, 1, torch.device("cpu"), ("rows",))
    z = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="use_pallas=True"):
        sample_spatial(mesh, z, z[:2], z[:2], use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        drizzle_deposit_spatial(mesh, z, None, z, z, (16, 16),
                                use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        make_sharded_align_step(Mesh(None, 0, 1, torch.device("cpu"),
                                     ("cutouts",)), 2, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        find_displacement(z[None], z[None], usfac=8, use_pallas=True)


def _wrapper_calls():
    """Each kernel's wrapper on small CPU inputs from a seed:
    name -> call(use_pallas) returning a tuple of tensors."""
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.random((40, 36)), dtype=torch.float32)
    gy, gx = np.mgrid[0:30, 0:28].astype(np.float32)
    px = torch.tensor(np.stack([gx * 1.1 + 0.3, gx - 0.4]))
    py = torch.tensor(np.stack([gy * 0.9 + 1.7, gy + 2.2]))
    data = torch.tensor(rng.random((2, 30, 28)), dtype=torch.float32)
    refs = torch.tensor(rng.random((3, 32, 32)), dtype=torch.float32)
    imgs = torch.roll(refs, (1, -2), (1, 2))
    return {
        "sample_cutouts": lambda up: sample_cutouts(
            img, px, py, interp="poly5", use_pallas=up),
        "drizzle_deposit_stack": lambda up: drizzle_deposit_stack(
            data, None, px, py, (40, 36), pscale_ratio=(1.0, 1.0),
            kernel="gaussian", use_pallas=up),
        "drizzle_deposit": lambda up: drizzle_deposit(
            data[0], data[1], px[0], py[0], (40, 36), use_pallas=up),
        "measure_window": lambda up: measure_window(
            refs, imgs, usfac=8, nwin=16, bounds=(13, 19, 13, 19),
            use_pallas=up),
        "find_displacement": lambda up: tuple(find_displacement(
            refs, imgs, usfac=8, fit_type="gaussian", use_pallas=up)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrappers_take_use_pallas(name):
    """Each kernel's wrapper (and the exported find_displacement) takes
    use_pallas: False runs the plain version, which is what 'auto' runs
    on CPU tensors, so the two agree to the bit; True on CPU tensors
    raises ValueError."""
    call = _wrapper_calls()[name]
    kernels.reset_launch_counts()
    want, got = call("auto"), call(False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="use_pallas=True"):
        call(True)
