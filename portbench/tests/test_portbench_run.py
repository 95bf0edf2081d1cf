"""A cell driven end to end on the CPU at a tiny size (the kernels' plain
versions), the comparison that decides ``correct`` held to the frozen
oracle and shown to fail on a broken program, the reference put in the
program's place shown to pass in float32, and, on a card, the control
(the same under TF32) shown to fail."""

import json

import numpy as np
import pytest
import torch

from portbench import control, harness, oracle, reference

TINY = dict(name="tiny", shape=[192, 192], n_exposures=4, pscale_arcsec=0.05,
            dither_offsets_px=[[0.0, 0.0], [5.0, 1.5], [2.5, 4.5],
                               [-2.5, 3.0]],
            assumed=dict(n_sources=16, psf_amplitude=25.0, psf_sigma_px=1.8,
                         noise=0.01, shift_scale_px=0.5))
SEED = 2 ** 33 + 11


def tiny_cell(traffic):
    """The cell of ``traffic`` on the tiny visit, two visits a pool, the
    card's device finder pinned (the CPU's default is the host finder)."""
    c = harness.load_cell("acs1k." + traffic)
    c.config = TINY
    c.spec = dict(c.spec, pool_stacks=2, trace_calls=2)
    c.traffic = dict(c.traffic, align=dict(c.traffic["align"],
                                           device_catalog="device"))
    return c


@pytest.mark.parametrize("traffic", ["batch", "otf"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_prints_a_line_of_the_contracts_shape(traffic, trace):
    cell = tiny_cell(traffic)
    run, line = harness.run_cell(cell, SEED, 0.5, trace, "cpu")
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] == len(run.calls) >= 1
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    for v in line["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    if trace:
        assert {"setup.first_call_s", "align.setup_ms", "loop.iterations",
                "loop.ms"} <= set(line["metrics"])
        # no device on the CPU: the device's readers find nothing
        assert not any(n.endswith("_roofline") for n in line["metrics"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "stacks_per_s"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_frames_handed_over_on_the_device():
    # traffic whose frames are already on the run's device
    cell = tiny_cell("batch")
    cell.traffic = dict(cell.traffic, frames="device")
    seen = []
    align_images = cell.program().call

    def program(stack, settings, device, k):
        seen.append(stack.device_frames is not None)
        return align_images(stack, settings, device, k)

    _, line = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                               program=program)
    assert line["correct"] is True, line["checks"]
    assert seen and all(seen)


FAULTS = ["unchanged_step", "half_frames", "answer_altered"]


@pytest.mark.parametrize("traffic", ["batch", "otf"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_program_is_not_correct(fault, traffic):
    _, line = control.run(tiny_cell(traffic), fault, SEED, 0.5, "cpu")
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_the_reference_in_the_programs_place_is_correct_in_float32():
    # the control's route: the plain reference in float32 (no TF32 on
    # the CPU) aligned in the window and judged as the program is (batch
    # only: on the tiny otf visits the reference's own float32 Gaussian
    # peak fits read up to 12.8 mpix from its float64 ones)
    cell = tiny_cell("batch")
    run, line = control.run(cell, "f32", SEED, 0.2, "cpu")
    assert line["correct"] is True, line["checks"]
    assert {c["k"] for c in run.calls} == set(range(
        cell.spec["pool_stacks"]))


def test_reference_displacement_matches_the_frozen_oracle():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float64)
    refs, imgs = [], []
    for dx, dy in rng.uniform(-0.9, 0.9, (6, 2)):
        refs.append(np.exp(-((xx - 15.7) ** 2 + (yy - 16.2) ** 2) / 8.0))
        imgs.append(np.exp(-((xx - 15.7 - dx) ** 2 + (yy - 16.2 - dy) ** 2)
                           / 8.0) + rng.normal(0, 1e-3, (32, 32)))
    r = torch.as_tensor(np.array(refs))
    i = torch.as_tensor(np.array(imgs))
    dx, dy, _, ok = reference.displacement(
        r, i, torch.ones_like(r, dtype=torch.bool),
        dict(peak_fit_box=5, usfac=10, fit_type="gaussian"))
    assert bool(ok.all())
    for b in range(len(refs)):
        want = oracle.find_displacement(refs[b], imgs[b], usfac=10, kfit=5)
        np.testing.assert_allclose([float(dx[b]), float(dy[b])], want,
                                   rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["batch", "otf"])
def test_control_fails_the_limits_on_card(traffic):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 runs only on an NVIDIA card")
    cell = tiny_cell(traffic)
    _, line = control.run(cell, "tf32", SEED, 0.2, "cuda")
    assert line["correct"] is False, line["checks"]
