"""The port's span primitive (:mod:`subpixal_tpu_torch.tracing`) and the
record an ``align_images`` call returns in ``setup_breakdown``, on the
CPU: spans nest and accumulate and close on an exception, nothing is
recorded without a current record, no device event off CUDA, the
``record_function`` ranges under ``torch.profiler`` (and none without
it), every documented key, the call's unspanned rest, and the host-sync
count of paths whose reads are known."""

import numpy as np
import pytest
import torch

from subpixal_tpu_torch import align_images, tracing
from subpixal_tpu_torch import resample as R
from subpixal_tpu_torch.resample import Drizzle, exposure_rate_data
from subpixal_tpu_torch.testing import simulate_stack

torch.set_num_threads(2)

#: the keys every CPU call with the host finder records (README's list,
#: less those of other paths: the AstroDrizzle stages, the device finder,
#: the bucket, the sparse deposit, a mesh, the card, a program's first
#: call)
DOCUMENTED = {
    "align.call", "align.unspanned", "align.setup", "resample_execute",
    "resample.output_grid", "resample.deposits", "output_sci", "catalog",
    "primary_cutouts", "align.geometry", "frame_pixmaps", "cutout_pixmaps",
    "stack_inputs", "device_stage", "stage_args",
    "align.loop", "align.writeback", "host_syncs", "catalog.sources",
    "cutout.rows", "cutout.cols", "stack_inputs.reused"}
#: the direct child spans of align.call
CHILDREN = ("align.setup", "align.loop", "align.writeback")


@pytest.fixture(scope="module")
def scene():
    exps, _ = simulate_stack(n_exp=3, shape=(96, 128), n_stars=8, seed=3)
    return exps


def _align(exps, **kw):
    kw = dict(dict(fitgeom="shift", max_iterations=3, eps_shift=0.0,
                   min_sources=3), **kw)
    return align_images(exposures=exps, device="cpu", **kw)


def test_spans_nest_accumulate_and_close_on_an_exception():
    out = {}
    with tracing.recording(out):
        with tracing.span("outer", rest="outer.rest"):
            for _ in range(3):
                with tracing.span("inner"):
                    tracing.count("n")
            with pytest.raises(ValueError):
                with tracing.span("raises"):
                    raise ValueError
            left = tracing.span("left_open").open()
        assert left.rec is None  # closed by the outer span's close
    assert set(out) == {"outer", "outer.rest", "inner", "n", "raises",
                        "left_open"}
    assert out["n"] == 3
    children = out["inner"] + out["raises"] + out["left_open"]
    assert 0 < children <= out["outer"]
    assert out["outer.rest"] == pytest.approx(out["outer"] - children)


def test_without_a_record_span_and_count_do_nothing():
    with tracing.span("s", device=torch.device("cpu"), rest="r") as s:
        tracing.count("n")
        tracing.read_device()
    assert s.rec is None
    with tracing.recording(None):  # opens nothing
        tracing.count("n")
        with tracing.span("s") as s:
            pass
    assert s.rec is None


def test_a_nested_record_writes_into_both_stripped_and_whole():
    outer, inner = {}, {}
    with tracing.recording(outer):
        with tracing.span("stage"):
            with tracing.recording(inner, strip="resample."):
                with tracing.span("resample.h2d_stack"):
                    pass
                tracing.count("prog.compile", 2)
    assert set(inner) == {"h2d_stack", "prog.compile"}
    assert set(outer) == {"stage", "resample.h2d_stack", "prog.compile"}
    assert outer["resample.h2d_stack"] == inner["h2d_stack"] <= outer["stage"]


def test_no_device_events_off_cuda(scene):
    out = {}
    with tracing.recording(out, device_events=True):
        with tracing.span("stage", device=torch.device("cpu")) as s:
            assert s.ev is None
        tracing.read_device()
    assert set(out) == {"stage"}
    res = _align(scene)
    assert not any(k.endswith(".device") for k in res.setup_breakdown)


def test_a_call_records_every_documented_key(scene):
    res = _align(scene)
    bd = res.setup_breakdown
    assert DOCUMENTED <= set(bd), DOCUMENTED - set(bd)
    assert res.setup_s == bd["align.setup"] > 0
    assert (bd["cutout.rows"], bd["cutout.cols"]) == (32, 32)
    assert bd["catalog.sources"] >= 3
    # the call's rest: what its direct child spans leave unnamed
    assert 0 <= bd["align.unspanned"]
    assert sum(bd[k] for k in CHILDREN) <= bd["align.call"]
    assert bd["align.unspanned"] == pytest.approx(
        bd["align.call"] - sum(bd[k] for k in CHILDREN))
    # the geometry's stages inside it, the set-up's inside the set-up
    assert bd["frame_pixmaps"] + bd["align.geometry"] <= bd["align.setup"]
    # Drizzle.execute's own breakdown is its stages without the prefix
    dz = Drizzle(scene, device="cpu")
    dz.execute()
    assert set(dz.last_execute_breakdown) == {"output_grid", "deposits"}


@pytest.mark.parametrize("device_loop", [True, False])
def test_host_syncs_count_the_reads_of_the_path(scene, device_loop):
    """The host finder reads the drizzled plane once; the device loop on
    the CPU reads its store once an iteration, the host loop each
    iteration's seven fit fields and its max_shift; the write-back reads
    the matrices and the shifts."""
    res = _align(scene, device_loop=device_loop)
    n = res.n_iterations
    assert n == 3
    per_iter = 1 if device_loop else 8
    assert res.setup_breakdown["host_syncs"] == 1 + per_iter * n + 2
    if device_loop:
        assert res.setup_breakdown["loop_host_reads"] == n


def test_spans_are_profiler_ranges_only_under_the_profiler(scene,
                                                           monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    res = _align(scene)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _align(scene)
    spans = {k for k in res.setup_breakdown
             if isinstance(res.setup_breakdown[k], float)
             and k != "align.unspanned"}
    assert spans <= set(opened)
    ranges = {}
    for ev in prof.events():
        if ev.name in spans:
            ranges.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    assert {"align.call", "align.geometry", "align.loop",
            "align.writeback"} <= set(ranges)
    (c0, c1), = ranges.pop("align.call")
    for name, rs in ranges.items():
        for a, b in rs:
            assert c0 <= a <= b <= c1, name


@pytest.mark.parametrize("path,reused", [
    ("stacked", 1), ("per_exposure", 0), ("match_sky", 1)])
def test_stack_inputs_reuses_the_stack_execute_left(scene, monkeypatch,
                                                    path, reused):
    """``stack_inputs.reused`` reads 1 where the stacked execute ran (frames
    of at least ``device_pixmap_min_pixels``), 0 on the per-exposure path
    below it. Under ``match_sky`` the reused stack holds the
    sky-subtracted rates, not the caller's frames; and the call leaves
    the stack bitwise as ``Drizzle.execute`` left it."""
    exps = scene
    if path != "per_exposure":
        monkeypatch.setattr(R, "device_pixmap_min_pixels", lambda device: 1)
    if path == "match_sky":  # skies that differ, so the stage moves data
        exps = [e.copy() for e in scene]
        for i, e in enumerate(exps):
            e.data = e.data + np.float32(0.25 * i)
    left = {}
    execute = Drizzle.execute

    def spy(self):
        execute(self)
        ds = self._data_stack
        left[id(self)] = None if ds is None else ds.clone()

    monkeypatch.setattr(Drizzle, "execute", spy)
    dz = Drizzle(exps, device="cpu")
    res = _align(None, resample=dz, match_sky=path == "match_sky")
    assert res.setup_breakdown["stack_inputs.reused"] == reused
    ds = dz._data_stack
    if not reused:
        assert ds is None and left[id(dz)] is None
        return
    assert torch.equal(ds, left[id(dz)])
    staged = torch.stack([torch.as_tensor(exposure_rate_data(e))
                          for e in dz.exposures])
    assert torch.equal(ds, staged)
    if path == "match_sky":
        given = torch.stack([torch.as_tensor(exposure_rate_data(e))
                             for e in exps])
        assert not torch.allclose(ds, given)
