"""One run of one cell of the port's benchmark, driven by data.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(its file: the visit's sizes and assumptions), a traffic mix
(``traffic/<name>.json``: the program's settings and the client)
and has a file of its own (``workloads/<cell>.json``: the pool of
visits, the calls traced, the correctness limits). Every metric is read
by ``metrics/<name>.py``'s ``read(run)``, found by the metric's name; a
reader returns None where it finds nothing to read, and the metric is
left out of the line.

A run: import the program and render the pool of visits from the seed on
the card, as host float32 frames (kept on the card where the traffic's
``frames`` is ``"device"``); warm up (a first call on a visit
outside the pool, a second on it, then one call on each pool visit, so
every shape the window uses is captured before it opens); then align the
pool's visits back to back, one client in a closed loop, until the call
running at the deadline ends. With tracing on, the first
``trace_calls`` calls of the window run under ``torch.profiler``. After
the window: the memory peak, then the plain reference of every visit the
window aligned, and the comparison that decides ``correct``.

A cell's files name the three things the harness runs, each a module
found by its name: the configuration's ``"scene"`` (``<scene>.py``, by
default ``scene``: ``make_pool(config, seed, count, device)``, the
visits as :class:`scene.Stack`'s contract states them), the traffic's
``"program"`` (``programs/<program>.py``, by default ``align_images``:
``call(stack, settings, device, k)`` returns the port's ``AlignResult``;
an optional ``prepare(stack, settings, device, k, workdir)`` runs before
each call, warm-up included, outside the timed wall) and the
configuration's ``"reference"`` (``<reference>.py``, by default
``reference``: ``Tan``, ``output_grid``, ``DEFAULTS`` and ``align``,
which decides ``correct``). ``workdir`` is one temporary directory a
run, under the system's temp directory, removed when the run ends. The
control and the planted faults (``control.py``) put another program in
the cell's place and go through the same window and comparison.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import check
from .trace import WINDOW, summarize

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "subpixal_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell as its files state it."""

    name: str
    entry: dict          # BENCHMARK.json's workloads entry
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    spec: dict           # workloads/<cell>.json
    end_to_end: list     # BENCHMARK.json metric entries this cell reports
    per_layer: list

    def scene(self):
        """The module that renders the cell's visits: the configuration's
        ``"scene"``, else ``scene``."""
        return lookup(__package__, self.config.get("scene", "scene"))

    def reference(self):
        """The plain reference that decides ``correct``: the
        configuration's ``"reference"``, else ``reference``."""
        return lookup(__package__,
                      self.config.get("reference", "reference"))

    def program(self):
        """The program the window times: ``programs/<name>.py`` of the
        traffic's ``"program"``, else ``align_images``."""
        return lookup(__package__ + ".programs",
                      self.traffic.get("program", "align_images"))


def lookup(package: str, name: str):
    """The module ``<package>.<name>`` that a cell's files name."""
    if not name.isidentifier():
        raise ValueError(f"{name!r} is not a module's name")
    return importlib.import_module(f"{package}.{name}")


#: what a run drives: ``call(stack, settings, device, k)`` and an optional
#: ``prepare(stack, settings, device, k, workdir)`` (None: nothing)
Program = collections.namedtuple("Program", "call prepare")


def as_program(program) -> Program:
    """A :class:`Program` of a module or namespace with ``call`` (and
    ``prepare``), or of a bare ``call``."""
    if callable(getattr(program, "call", None)):
        return Program(program.call, getattr(program, "prepare", None))
    return Program(program, None)


def _reported(metrics, name):
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (``root``/BENCHMARK.json when None),
    with its configuration, traffic and cell files."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry,
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       entry["traffic"] + ".json")),
        spec=load_json(os.path.join(HERE, "workloads", name + ".json")),
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name))


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    device: str
    setup_s: float = 0.0
    first_call_s: float = 0.0
    window_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    raised: int = 0
    memory_reserved_peak: int = 0
    aot_held_bytes: int | None = None
    trace: dict | None = None
    traced_calls: int = 0
    refs: dict = dataclasses.field(default_factory=dict)  # pool k -> Result
    notes: list = dataclasses.field(default_factory=list)  # for stderr
    warm_walls: list = dataclasses.field(default_factory=list)
    host_probe_ms: float | None = None


def visit_wcs(stack) -> list:
    """(crpix, crval, cd) of each frame of a visit."""
    return [(stack.crpix[e], stack.crval, stack.cd)
            for e in range(len(stack.frames))]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _call(program: Program, stack, settings, device, k, workdir):
    """One timed call of ``program``, its ``prepare`` first and outside
    the wall: (record, wall seconds)."""
    from subpixal_tpu_torch import kernels

    if program.prepare is not None:
        program.prepare(stack, settings, device, k, workdir)
    before = dict(kernels.LAUNCHES)
    _sync(device)
    t = time.perf_counter()
    res = program.call(stack, settings, device, k)
    _sync(device)
    wall = time.perf_counter() - t
    hist = res.history
    rec = dict(
        k=k, wall=wall, setup_s=float(res.setup_s),
        breakdown=dict(res.setup_breakdown or {}),
        n_iter=int(res.n_iterations), converged=bool(res.converged),
        matrices=np.asarray(res.matrices, np.float64),
        shifts=np.asarray(res.shifts, np.float64),
        G_M=np.array([[r.matrix for r in it] for it in hist], np.float64),
        G_t=np.array([[r.shift for r in it] for it in hist], np.float64),
        nmatches=np.array([[r.nmatches for r in it] for it in hist]),
        crpix=np.asarray(res.drizzle.output_wcs.crpix, np.float64),
        out_shape=tuple(res.drizzle.output_shape),
        launches={n: kernels.LAUNCHES[n] - before[n] for n in before})
    return rec, wall


def host_probe_ms(repeats: int = 5) -> float:
    """Median ms of a fixed host workload (float64 numpy transcendental
    and reduction work, as the program's host geometry does, and a
    Python loop): the host's speed while the run ran, beside the rate."""
    x = np.linspace(0.0, 1.0, 1 << 18)
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        y = np.arctan2(np.sin(x), np.cos(x) + 2.0)
        float(np.sort(y)[::-1].cumsum()[-1])
        acc = 0
        for i in range(20000):
            acc += i & 7
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def _aot_held_bytes():
    """Bytes the program's cached setup programs hold (``aot._MEM``'s
    entries' ``nbytes``), or None where the program keeps no such cache."""
    try:
        from subpixal_tpu_torch import aot
        mem = aot._MEM
    except (ImportError, AttributeError):
        return None
    return int(sum(getattr(e, "nbytes", 0) or 0 for e in list(mem.values())))


def forbidden_modules() -> list:
    """Loaded top-level modules of :data:`FORBIDDEN`, by whole name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             log=sys.stderr, program=None, warm_up: bool = True,
             min_calls: int = 0) -> tuple[Run, dict]:
    """One run of ``cell``: returns the run and its result line (a dict).
    ``program`` is what is aligned (:func:`as_program`'s forms; None:
    the cell's own); the control's runs skip the warm-up and hold the
    window open for ``min_calls`` calls at least."""
    t0 = time.time() if t0 is None else t0
    settings = dict(cell.traffic.get("align", {}))
    run = Run(cell=cell, device=device)
    program = as_program(cell.program() if program is None else program)
    import subpixal_tpu_torch  # noqa: F401  (the program under test)

    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        pool = _set_up(run, seed, settings, t0, program, warm_up, workdir)
        probe = [host_probe_ms()]
        _window(run, pool, settings, seconds, trace, log, program,
                min_calls, workdir)
        probe.append(host_probe_ms())
    run.host_probe_ms = float(np.mean(probe))
    run.notes.append(f"host probe ms before / after the window "
                     f"{probe[0]:.3f} / {probe[1]:.3f}")
    if torch.device(device).type == "cuda":
        run.memory_reserved_peak = int(torch.cuda.max_memory_reserved())
    run.aot_held_bytes = _aot_held_bytes()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gaps, failed = _compare(run, pool, settings)
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of the JAX package or JAX are loaded: "
                           + ", ".join(found))
    return run, _line(run, gaps, failed, trace)


def _set_up(run: Run, seed: int, settings: dict, t0: float,
            program: Program, warm_up: bool, workdir: str) -> list:
    """The pool of visits (and one outside it) rendered on the run's
    device, the memory peak reset, then the warm-up calls. Returns the
    pool."""
    device = run.device
    t_import = time.time() - t0
    P = int(run.cell.spec["pool_stacks"])
    pool = run.cell.scene().make_pool(run.cell.config, seed, P + 1, device)
    if run.cell.traffic.get("frames", "host") == "device":
        for st in pool:
            st.device_frames = [torch.as_tensor(f, device=device)
                                for f in st.frames]
    warm = pool.pop()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_pool = time.time() - t0 - t_import
    # the process's first call, a second, one on each visit in the
    # scenes' own order, so the program captures its shapes and takes
    # its memory alike in every run
    _, run.first_call_s = _call(program, warm, settings, device, -1,
                                workdir)
    visits = sorted(enumerate(pool), key=lambda kv: kv[1].index)
    for k, st in ([(-1, warm)] + visits) if warm_up else []:
        run.warm_walls.append(
            _call(program, st, settings, device, k, workdir)[1])
    run.setup_s = time.time() - t0
    run.notes.append(
        f"setup: start to import {t_import:.3f} s, pool {t_pool:.3f} s, "
        f"first call {run.first_call_s:.3f} s, warm calls "
        f"{sum(run.warm_walls):.3f} s ({len(run.warm_walls)}, longest "
        f"{max(run.warm_walls, default=0.0):.3f} s)")
    return pool


def _window(run: Run, pool: list, settings: dict, seconds: float,
            trace: bool, log, program: Program, min_calls: int,
            workdir: str) -> None:
    """The pool's visits aligned back to back until the call running at
    the deadline ends; with ``trace``, the first ``trace_calls`` calls
    under ``torch.profiler`` in a :data:`WINDOW` span."""
    device = run.device
    n_trace = int(run.cell.spec.get("trace_calls", 0)) if trace else 0
    with contextlib.ExitStack() as traced:
        prof = None
        if n_trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = traced.enter_context(profile(activities=acts))
            traced.enter_context(record_function(WINDOW))
        start = time.perf_counter()
        deadline = start + float(seconds)
        i = 0
        while True:
            k = i % len(pool)
            try:
                run.calls.append(
                    _call(program, pool[k], settings, device, k,
                          workdir)[0])
            except Exception:  # a failed call counts, and the loop goes on
                run.raised += 1
                if run.raised == 1:
                    traceback.print_exc(file=log)
            i += 1
            if prof is not None and i == n_trace:
                _sync(device)
                traced.close()
            if time.perf_counter() >= deadline and i >= min_calls:
                break
        run.window_s = time.perf_counter() - start
        _sync(device)
    if prof is not None:
        run.traced_calls = min(i, n_trace)
        run.trace = summarize(prof)
    walls = sorted(c["wall"] for c in run.calls)
    if walls:
        caps = sum(int(c["breakdown"].get("loop_graphs", 0)) > 0
                   or any(k.endswith(".compile") for k in c["breakdown"])
                   for c in run.calls)
        run.notes.append(
            f"window: {len(walls)} calls in {run.window_s:.3f} s, wall ms "
            f"min {1e3 * walls[0]:.2f} median "
            f"{1e3 * walls[len(walls) // 2]:.2f} max {1e3 * walls[-1]:.2f}; "
            f"calls that captured a graph or program: {caps}")


def visit_geometry(st, ref_module):
    """A visit's frames' WCS for the reference module ``ref_module`` (a
    cell's :meth:`Cell.reference`), and the five test points of
    :func:`check.test_points` on its grid."""
    wcs = [ref_module.Tan(*w) for w in visit_wcs(st)]
    grid, _ = ref_module.output_grid(wcs, [f.shape for f in st.frames])
    return wcs, check.test_points(st.frames[0].shape, lambda x, y: tuple(
        v.numpy() for v in grid.world2pix(*wcs[0].pix2world(
            torch.as_tensor(x), torch.as_tensor(y)))))


def _compare(run: Run, pool: list, settings: dict) -> tuple[dict, int]:
    """The plain reference of every visit the window aligned, and every
    call held to it and to the planted errors: (the largest of each
    number, the calls that failed)."""
    t_ref = time.time()
    gaps = dict(state_mpix=0.0, truth_mpix=0.0)
    limits = run.cell.spec["limits"]
    bad_calls = set()
    worst = (-1.0, None, 0)  # state gap, visit, fits whose counts differ
    ref_module = run.cell.reference()
    for k in sorted({c["k"] for c in run.calls}):
        st = pool[k]
        iters = max(c["n_iter"] for c in run.calls if c["k"] == k)
        wcs, qr = visit_geometry(st, ref_module)
        ref = ref_module.align(st.frames, wcs, settings, iters, run.device)
        run.refs[k] = ref
        for i, c in enumerate(run.calls):
            if c["k"] != k:
                continue
            q = qr + (c["crpix"] - ref.crpix)
            final = (c["matrices"], c["shifts"])
            g = dict(state_mpix=check.state_gap(
                check.composed_states(c["G_M"], c["G_t"]), final,
                c["crpix"], ref, q),
                truth_mpix=check.truth_gap(final, st.planted, q))
            for n, v in g.items():
                gaps[n] = max(gaps[n], v)
                if n in limits and not v <= limits[n]:
                    bad_calls.add(i)
            if g["state_mpix"] > worst[0]:
                worst = (g["state_mpix"], k, int(sum(
                    (np.asarray(a) != np.asarray(b)).sum()
                    for a, b in zip(c["nmatches"], ref.nmatches))))
    run.notes.append(f"reference: {len(run.refs)} visits in "
                     f"{time.time() - t_ref:.3f} s; widest state gap "
                     f"{worst[0]:.4f} mpix on visit {worst[1]}, whose fits "
                     f"kept another number of sources than the "
                     f"reference's {worst[2]} times")
    for n in sorted(set(gaps) - set(limits)):
        run.notes.append(f"{n} {gaps[n]!r} (not compared in this cell)")
    if run.calls:
        run.notes.append(
            "iterations mean {:.3f}; live fraction mean {:.4f}".format(
                np.mean([c["n_iter"] for c in run.calls]),
                np.mean([c["breakdown"].get("sparse_live_frac", 1.0)
                         for c in run.calls])))
    return gaps, run.raised + len(bad_calls)


def _line(run: Run, gaps: dict, failed: int, trace: bool) -> dict:
    """The result line: ``correct``, the counts, the cell's metrics (the
    per-layer ones with ``trace``), the device, the trace's breakdown and,
    last, each number compared beside its limit."""
    limits = run.cell.spec["limits"]
    correct = (failed == 0 and len(run.calls) > 0
               and all(gaps[n] <= limits[n] for n in limits))
    metrics = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    if torch.device(run.device).type == "cuda":
        devinfo = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                       count=int(run.cell.entry.get("chips", 1)),
                       memory_peak_bytes=run.memory_reserved_peak)
    else:
        devinfo = dict(platform="cpu", kind="cpu", count=1,
                       memory_peak_bytes=0)
    line = dict(correct=bool(correct), attempted=len(run.calls) + run.raised,
                failed=failed, metrics=metrics, device=devinfo)
    if trace and run.trace is not None:
        devinfo["busy_s"] = run.trace["busy_s"]
        devinfo["window_s"] = run.trace["window_s"]
        line["breakdown"] = dict(device_ops=run.trace["device_ops"],
                                 idle_gaps=run.trace["idle_gaps"])
    line["checks"] = {n: dict(value=gaps[n], limit=limits[n])
                      for n in limits}
    return line


def cuda_ready(chips: int) -> str | None:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                f"{chips}")
    return None


def cache_dirs(root: str = ROOT) -> None:
    """The program's one build cache, its kernels' nvcc builds, at a fixed
    path inside the checkout (the program's default, set here so that a
    ``SUBPIXAL_TPU_AOT_DIR`` inherited from the environment cannot move
    it out). The program has no other build or kernel cache."""
    os.environ["SUBPIXAL_TPU_AOT_DIR"] = os.path.join(
        root, "subpixal_tpu_torch", "build")


def mean(values) -> float | None:
    """The mean of ``values``, or None when there are none."""
    values = list(values)
    return float(np.mean(values)) if values else None
