"""The control and the planted faults, each put in the program's place and
run through the benchmark's own window and comparison, so that each reads
out as a cell's own result line: ``correct`` has to come out false.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s> [--programs <name> ...]

Programs (all by default, in this order, every seed each):

* ``tf32``: the control. The configuration states float32 with TF32 off,
  and ``align_images`` pins it (``_precision.full_f32``: TF32 switched on
  from outside leaves the program as it is). So the cell's plain
  reference is put in the program's place in the nearest precision
  below, float32 with TF32 on, where its fits' moments, its peak fits'
  normal equations and its matrix DFT are matrix products whose inputs
  TF32 rounds to 10 mantissa bits. It aligns each visit to its own convergence (at most
  ``max_iterations``).
* ``f32``: the same with TF32 off, which has to read as the program does.
* ``unchanged_step``: the cell's program, the port's loop step returning
  the state it was given.
* ``half_frames``: the cell's program, the port's per-frame fits given
  no weight for the second half of the frames.
* ``answer_altered``: the cell's program, its returned x shift of
  exposure 1 moved by 0.02 px.

Every run is one process's: one line of JSON a program and seed (the
result line's ``correct``, ``attempted``, ``failed`` and ``checks``). A
window holds at least one call on each visit of the pool.
"""

import argparse
import contextlib
import json
import os
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def _tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _as_result(ref, seconds: float):
    """A reference alignment dressed as the program's result: the final
    state, each iteration's fits (the step from the state before), the
    grid."""
    hist, M0, t0 = [], None, None
    for it, (M, t) in enumerate(ref.states):
        E = M.shape[0]
        if M0 is None:
            G, g = M, t
        else:
            G = np.einsum("eij,ejk->eik", M, np.linalg.inv(M0))
            g = t - np.einsum("eij,ej->ei", G, t0)
        hist.append([types.SimpleNamespace(matrix=G[e], shift=g[e],
                                           nmatches=int(ref.nmatches[it][e]))
                     for e in range(E)])
        M0, t0 = M, t
    M, t = ref.states[-1]
    grid = types.SimpleNamespace(
        output_wcs=types.SimpleNamespace(crpix=ref.crpix),
        output_shape=ref.out_shape)
    return types.SimpleNamespace(
        matrices=M, shifts=t, history=hist, n_iterations=len(ref.states),
        converged=ref.converged_at is not None, drizzle=grid,
        setup_s=seconds, setup_breakdown={})


def reference_program(cell, tf32: bool):
    """The cell's plain reference in float32 (TF32 on or off) as the
    program."""
    ref_module = cell.reference()

    def program(stack, settings, device, k):
        wcs = [ref_module.Tan(*w) for w in harness.visit_wcs(stack)]
        T = int(dict(ref_module.DEFAULTS, **settings)["max_iterations"])
        t = time.perf_counter()
        with _tf32(tf32):
            ref = ref_module.align(stack.frames, wcs, settings, T, device,
                                   dtype=torch.float32, stop=True)
        return _as_result(ref, time.perf_counter() - t)
    return program


def _drop_loops():
    """Forget the program's captured loops: a graph captured before a
    patch would replay the unpatched step."""
    from subpixal_tpu_torch import align
    getattr(align, "_LOOP_CACHE", {}).clear()


@contextlib.contextmanager
def _patched(name: str, wrap):
    """``subpixal_tpu_torch.align.<name>`` replaced by ``wrap(real)``."""
    from subpixal_tpu_torch import align
    real = getattr(align, name)
    setattr(align, name, wrap(real))
    _drop_loops()
    try:
        yield
    finally:
        setattr(align, name, real)
        _drop_loops()


def unchanged_step():
    """The loop's step returns the state it was given."""
    def wrap(real):
        def step(cfg, out_shape, cut_shape, big_shape, b, Ms, ts, **kw):
            _, _, info = real(cfg, out_shape, cut_shape, big_shape, b, Ms,
                              ts, **kw)
            return Ms, ts, info
        return step
    return _patched("_step", wrap)


def half_frames():
    """The per-frame fits see no weight on the second half of the
    frames."""
    def wrap(real):
        def fit(xy, uv, frame_id, n_frames, wxy=None, **kw):
            keep = (frame_id < n_frames // 2).to(wxy.dtype)
            return real(xy, uv, frame_id, n_frames, wxy=wxy * keep, **kw)
        return fit
    return _patched("iter_linear_fit_frames", wrap)


def answer_altered(program):
    """``program`` (:func:`harness.as_program`'s forms) with its returned
    x shift of exposure 1 moved by 0.02 px."""
    call, prepare = harness.as_program(program)

    def altered(*a, **k):
        res = call(*a, **k)
        res.shifts[1, 0] += 0.02
        return res
    return harness.Program(altered, prepare)


#: name -> cell -> (program, the context it runs in, whether it warms up)
PROGRAMS = {
    "tf32": lambda cell: (reference_program(cell, True),
                          contextlib.nullcontext(), False),
    "f32": lambda cell: (reference_program(cell, False),
                         contextlib.nullcontext(), False),
    "unchanged_step": lambda cell: (cell.program(), unchanged_step(), True),
    "half_frames": lambda cell: (cell.program(), half_frames(), True),
    "answer_altered": lambda cell: (answer_altered(cell.program()),
                                    contextlib.nullcontext(), True),
}


def run(cell, name: str, seed: int, seconds: float, device: str):
    """One run of ``cell`` with program ``name`` in the program's place:
    (the run, its result line)."""
    program, ctx, warm = PROGRAMS[name](cell)
    with ctx:
        return harness.run_cell(
            cell, seed, seconds, False, device, program=program,
            warm_up=warm, min_calls=int(cell.spec["pool_stacks"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--programs", nargs="+", default=list(PROGRAMS),
                    choices=list(PROGRAMS))
    args = ap.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    why = harness.cuda_ready(int(cell.entry.get("chips", 1)))
    if why:
        print(f"no run: {why}", file=sys.stderr)
        return 2
    for name in args.programs:
        for seed in args.seeds:
            r, line = run(cell, name, seed, args.seconds, "cuda")
            for note in r.notes:
                print(f"{name} {seed}: {note}", file=sys.stderr)
            print(json.dumps(dict(
                workload=args.workload, program=name, seed=seed,
                correct=line["correct"], attempted=line["attempted"],
                failed=line["failed"], checks=line["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
