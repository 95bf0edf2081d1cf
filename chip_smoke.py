#!/usr/bin/env python3
"""Check that the PyTorch/CUDA port runs on one NVIDIA GPU, and time it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --cards N`` (a machine with N cards) builds the
kernels, runs phase 9 on one card and then phase 15's checks on phase
9's configuration over N NCCL ranks, one card each, and phase 16's over
N NCCL bands, a card each (and over a (2, 2) frames-by-rows mesh when N
is 4).

``python3 chip_smoke.py --profile [--root DIR]`` builds the kernels and
instead measures device time with ``torch.profiler``: one iteration's
re-drizzle as the package's align step runs it, the kernels per launch,
the device finder's host syncs and ms a warm call, and one warm align
call of each path (the spatial path on one NCCL band among them), with
the host launch API calls of its setup (outside the loop), and the
memory peak of a one-card align of the 4 x 4096² scene with the setup
programs off and on. ``--root DIR`` imports the package
from another checkout (a ``git archive`` of an earlier commit), so two
commits can be compared in one process each on the same card.

Phases (any failure raises and exits non-zero; no phase catches another's
failure):

1. toolchain: torch/CUDA versions, the card, ``nvcc --version``;
2. build the three kernels from ``subpixal_tpu_torch/csrc`` with nvcc
   (``sm_90a``), one nvcc per source, started together;
3. B1: the drizzle deposit kernel against its plain PyTorch version on
   the card: a 1024² frame with a small rotation and fractional offsets
   for all seven drizzle kernels at pixfrac 1.0 and 0.8 (every strip on
   the shared-memory path); the same frame rotated 30° (strips on the
   direct-atomics path); a stack of 8 × 256² planes at ratios 1.0, 0.5
   and 2.0 for all seven kernels, summed and with per-exposure output
   planes; the main path's stack of 8 × 1024² in one launch, summed and
   per-plane (the stacked ``Drizzle.execute``'s form; the planes' sum
   also held to the summed launch); and that stack compacted to
   (8, L·16, 128) block columns, as the sparse deposit stages it;
4. B2: the blot gather kernel against its plain version for all six
   interpolants, and the sinc at ``sinscl`` 2 and 0.5 (where some
   queries take the bilinear guard), on 512 cutouts of 32² (the shape
   the main path picks for its scene), 512 of 48² (the 48² path's) and
   16 of 256² (the oversized bucket's cap); every interpolant and the
   sinc at ``sinscl`` 2 timed at 32², the linear interpolant also beside
   ``grid_sample``, the one PyTorch call that computes it at interior
   points; then ``blot_image`` (a whole 1024² frame) and ``blot_cutout``
   with the sinc at ``sinscl`` 0.5, 1.5 and 2, one B2 launch each, held
   to the plain version and to the CPU run;
5. B3: the measurement kernels against their plain version (the
   ``torch.fft`` chain), each route asserted: the FFT kernel on 512
   masked NCC pairs of 32² at ``usfac`` 8 (the new path's shape) and on
   ``bench.py``'s 500 unmasked NCC pairs of 64² at ``usfac`` 10, and the
   mixed-radix kernel asked for on the same pairs; the mixed-radix kernel
   on 512 masked pairs of 48² (the 48² path's), of 128²
   (``max_cut_size``) and on 16 of 256² (the oversized bucket's cap);
   then B3's shape limit: its host plan against the shape rule
   ``find_displacement`` routes by (``ops.correlate.window_fits``) on
   square and non-square sides up to 512 (large prime factors among
   them) at ``usfac`` 8 to 100, and the package's ``find_displacement``
   on both sides of the limit, held to the plain one (the refused
   shapes take the full surface, with no B3 launch);
6. the catalog phase: the device source finder on the main path's
   reference (the 8 x 1024², 60-star stack drizzled on the card), held
   to its own run on the CPU (rows, areas, bboxes and segmentation planes
   equal, positions within 1e-4 px, fluxes within 1e-5 relative); warm
   ms on the card beside the CPU run and the host finder;
6a. the aot phase: the setup programs that ``aot.get_executable``
   captures as CUDA graphs (``render_stack``, ``deposit_stack``,
   ``cutout_pixmaps_stack``, ``device_stage``, and the device finder's
   ``cat_count``, ``cat_count_thr``, ``cat_peaks``, ``cat_find``,
   ``cat_remap``), recorded with their inputs on phase 9's scene
   rendered on the card at full size (its setup, and the finder on its
   reference with 256 slots and at an explicit threshold): each one's
   first call runs it eagerly and captures it, counting the launches
   ``torch.profiler`` sees the card run, its second ``get_executable``
   is a hit, its replay equals the eager function (the finder exactly,
   ``deposit_stack`` and ``render_stack`` within ``REL_TOL``), and a
   replay adds the launches its graphs hold (B1 once a
   ``deposit_stack`` replay, nothing else); prints each one's first-call
   seconds, eager and replay ms, host syncs and the memory it holds, and
   the finder's host syncs a call with its programs and with them off;
7. the defaults' path: ``align_images`` on that stack for 4 iterations,
   with the kernels' launch counts set to 0 just before and read just
   after (B1 and B2 must have run, B1 once at setup, the stacked
   execute's per-plane launch, and once per iteration), and a spy on
   the device finder, which 'auto' must have run on the card; the fit error against the planted shifts
   must be under 10 mpix, and the first iteration's shifts must agree
   within 1e-3 px with the same run forced through the plain versions on
   the card. A second call of the same run gives the steady-state time
   per iteration and setup breakdown;
8. the defaults' path with ``device_catalog='host'`` (the host finder,
   never the device one), whose shifts must agree with phase 7's within
   3 mpix, the JAX package's own bar between the two finders;
9. the new path: the same scene with the JAX package's own align
   configuration (``bench.py``'s align smoke: shift fit, ``usfac`` 8,
   Gaussian peak), whose 'auto' settings on the card take device
   pixmaps and the sparse deposit; B1, B2 and B3 must all have run, with
   the same checks and a second, warm call;
10. the 48² path: the same configuration on the same scene with broader
    stars (sigma 3.0 px), whose footprints make the auto-sizing pick 48²
    cutouts; B3 must measure 512 pairs of 48² each iteration through the
    mixed-radix kernel, with the same checks as phase 9;
11. the otf path: phase 9's configuration with ``wcsupdate='otf'`` for 4
    iterations: B1 must launch 8 + 8 per iteration times (the stack
    re-drizzled before each exposure is measured), B2 and B3 8 times an
    iteration, with the same checks;
12. the host-loop path: phase 9's configuration with
    ``device_loop=False`` for 2 iterations, with the same checks; its
    shifts must follow phase 9's device loop within 1e-4 px;
13. the pipeline path: the phase 7 scene with per-exposure sky offsets,
    dead pixels shared by all exposures, planted cosmic-ray hits and half
    the exposures in counts, written as 4 gzip'd FITS files of two SCI
    chips each with WHT extensions, through ``align_fits`` with
    ``match_sky``, ``static_mask`` and ``reject_cr`` on and phase 9's
    configuration for 4 iterations: B1 twice at setup (the execute and
    the re-drizzle after the CR rejection) and once per iteration, B2
    and B3 as on the new path; fit error under 10 mpix; every planted
    hit and dead pixel at weight 0; the first iteration within 1e-3 px
    of the same run through the plain versions; the rewritten headers
    reload to the returned WCSs and the state file reloads. The stages'
    tensor branches on device-resident exposures are held to their host
    branches on the card (skies within 1e-4, equal static masks, the
    planted hits flagged by both, CR totals within 2);
14. the mesh path, one NCCL rank: phase 9's configuration under
    ``mesh=make_mesh(1)`` (a one-rank NCCL group on an in-memory store),
    with phase 7's checks: B1 once at setup and once an iteration over
    all 8 local frames, B2 and B3 once an iteration, the device finder
    run, fit error under 10 mpix, the first iteration within 1e-3 px of
    the same run through the plain versions, a warm second call (the
    loop's cached graph, collectives and all), a call with capture
    turned off; and its shifts within 5e-4 px of phase 9's run without a
    mesh;
15. the mesh path, two ranks sharing the card: the same configuration in
    two processes on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card), which only load the kernels phase 2 built: each rank's B1 once
    at setup (the stacked execute) and once an iteration on its 4
    frames, B2 and B3 once an iteration on its half of the (frame,
    source) batch; both ranks' shifts equal, and within 5e-4 px of phase
    14's; a warm second call in each rank; in each rank the first
    iteration within 1e-3 px of the same run through the plain versions
    (so each kernel is held to its plain version at the shapes a rank
    gives it). A rank that fails or outlasts its time limit fails the
    phase;
16. the spatial path: ``bench.py``'s spatial scene (phase 9's scene and
    configuration) through ``align_images(resample=Drizzle(exposures,
    spatial_mesh=mesh))``, first on a one-rank NCCL rows mesh, then on
    two gloo ranks sharing ``cuda:0`` (two row bands). On each rank, with
    the launch counts set to 0 just before and read just after: B1 once
    at setup (the stacked execute's per-plane launch into the band) and
    once an iteration (the stack into the band), B2 once an iteration
    (on the halo-extended band), B3 once an iteration (the replicated
    measurement); the band-local finder (a spy) run on the card; fit
    error under 10 mpix; the first iteration within 1e-3 px of the same
    run through the plain versions. The ranks' shifts equal, and within
    2e-3 px of phase 9's; the NCCL band's loop captured, cached and held
    to its run with capture off. Each run prints cold and warm ms per
    iteration,
    ``setup_s`` with its breakdown and the rank's memory peak;
17. the spatial 4k path: ``bench.py``'s 4 × 4096², 80-star, seed-23
    scene on two gloo ranks sharing the card for 2 iterations, with phase
    16's checks (no reference run) and the band-local sparse deposit
    engaged: ``sparse_live_frac`` in the setup breakdown and B1 given the
    compacted (E, L·16, 128) blocks in the loop;
18. the ``use_pallas=False`` path: phase 9's scene and configuration
    through ``align_images(..., use_pallas=False)``: no kernel launched,
    every iteration's shifts within 1e-6 px of the same call through
    ``_plain_versions``, fit error under 10 mpix, warm ms an iteration
    beside the kernels'; ``Drizzle(..., use_pallas=False).execute()``
    launches no B1 and equals the plain per-plane run, and the default
    ``Drizzle`` still launches B1;
19. the device-rendered scene: phase 9's scene from
    ``simulate_stack(device='cuda')`` (``planted`` equal to the host
    render's), through phase 9's configuration to under 10 mpix; warm
    ``setup_s`` and the host-to-device copies of a profiled call, beside
    the host-rendered scene's.

Every align phase with the device loop (7-11, 13, 18, 19, and on NCCL
ranks and bands 14, 16's first part and ``--cards N``) checks and prints
its fixed-point loop (``check_loop``): its first call, after the loop's
graph cache is emptied (or on a new process group), captured once as a
CUDA graph, under a mesh with its collectives, and replayed n_iterations
− 1 times; its second call (all but 19) served by the cached graph,
replayed n_iterations times; each with at most ⌈n/4⌉ + 1 host reads
(under a mesh the ranks' agreement to capture or replay among them) and
``loop_compile`` in the setup breakdown. The NCCL phases also run the
call once with capture turned off (``eager_loop``: the masked step
eagerly, the parent's loop), to which the captured loop's every
iteration is held within 1e-4 px with equal iterations and
``nmatches``. The host loop (12) captures nothing; the gloo ranks and
bands (15, 16's second part, 17) run the masked step eagerly, with at
most ⌈n/4⌉ + 1 host reads; every rank of a mesh runs as many steps.

Every align phase prints the measurement route each batch took
(``route_name``: torch.fft at ``usfac`` 1, B3's kernel, or the full
surface), and phases 16-17 also hold each rank's ``sample_spatial`` sinc
at ``sinscl`` 0.5, 1.5 and 2 (one B2 launch a rank) to the plain version
on the whole plane, and its ``sample_spatial`` on an 8-row plane (bands
thinner than poly5's footprint on two bands) at poly5 and at spline3
with ``spline_halo=2``: no B2 launch where the band cannot hold the
footprint, validity equal to the whole plane's, poly5 within
``REL_TOL``, and ``use_pallas=True`` refusing those shapes.

Each kernel is timed three ways at each shape: ``ms``, the median of 30
CUDA-event timings of one wrapper call (host launch overhead and the
wrapper's allocations included); ``device_us``, the kernel's own device
time per launch from ``torch.profiler`` over 20 back-to-back calls, each
on another copy of the inputs (copies that together exceed twice the L2,
so the inputs come from device memory); and ``plain_ms`` for the plain
version. Each bound is the larger of the bytes the function must move
(each input read once, each output written once; for B2 only the image
pixels its footprints cover) over 3.35 TB/s and the f32 operations it
does on these inputs over 67 TFLOP/s (the H100 SXM's published rates). The line before the last is
the card's name and power limit as ``nvidia-smi`` reports them; the one
before it is a JSON record of every kernel and shape. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import inspect
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np

#: B1 and B2 are compared with their plain versions to this bound on
#: max |kernel - plain| / max(1, max |plain|): the kernels evaluate the
#: same f32 formulas, but atomics (B1), B1's weights factored by axis and
#: fused multiply-adds (B1, B2) change the order and rounding of the sums
REL_TOL = 1e-5

#: grid_sample, the yardstick for B2's linear interpolant, takes the
#: coordinates normalised to [-1, 1] and back: f32 rounding moves a point
#: by up to ~3e-5 px on a 1024² frame, which on the stars' slopes is above
#: REL_TOL; this bound only shows that it computes the same function
LIBRARY_TOL = 1e-4

#: B3's window is compared relative to its largest value: the kernels sum
#: their own FFTs or direct DFTs where the plain version runs torch.fft
#: (the JAX package holds its own fused kernel to its XLA path with the
#: same bar)
C2_TOL = 5e-4

#: published H100 SXM rates: device-memory bytes/s, f32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: the H100 SXM's L2 cache
L2_BYTES = 50 * 2 ** 20


#: the JAX package's align configuration (``bench.py``'s align smoke)
NEW_PATH = dict(fitgeom="shift", usfac=8, fit_type="gaussian")


def bound(nbytes, flops):
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    tb, tf = nbytes / HBM_BPS, flops / F32_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return (out.stdout or out.stderr).strip()


def cuda_ms(fn, reps=30, warmup=3):
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rotating(call, *args):
    """A function of no arguments that calls ``call`` on a new copy of
    ``args`` (tensors) each time, cycling over enough copies that their
    bytes together exceed twice the L2 cache: each launch then reads its
    inputs from device memory, as the bound assumes, not from L2."""
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    k = max(1, -(-2 * L2_BYTES // max(nbytes, 1)))
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args) for _ in range(k - 1)]
    it = itertools.cycle(copies)
    return lambda: call(*next(it))


def device_us(fn, key, reps=20):
    """Device microseconds per launch of the kernels whose name holds
    ``key``, from ``torch.profiler`` over ``reps`` back-to-back calls of
    ``fn`` (after one warm-up call); pass a :func:`rotating` ``fn`` to
    time launches that read their inputs from device memory. A trace in
    which the profiler recorded none of them (CUPTI drops one now and
    then) is taken again, twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if key in e.key]
        n = sum(e.count for e in ev)
        if n:
            return sum(e.self_device_time_total for e in ev) / n
    raise AssertionError(f"the profiler saw no launch of {key!r}")


def _rel_err(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale, float(
        (got - want).abs().max())


def _deposit_planes(dev, E, H, W, rot_deg, ratios, seed):
    """E planes of data, weights (5 % zero) and pixmaps: each a rotation
    by ``rot_deg``, a scale by its ratio and a fractional offset."""
    import torch

    rng = np.random.default_rng(seed)
    th = np.deg2rad(rot_deg)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = {k: [] for k in "dwxy"}
    for e, r in enumerate(ratios):
        out["x"].append(r * (np.cos(th) * xx - np.sin(th) * yy) + 3.37
                        + 0.29 * e)
        out["y"].append(r * (np.sin(th) * xx + np.cos(th) * yy) - 2.61
                        + 0.17 * e)
        out["d"].append(rng.normal(1.0, 0.5, (H, W)))
        out["w"].append(rng.uniform(0.5, 1.5, (H, W))
                        * (rng.random((H, W)) > 0.05))
    return {k: torch.tensor(np.stack(v), dtype=torch.float32, device=dev)
            for k, v in out.items()}


def _b1_check(t, oshape, ratios, kernel, pixfrac, label, direct=None,
              per_plane=False):
    """Kernel vs plain stack; ``direct`` (None: any) is whether strips
    must take the direct-atomics path; ``per_plane`` checks the launch
    that keeps each plane's accumulators (every plane against the plain
    version's, and their sum against the summed launch). Returns the max
    abs error."""
    import torch

    from subpixal_tpu_torch.kernels.drizzle import _deposit_stack
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack

    n_direct = torch.zeros(1, dtype=torch.int32, device=t["d"].device)
    s, w, esc = _deposit_stack(t["d"], t["w"], t["x"], t["y"], oshape,
                               pixfrac, ratios, kernel, n_direct,
                               per_plane=per_plane)
    ps, pw = drizzle_deposit_stack(t["d"], t["w"], t["x"], t["y"], oshape,
                                   pixfrac=pixfrac, pscale_ratio=ratios,
                                   kernel=kernel, per_plane=per_plane)
    rs, as_ = _rel_err(s, ps)
    rw, aw = _rel_err(w, pw)
    if per_plane:  # each plane, and the planes' sum vs the summed launch
        rs = max(rs, max(_rel_err(s[e], ps[e])[0] for e in range(len(s))))
        rw = max(rw, max(_rel_err(w[e], pw[e])[0] for e in range(len(w))))
        ss, sw, _ = _deposit_stack(t["d"], t["w"], t["x"], t["y"], oshape,
                                   pixfrac, ratios, kernel)
        rs = max(rs, _rel_err(s.sum(0), ss)[0])
        rw = max(rw, _rel_err(w.sum(0), sw)[0])
        label = f"{label} per-plane"
    torch.cuda.synchronize()
    nd = int(n_direct)
    print(f"B1 {label} {kernel:9s} pixfrac={pixfrac}: rel err sci {rs:.2e} "
          f"wht {rw:.2e}, escaped {int(esc.abs().sum())}, direct strips {nd}")
    if not (rs <= REL_TOL and rw <= REL_TOL) or int(esc.abs().sum()) != 0:
        raise AssertionError(f"B1 {label} {kernel} pixfrac={pixfrac} "
                             "disagrees with the plain version")
    if direct is not None and (nd > 0) != direct:
        raise AssertionError(f"B1 {label}: {nd} strips took the direct "
                             f"path, expected {'some' if direct else 'none'}")
    return max(as_, aw)


def _b1_time(t, oshape, ratios, label, per_plane=False):
    """Wrapper, device and plain times and the bound, square/pixfrac 1."""
    from subpixal_tpu_torch.kernels.drizzle import drizzle_deposit_stack
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack as plain

    args = (t["d"], t["w"], t["x"], t["y"], oshape)
    kw = dict(pscale_ratio=ratios, per_plane=per_plane)
    ms = cuda_ms(lambda: drizzle_deposit_stack(*args, **kw))
    dev_us = device_us(rotating(lambda *a: drizzle_deposit_stack(*a, **kw),
                                *args), "deposit_tiles")
    plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
    # data, weight, x, y read; sci, wht written (one pair, or one per
    # plane); ~20 flops for each of the K x K = 4 cells a pixel meets at
    # square/pixfrac 1
    npix = t["d"].numel()
    n_out = (t["d"].shape[0] if per_plane else 1) * oshape[0] * oshape[1]
    bound_ms, by = bound(4 * (4 * npix + 2 * n_out), 20 * 4 * npix)
    print(f"B1 {label}: wrapper {ms:.4f} ms, device {dev_us:.3f} us per "
          f"launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}, "
          f"{bound_ms * 1e3 / dev_us:.1%} of it reached)")
    return dict(shape=label, ms=ms, device_us=dev_us, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


def phase_b1(dev):
    """Deposit kernel vs plain version: tiled and direct strips, mixed
    ratios, the main path's stack and its compacted block columns."""
    import torch

    from subpixal_tpu_torch.align import _compact_blocks
    from subpixal_tpu_torch.ops.drizzle import DRIZZLE_KERNELS

    worst = 0.0
    oshape = (1032, 1032)
    t1 = _deposit_planes(dev, 1, 1024, 1024, 0.3, (1.0,), 1)
    for kernel in DRIZZLE_KERNELS:
        for pixfrac in (1.0, 0.8):
            worst = max(worst, _b1_check(t1, oshape, (1.0,), kernel, pixfrac,
                                         "1024² tiled", direct=False))
    t30 = _deposit_planes(dev, 1, 1024, 1024, 30.0, (1.0,), 2)
    for kernel in ("square", "lanczos3"):
        worst = max(worst, _b1_check(t30, (1536, 1536), (1.0,), kernel, 1.0,
                                     "1024² rotated 30°", direct=True))
    mixed = (1.0, 0.5, 2.0, 1.0, 0.5, 2.0, 1.0, 1.0)
    tm = _deposit_planes(dev, 8, 256, 256, 0.3, mixed, 3)
    for kernel in DRIZZLE_KERNELS:
        for pixfrac in (1.0, 0.8):
            worst = max(worst, _b1_check(tm, (540, 540), mixed, kernel,
                                         pixfrac, "8 x 256² mixed ratios"))
        worst = max(worst, _b1_check(tm, (540, 540), mixed, kernel, 0.8,
                                     "8 x 256² mixed ratios",
                                     per_plane=True))
    # the main path's stack: 8 exposures of 1024², ratio 1, one launch;
    # per-plane on the align paths' reference grid, as Drizzle.execute
    ones = (1.0,) * 8
    t8 = _deposit_planes(dev, 8, 1024, 1024, 0.3, ones, 4)
    worst = max(worst, _b1_check(t8, oshape, ones, "square", 1.0,
                                 "8 x 1024² stack", direct=False))
    for kernel in ("square", "lanczos3"):
        worst = max(worst, _b1_check(t8, (1028, 1027), ones, kernel, 1.0,
                                     "8 x 1024² stack", direct=False,
                                     per_plane=True))
    # compacted as the sparse deposit stages it: half of each frame's
    # 16 x 128 blocks, (8, 256·16, 128) block columns
    rng = np.random.default_rng(5)
    idx = torch.tensor(np.stack([np.sort(rng.permutation(512)[:256])
                                 for _ in range(8)]), device=dev)
    valid = torch.ones(idx.shape, dtype=torch.bool, device=dev)
    cd, cw, cx, cy = _compact_blocks(t8["d"], t8["w"], t8["x"], t8["y"],
                                     idx, valid)
    tc = dict(d=cd.contiguous(), w=cw.contiguous(), x=cx.contiguous(),
              y=cy.contiguous())
    worst = max(worst, _b1_check(tc, oshape, ones, "square", 1.0,
                                 "8 x (256·16, 128) compacted",
                                 direct=False))
    times = [_b1_time({k: v[:1] for k, v in t1.items()}, oshape, (1.0,),
                      "1024², square, pixfrac 1"),
             _b1_time(t8, oshape, ones, "8 x 1024² stack, square, pixfrac 1"),
             _b1_time(t8, (1028, 1027), ones,
                      "8 x 1024² stack per-plane to (8, 1028, 1027), "
                      "square, pixfrac 1", per_plane=True),
             _b1_time(tc, oshape, ones,
                      "8 x (256·16, 128) compacted, square, pixfrac 1")]
    for r in times:
        r["max_abs_err"] = worst
    return times


def _b2_inputs(dev, B, n, seed, rot=0.2, shape=(1024, 1024)):
    """A 1024² frame of 200 stars and B (n, n) cutout grids: centers over
    the whole frame (edge cutouts go partly invalid), a rotation of
    ``rot`` degrees and a fractional offset per cutout."""
    import torch

    rng = np.random.default_rng(seed)
    H, W = shape
    image = rng.normal(0.0, 0.01, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for cx, cy in rng.uniform(0, W, (200, 2)):
        image += 25.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.48)
    th = np.deg2rad(rot)
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float64)
    cen = rng.uniform(-8, W + 8, (B, 2))
    off = rng.uniform(-0.5, 0.5, (B, 2))
    x = (np.cos(th) * gx - np.sin(th) * gy)[None] + (cen[:, 0] + off[:, 0]
                                                      - n / 2)[:, None, None]
    y = (np.sin(th) * gx + np.cos(th) * gy)[None] + (cen[:, 1] + off[:, 1]
                                                      - n / 2)[:, None, None]
    return (torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (image, x, y))


#: operations for one tap's weight on one axis, a sine or a divide counted
#: as one: the Lagrange basis in product form and the B-spline ~5, the
#: windowed sinc ~10 (two sines, two divides, the scale, the window test)
B2_WEIGHT_OPS = {"nearest": 0, "linear": 1, "poly3": 5, "poly5": 5,
                 "spline3": 5, "sinc": 10}


def _b2_bound(img, x, y, interp):
    """Bound of one gather: the image pixels the footprints need (the
    union of each cutout's footprint bounding box, clipped to the image),
    x and y read, values (f32) and validity (bytes) written; per output
    taps² multiply-adds and two axes of tap weights (``B2_WEIGHT_OPS``).
    Returns (ms, by, image pixels counted)."""
    from subpixal_tpu_torch.ops.interp import INTERP_OFFSETS

    offs = INTERP_OFFSETS[interp]
    H, W = img.shape
    fx = x.floor().flatten(1)
    fy = y.floor().flatten(1)
    x0 = (fx.amin(1) + offs[0]).clamp(0, W).long().tolist()
    x1 = (fx.amax(1) + offs[-1] + 1).clamp(0, W).long().tolist()
    y0 = (fy.amin(1) + offs[0]).clamp(0, H).long().tolist()
    y1 = (fy.amax(1) + offs[-1] + 1).clamp(0, H).long().tolist()
    cover = np.zeros((H, W), dtype=bool)
    for b in range(len(x0)):
        cover[y0[b]:y1[b], x0[b]:x1[b]] = True
    npix, n, taps = int(cover.sum()), x.numel(), len(offs)
    ms, by = bound(4 * npix + 8 * n + 5 * n,
                   n * (2 * taps * taps + 2 * B2_WEIGHT_OPS[interp] * taps))
    return ms, by, npix


def _sinc_guard_share(x, y, ok, sinscl):
    """Share of the valid queries whose sinc taps sum to under 1e-3 on an
    axis (where the kernel and the plain version take bilinear weights)."""
    import torch

    from subpixal_tpu_torch.ops.interp import INTERP_OFFSETS

    def tap_sum(c):
        t = (c - c.floor()).double()
        total = torch.zeros_like(t)
        for o in INTERP_OFFSETS["sinc"]:
            d = t - o
            total += torch.where(d.abs() >= 3.0, 0.0,
                                 torch.sinc(d / sinscl) * torch.sinc(d / 3.0))
        return total

    guard = ((tap_sum(x).abs() < 1e-3) | (tap_sum(y).abs() < 1e-3)) & ok
    return float(guard.sum()) / max(1, int(ok.sum()))


def _grid_sample_linear(img, x, y):
    """One PyTorch call computing the linear interpolant at interior
    points: grid_sample, bilinear, align_corners (pixel centers at -1, 1)."""
    import torch
    import torch.nn.functional as F

    H, W = img.shape
    grid = torch.stack([2.0 * x / (W - 1) - 1.0, 2.0 * y / (H - 1) - 1.0],
                       dim=-1).reshape(1, -1, x.shape[-1], 2)
    return F.grid_sample(img[None, None], grid, mode="bilinear",
                         align_corners=True)[0, 0]


#: the sinc's scales B2 is held to its plain version at, beside 1
B2_SINSCL = (2.0, 0.5)


def phase_b2(dev):
    """Gather kernel vs plain version: all six interpolants, and the sinc
    at ``B2_SINSCL``, on 512 cutouts of 32² and of 48² and on the 16 x
    256² bucket; times of every interpolant and of the sinc at sinscl 2
    at 512 x 32² (linear beside grid_sample), of poly5 at the others."""
    import torch

    from subpixal_tpu_torch.kernels.blot import sample_cutouts
    from subpixal_tpu_torch.ops.interp import (INTERP_TAPS,
                                               bspline3_prefilter,
                                               sample_image)

    out = []
    for B, n, seed in ((512, 32, 2), (512, 48, 4), (16, 256, 6)):
        img_t, x_t, y_t = _b2_inputs(dev, B, n, seed)
        H, W = img_t.shape
        worst_abs = 0.0
        cases = ([(i, 1.0) for i in INTERP_TAPS]
                 + [("sinc", s) for s in B2_SINSCL])
        for interp, s in cases:
            name = interp if s == 1.0 else f"sinc, sinscl {s}"
            v, ok, esc = sample_cutouts(img_t, x_t, y_t, interp=interp,
                                        sinscl=s)
            pv, pok = sample_image(img_t, x_t, y_t, interp=interp, sinscl=s)
            torch.cuda.synchronize()
            r, a = _rel_err(v, pv)
            same_valid = bool(torch.equal(ok, pok))
            guard = (f", {_sinc_guard_share(x_t, y_t, pok, s):.3%} of valid "
                     "queries on the bilinear guard" if s < 1.0 else "")
            print(f"B2 {B} x {n}² {name:16s}: rel err {r:.2e}, validity "
                  f"equal {same_valid} ({float(ok.float().mean()):.3f} "
                  f"valid), escaped {int(esc.sum())}{guard}")
            if not (r <= REL_TOL and same_valid) or int(esc.sum()) != 0:
                raise AssertionError(f"B2 {B} x {n}² {name} disagrees "
                                     "with the plain version")
            worst_abs = max(worst_abs, a)
        timed = ([(i, 1.0) for i in INTERP_TAPS] + [("sinc", 2.0)]
                 if n == 32 else [("poly5", 1.0)])
        for interp, s in timed:
            # spline3's prefilter is plain torch outside the kernel: time
            # the gather on the coefficients, as both versions take them
            pre = interp == "spline3"
            src = bspline3_prefilter(img_t).contiguous() if pre else img_t
            kw = dict(interp=interp, sinscl=s, prefiltered=pre)
            name = interp if s == 1.0 else f"sinc, sinscl {s}"

            def call():
                return sample_cutouts(src, x_t, y_t, **kw)

            ms = cuda_ms(call)
            dev_us = device_us(rotating(
                lambda *a: sample_cutouts(*a, **kw), src, x_t, y_t),
                "nearest_kernel" if interp == "nearest" else "gather_kernel")
            plain_ms = cuda_ms(lambda: sample_image(src, x_t, y_t, **kw))
            library_ms = None
            if interp == "linear":
                # grid_sample computes the same value where the footprint
                # lies inside the image (elsewhere it pads with zeros)
                v, ok, _ = call()
                gs = _grid_sample_linear(img_t, x_t, y_t).reshape(v.shape)
                r, _ = _rel_err(gs[ok], v[ok])
                print(f"B2 {B} x {n}² linear vs grid_sample on the "
                      f"{int(ok.sum())} interior points: rel err {r:.2e}")
                if not r <= LIBRARY_TOL:
                    raise AssertionError("grid_sample disagrees with B2")
                library_ms = cuda_ms(
                    lambda: _grid_sample_linear(img_t, x_t, y_t))
            bound_ms, by, npix = _b2_bound(img_t, x_t, y_t, interp)
            print(f"B2 {B} x {n}², {name}: wrapper {ms:.4f} ms, device "
                  f"{dev_us:.3f} us per launch, plain {plain_ms:.4f} ms, "
                  f"library {library_ms}, bound {bound_ms:.4f} ms ({by}; "
                  f"{npix} of {H * W} image pixels needed; "
                  f"{bound_ms * 1e3 / dev_us:.1%} of it reached)")
            out.append(dict(shape=f"{B} x {n}², {name}"
                            + (" (prefiltered)" if pre else ""),
                            max_abs_err=worst_abs, ms=ms, device_us=dev_us,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=by, library_ms=library_ms))
    return out


def phase_blot_sinc(dev):
    """``blot_image`` through a whole-frame pixmap (a 0.3° rotation and a
    fractional offset of a 1024² star frame, one row in three on fraction
    0.5) and ``blot_cutout`` (a 64 x 64 cutout onto a grid offset by a
    fraction of a pixel) with ``interp='sinc'`` at ``sinscl`` 0.5, 1.5 and
    2: one B2 launch each, held to the plain version (``blot_image``) and
    to the CPU run (``blot_cutout``)."""
    import torch

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.blot import blot_cutout, blot_image
    from subpixal_tpu_torch.cutout import Cutout
    from subpixal_tpu_torch.ops.interp import sample_image
    from subpixal_tpu_torch.wcs import TanWCS

    img, _, _ = _b2_inputs(dev, 1, 8, 12)
    th = np.deg2rad(0.3)
    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float64)
    px = np.cos(th) * xx - np.sin(th) * yy + 3.37
    py = np.sin(th) * xx + np.cos(th) * yy - 2.61
    px[::3] = np.floor(px[::3]) + 0.5
    px, py = (torch.tensor(a, dtype=torch.float32, device=dev)
              for a in (px, py))
    cd = (0.05 / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    w = TanWCS(crpix=np.array([512.0, 512.0]), crval=np.array([150.0, 2.0]),
               cd=cd)
    src = Cutout(img.cpu().numpy()[480:544, 480:544], w)
    dst = Cutout(np.zeros((48, 40), np.float32),
                 w.with_shifted_crpix(10.3, 7.6), blc=(7, 10))
    for sinscl in (0.5, 1.5, 2.0):
        kernels.reset_launch_counts()
        v, ok = blot_image(img, px, py, interp="sinc", sinscl=sinscl)
        got = blot_cutout(src, dst, interp="sinc", sinscl=sinscl,
                          device=dev)
        torch.cuda.synchronize()
        n = kernels.LAUNCHES["blot_gather"]
        pv, pok = sample_image(img, px, py, interp="sinc", sinscl=sinscl)
        want = blot_cutout(src, dst, interp="sinc", sinscl=sinscl,
                           device="cpu")
        r_img = _rel_err(v, pv)[0]
        r_cut = _rel_err(torch.tensor(got.data), torch.tensor(want.data))[0]
        same = bool(torch.equal(ok, pok)) and bool(
            np.array_equal(got.mask, want.mask))
        print(f"blot_image / blot_cutout, sinc, sinscl {sinscl}: rel err "
              f"{r_img:.2e} / {r_cut:.2e}, validity equal {same} "
              f"({float(ok.float().mean()):.3f} / {float(got.mask.mean()):.3f}"
              f" valid), B2 launches {n}")
        if not (r_img <= REL_TOL and r_cut <= REL_TOL and same and n == 2):
            raise AssertionError(f"blot_image / blot_cutout at sinc sinscl "
                                 f"{sinscl} disagree or missed B2")


def _b3_flops(B, H, W, nwin, ny, nx):
    """Least f32 operations of B3's function on B pairs: each side's
    normalisation and its half-spectrum as a real FFT (~2.5 N log2 N, not
    the kernel's direct DFT), then the matrix DFTs of the coarse lags and
    the window, which an FFT would not shorten."""
    Wr = W // 2 + 1
    per = (2 * (2.5 * H * W * np.log2(H * W) + 8 * H * W)  # both sides
           + 8 * H * Wr                                      # G
           + ny * Wr * H * 8 + ny * nx * Wr * 5              # coarse lags
           + 12 * H * Wr                                     # twist
           + nwin * Wr * H * 8 + nwin * nwin * Wr * 4)       # window
    return B * per


def _b3_inputs(dev, B, n, shift, sigma, masked, seed):
    """Star cutout pairs of n x n (or an (H, W) pair: n), img shifted by
    up to ``shift`` px, with masks."""
    import torch

    H, W = (n, n) if np.ndim(n) == 0 else n
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx = rng.uniform(-shift, shift, B)[:, None, None]
    dy = rng.uniform(-shift, shift, B)[:, None, None]

    def star(ox, oy):
        return np.exp(-((xx - W / 2 - ox) ** 2 + (yy - H / 2 - oy) ** 2)
                      / (2 * sigma ** 2))

    refs = star(0.0, 0.0)[None] + rng.normal(0, 1e-3, (B, H, W))
    imgs = star(dx, dy) + rng.normal(0, 1e-3, (B, H, W))
    t = [torch.tensor(a, dtype=torch.float32, device=dev)
         for a in (refs, imgs)]
    mask = None
    if masked:  # the align loop's masks: bool, shared by both sides
        mask = torch.tensor(rng.random((B, H, W)) > 0.05, device=dev)
    return t[0], t[1], mask


def phase_b3(dev):
    """Both measurement kernels vs the plain torch.fft chain."""
    import torch

    from subpixal_tpu_torch.kernels.measure import (kernel_route,
                                                    measure_window)
    from subpixal_tpu_torch.ops.correlate import measure_window as plain
    from subpixal_tpu_torch.ops.peaks import normalize_search_box

    out = []
    # (label, B, n, usfac, masked, sigma, seed, the route taken, and the
    # kernel asked for: None picks by shape; the mixed-radix kernel asked
    # for at 32² and 64² times it beside the FFT kernel on the same pairs)
    for label, B, n, usfac, masked, sigma, seed, route, ask in (
            ("512 x 32², masked NCC, usfac 8", 512, 32, 8, True, 1.6, 3,
             "fft", None),
            ("512 x 32², masked NCC, usfac 8", 512, 32, 8, True, 1.6, 3,
             "mixed_radix", "mixed_radix"),
            ("500 x 64², unmasked NCC, usfac 10", 500, 64, 10, False, 2.0,
             0, "fft", None),
            ("500 x 64², unmasked NCC, usfac 10", 500, 64, 10, False, 2.0,
             0, "mixed_radix", "mixed_radix"),
            ("512 x 48², masked NCC, usfac 8", 512, 48, 8, True, 3.0, 5,
             "mixed_radix", None),
            ("512 x 128², masked NCC, usfac 8", 512, 128, 8, True, 3.0, 9,
             "mixed_radix", None),
            ("16 x 256², masked NCC, usfac 8", 16, 256, 8, True, 1.6, 7,
             "mixed_radix", None)):
        ref, img, m = _b3_inputs(dev, B, n, 0.45, sigma, masked, seed)
        bounds = normalize_search_box("fitbox", n, n, 5)
        nwin = -(-(usfac + 5 + 1) // 8) * 8
        ny, nx = bounds[1] - bounds[0], bounds[3] - bounds[2]
        rt = kernel_route(B, n, n, nwin, bounds, kernel=ask)
        if rt.kernel != route:
            raise AssertionError(f"B3 {label} takes {rt}, expected {route}")
        which = (f"{rt.kernel}{' asked for' if ask else ''}, {rt.cluster} "
                 "CTAs a pair" + (", global workspace" if rt.workspace
                                  else ""))
        kw = dict(cc_type="NCC", usfac=usfac, nwin=nwin, bounds=bounds)
        c2, sy, sx = measure_window(ref, img, m, m, kernel=ask, **kw)
        pc2, psy, psx = plain(ref, img, m, m, **kw)
        torch.cuda.synchronize()
        err = float((c2 - pc2).abs().max())
        scale = float(pc2.abs().max())
        same_s0 = bool(torch.equal(sy, psy) and torch.equal(sx, psx))
        print(f"B3 {label} ({which}): max |C2 - plain| {err:.3e} "
              f"({err / scale:.2e} of max |C2|), s0 equal {same_s0}")
        if not (err <= C2_TOL * scale and same_s0):
            raise AssertionError(f"B3 {label} disagrees with the plain "
                                 "version")
        def call(r, i, mk):
            return measure_window(r, i, mk, mk, kernel=ask, **kw)

        ms = cuda_ms(lambda: call(ref, img, m))
        dev_us = device_us(rotating(call, ref, img, m), "measure")
        plain_ms = cuda_ms(lambda: plain(ref, img, m, m, **kw))
        # ref, img (f32) and the shared bool mask read; C2, s0 written
        nbytes = B * (n * n * (8 + masked) + 4 * nwin * nwin + 8)
        bound_ms, by = bound(nbytes, _b3_flops(B, n, n, nwin, ny, nx))
        print(f"B3 {label}: wrapper {ms:.4f} ms, device {dev_us:.3f} us per "
              f"launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}, {bound_ms * 1e3 / dev_us:.1%} of it reached)")
        out.append(dict(shape=f"{label} ({which})", max_abs_err=err, ms=ms,
                        device_us=dev_us, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by, library_ms=None))
    return out


#: cutout sides of B3's route sweep, up to 512: the FFT kernel's,
#: multiples of 16, large prime factors (7·16, 2·127, 127, 509), odd
SWEEP_SIDES = (16, 24, 32, 45, 48, 64, 96, 112, 127, 128, 200, 254, 256,
               384, 509, 512)
#: upsampling factors of the sweep (nwin 16, 16, 32, 56, 112 at the
#: default fit box of 5)
SWEEP_USFAC = (8, 10, 20, 50, 100)


def route_name(shape, usfac=1, peak_fit_box=5, peak_search_box="fitbox",
               **_):
    """The route ``find_displacement`` takes for a (B, H, W) batch on the
    card: torch.fft (``usfac`` 1), kernel B3 (which kernel, its CTAs a
    pair, a global workspace), or the full surface (a box or a shape
    ``window_fits`` refuses)."""
    from subpixal_tpu_torch.kernels.measure import kernel_route
    from subpixal_tpu_torch.ops.correlate import window_route

    B, H, W = shape
    if usfac <= 1:
        return "torch.fft (usfac 1)"
    bounds, nwin, windowed = window_route(H, W, usfac, peak_fit_box,
                                          peak_search_box)
    if not windowed:
        return f"full surface (torch.fft; nwin {nwin})"
    rt = kernel_route(B, H, W, nwin, bounds)
    return (f"B3 {rt.kernel}, {rt.cluster} CTAs a pair"
            + (", global workspace" if rt.workspace else "")
            + f" (nwin {nwin})")


def route_spy(routes):
    """A patch of the align loop's ``find_displacement`` that appends
    each batch's (shape, :func:`route_name`) to ``routes``."""
    from subpixal_tpu_torch import blot as blot_mod

    fd = blot_mod.find_displacement

    def spy(ref, img, *a, **k):
        routes.append((tuple(ref.shape), route_name(tuple(ref.shape), **k)))
        return fd(ref, img, *a, **k)

    return mock.patch.object(blot_mod, "find_displacement", spy)


def phase_b3_routes(dev):
    """B3's shape limit: the host plan (``measure_window_plan``) against
    the port's shape rule (``ops.correlate.window_fits``) on every pair of
    ``SWEEP_SIDES`` at every ``SWEEP_USFAC`` under the 'fitbox' (5 x 5)
    and a 17 x 17 box, at 1 and 512 pairs; then the package's
    ``find_displacement`` at shapes on both sides of the limit, held to
    the plain one on the card, with its route and launches."""
    import torch

    from subpixal_tpu_torch import find_displacement, kernels
    from subpixal_tpu_torch.kernels.measure import _PLAN, _lib
    from subpixal_tpu_torch.ops.correlate import find_displacement as plain
    from subpixal_tpu_torch.ops.correlate import window_fits

    plan_fn = _lib().measure_window_plan
    total, refused = 0, set()
    for B, H, W, usfac, box in itertools.product(
            (1, 512), SWEEP_SIDES, SWEEP_SIDES, SWEEP_USFAC, (5, 17)):
        nwin = -(-(usfac + 6) // 8) * 8
        nws = plan_fn(B, H, W, nwin, box, box, -1, _PLAN())
        total += 1
        if (nws >= 0) != window_fits(H, W, nwin, box, box):
            raise AssertionError(f"B3's plan and window_fits disagree at "
                                 f"B={B}, {H} x {W}, nwin {nwin}, box {box}")
        if nws < 0:
            refused.add((H, W, usfac, box))
    by_usfac = {u: sum(1 for r in refused if r[2] == u) for u in SWEEP_USFAC}
    least = min(refused, key=lambda r: r[0] * r[2])
    print(f"B3 route sweep: {total} (B, H, W, usfac, box) combinations, "
          f"the plan refuses {2 * len(refused)}, exactly those window_fits "
          f"refuses; refused (H, W, box) per usfac {by_usfac}; smallest H "
          f"refused: {min(r[0] for r in refused)} (at usfac "
          f"{max(r[2] for r in refused if r[0] == least[0])}), smallest "
          f"usfac refused: {min(r[2] for r in refused)}")
    if any(r[2] <= 10 for r in refused):
        raise AssertionError("B3 refuses a shape at usfac 8 or 10")
    for B, H, W, usfac, masked in ((6, 112, 112, 8, True),
                                   (3, 112, 254, 10, True),
                                   (3, 509, 384, 8, False),
                                   (2, 512, 512, 42, True),
                                   (2, 512, 512, 50, True),
                                   (2, 256, 256, 100, False)):
        ref, img, m = _b3_inputs(dev, B, (H, W), 0.45, 2.0, masked, H + W)
        kw = dict(usfac=usfac, fit_type="gaussian", ref_mask=m, img_mask=m)
        route = route_name((B, H, W), usfac)
        before = kernels.LAUNCHES["measure_displacement"]
        d = find_displacement(ref, img, **kw)
        torch.cuda.synchronize()
        n = kernels.LAUNCHES["measure_displacement"] - before
        dp = plain(ref, img, **kw)
        diff = max(float((d.dx - dp.dx).abs().max()),
                   float((d.dy - dp.dy).abs().max()))
        print(f"B3 find_displacement {B} x {H} x {W}, usfac {usfac}, "
              f"{'masked' if masked else 'unmasked'}: {route}, {n} B3 "
              f"launches, max |d - plain| {diff:.3e} px, fit ok "
              f"{bool(d.fit_ok.all())}")
        fits = window_fits(H, W, -(-(usfac + 6) // 8) * 8, 5, 5)
        if n != int(fits) or not diff < 1e-3 or not bool(d.fit_ok.all()):
            raise AssertionError(f"B3 find_displacement {B} x {H} x {W} at "
                                 f"usfac {usfac}: {n} launches, {diff} px")


def _plain_deposit(*args, use_pallas=None, **kw):
    import torch

    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit

    s, w = drizzle_deposit(*args, **kw)
    return s, w, torch.zeros((), dtype=torch.int32, device=s.device)


def _plain_deposit_stack(*args, use_pallas=None, **kw):
    import torch

    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack

    s, w = drizzle_deposit_stack(*args, **kw)
    return s, w, torch.zeros(args[0].shape[0], dtype=torch.int32,
                             device=s.device)


def _plain_gather(image, x, y, interp="poly5", fill=0.0, prefiltered=False,
                  sinscl=1.0, row0=0, use_pallas=None):
    import torch

    from subpixal_tpu_torch.ops.interp import sample_image

    v, ok = sample_image(image, x, y, interp=interp, fill=fill,
                         sinscl=sinscl, prefiltered=prefiltered, row0=row0)
    return v, ok, torch.zeros(x.shape[0], dtype=torch.int32,
                              device=x.device)


def _plain_measure(*args, use_pallas=None, **kw):
    from subpixal_tpu_torch.ops.correlate import measure_window

    return measure_window(*args, **kw)


def _plain_versions():
    """Patches under which the align path (setup drizzle, loop) runs the
    kernels' plain versions on the card."""
    from contextlib import ExitStack

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch import blot as blot_mod
    from subpixal_tpu_torch import resample as resample_mod

    patches = [
        (align_mod, "drizzle_deposit_stack", _plain_deposit_stack),
        (blot_mod, "sample_cutouts", _plain_gather),
        (blot_mod, "measure_window", _plain_measure),
        (resample_mod, "drizzle_deposit", _plain_deposit),
        (resample_mod, "drizzle_deposit_stack", _plain_deposit_stack)]
    try:  # the spatial mosaics' band deposits and band gathers
        from subpixal_tpu_torch.parallel import spatial as spatial_mod
    except ImportError:  # a checkout from before the spatial mosaics
        spatial_mod = None
    if spatial_mod is not None:
        patches += [
            (spatial_mod, "drizzle_deposit_stack", _plain_deposit_stack),
            (spatial_mod, "sample_cutouts", _plain_gather)]
    stack = ExitStack()
    for mod, name, fn in patches:
        stack.enter_context(mock.patch.object(mod, name, fn))
    # a graph cached before the patches would replay the kernels, and one
    # captured under them would replay the plain versions after
    cold_loop()
    cold_programs()
    stack.callback(cold_loop)
    stack.callback(cold_programs)
    return stack


def cold_loop():
    """Empty the align loop's cache of captured graphs (where the package
    has one), so that the next call captures its own."""
    from subpixal_tpu_torch import align as align_mod

    getattr(align_mod, "_LOOP_CACHE", {}).clear()


#: the CUDA kernel each wrapper launches once a call, by launch count: a
#: pattern of the profiler's demangled names (PyTorch's own
#: ``vectorized_gather_kernel`` is not B2)
KERNEL_NAMES = {"drizzle_deposit": r"\bdeposit_tiles<",
                "blot_gather": r"\b(gather_kernel<|nearest_kernel\()",
                "measure_displacement": r"\bmeasure_(fft|mixed)_kernel<"}


def check_loop(label, bd, n, mode="graph", cached=False):
    """The fixed-point loop of a call (``bd``: its setup breakdown, ``n``:
    its iterations), by ``mode``: 'graph', a one-card device loop, and
    'nccl', the device loop under a mesh whose collectives NCCL runs (the
    ranks' agreement to capture or replay is one of its reads): each
    entry (1, plus one a sparse self-heal) run as a CUDA graph with at
    most ⌈n/4⌉ + 1 host reads, and ``loop_compile`` in the setup
    breakdown; without ``cached`` (a call after :func:`cold_loop`, or on
    a new group) each entry captured once, its first iteration eager and
    the graph replayed for the others, n_iterations − entries replays in
    all; with ``cached`` (a second call of the same shapes) each entry
    served by the cached graph, replayed n_iterations times. 'eager', the
    device loop under a gloo mesh (or with capture turned off): no
    capture, at most ⌈n/4⌉ + 1 host reads an entry; 'host', the host
    loop: no capture. Prints what it checks."""
    graphs = bd.get("loop_graphs", 0)
    hits = bd.get("loop_graph_hits", 0)
    reads = bd.get("loop_host_reads", 0)
    entries = 1 + int(bd.get("sparse_heals", 0))
    cap = entries * (-(-n // 4) + 1)
    if mode not in ("graph", "nccl"):
        print(f"{label}: {mode} loop, {n} iterations, no graph, {reads} "
              f"host reads and {bd.get('loop_steps')} steps by the device "
              "loop")
        if graphs or hits or "loop_compile" in bd or (
                mode == "eager" and not 0 < reads <= cap):
            raise AssertionError(f"{label}: the {mode} loop: {bd}")
        return
    how = " with its NCCL collectives" if mode == "nccl" else ""
    print(f"{label}: loop as a CUDA graph{how}: {graphs} capture(s), "
          f"{hits} cached, {bd.get('loop_replays')} "
          f"replays, {reads} host reads, loop_compile "
          f"{bd.get('loop_compile', float('nan')):.4f} s, {n} iterations")
    if ((hits, graphs) != ((entries, 0) if cached else (0, entries))
            or bd.get("loop_replays") != n - graphs
            or reads > cap or "loop_compile" not in bd):
        raise AssertionError(
            f"{label}: the loop did not run as a "
            f"{'cached' if cached else 'captured'} graph replayed "
            f"n_iterations{'' if cached else ' - 1'} times with at most "
            f"ceil(n/4) + 1 host reads an entry: {bd}")


def eager_loop():
    """A context under which the align loop captures nothing (the private
    ``capture`` argument of ``align._fixed_point``): under a mesh, the
    masked step run eagerly at the same cadence, the parent's loop."""
    import functools

    from subpixal_tpu_torch import align as align_mod

    return mock.patch.object(align_mod, "_fixed_point", functools.partial(
        align_mod._fixed_point, capture=False))


def loop_mode(mesh) -> str:
    """check_loop's mode for the device loop under ``mesh``."""
    import torch.distributed as dist

    return ("nccl" if dist.get_backend(mesh.group()) == "nccl"
            else "eager")


def check_eager(label, res, eager):
    """The captured mesh loop (``res``) against the same call with capture
    turned off (``eager``): every iteration's shifts within 1e-4 px (the
    host-vs-device bar), equal iterations and ``nmatches``."""
    d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
            for ra, rb in zip(res.history, eager.history)
            for a, b in zip(ra, rb))
    print(f"{label}: captured vs eager mesh loop: max |dshift| {d:.3e} px, "
          f"{res.n_iterations} / {eager.n_iterations} iterations; eager "
          f"{1e3 * eager.history[-1][0].iter_s:.3f} ms per iteration")
    if (not d < 1e-4 or res.n_iterations != eager.n_iterations
            or len(res.history) != len(eager.history)
            or any(a.nmatches != b.nmatches
                   for ra, rb in zip(res.history, eager.history)
                   for a, b in zip(ra, rb))):
        raise AssertionError(f"{label}: the captured loop differs from the "
                             f"eager one by {d} px")
    return d


def eager_record(label, eager, res):
    """A rank's record of its call with capture turned off (None: not
    run), held to its captured call ``res`` (:func:`check_eager`)."""
    if eager is None:
        return None
    return dict(n_iterations=eager.n_iterations,
                diff=check_eager(label, res, eager),
                iter_ms=1e3 * eager.history[-1][0].iter_s,
                setup_breakdown=eager.setup_breakdown)


def check_loop_record(label, r):
    """check_loop on a rank's record: its first call (captured under NCCL:
    a new process or group), its second (cached), and under NCCL its
    call with capture turned off (eager, held to the first by
    :func:`check_eager` in the rank)."""
    mode = r["loop_mode"]
    check_loop(label, r["setup_breakdown"], r["n_iterations"], mode)
    check_loop(f"{label}, second call", r["warm_setup_breakdown"],
               r["warm_n_iterations"], mode, cached=True)
    if mode == "nccl":
        e = r["eager"]
        check_loop(f"{label}, capture off", e["setup_breakdown"],
                   e["n_iterations"], "eager")
        print(f"{label}: captured vs eager mesh loop: max |dshift| "
              f"{e['diff']:.3e} px; eager {e['iter_ms']:.3f} ms per "
              "iteration")


def check_ranks_loop(label, recs):
    """Every rank of a mesh ran as many masked steps as every other, in
    each of its calls (the ranks' collectives stay in step)."""
    for key in ("setup_breakdown", "warm_setup_breakdown"):
        steps = [r[key].get("loop_steps") for r in recs]
        if len(set(steps)) != 1:
            raise AssertionError(f"{label}: the ranks ran {steps} steps")


def phase_align(dev, label, expect, sigma=1.8, measured=None, iters=4,
                finder="device", **config):
    """align_images on 8 x 1024², 60 stars of width ``sigma``, ``iters``
    iterations, on the card.

    ``expect`` names the kernels this path must launch; ``measured`` is
    None or ((B, H, W), kernel): the batch B3 must measure each iteration
    and the kernel it must take; ``finder`` the source finder setup must
    run ('device': the device finder, counted by a spy; 'host': never the
    device finder). Returns the launch counts of the first call and its
    result."""
    import torch

    from subpixal_tpu_torch import catalogs_device, kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11, sigma=sigma)
    kw = dict(exposures=exps, device=dev, eps_shift=1e-7, **config)
    finds = []
    device_finder = catalogs_device.find_sources_device

    def finder_spy(image, *a, **k):  # the device finder's calls
        finds.append(image.device.type)
        return device_finder(image, *a, **k)

    routes = []
    cold_loop()
    kernels.reset_launch_counts()
    t0 = time.time()
    with mock.patch.object(catalogs_device, "find_sources_device",
                           finder_spy), route_spy(routes):
        res = align_images(max_iterations=iters, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"{label}: launches {launches}, wall {wall:.2f} s, device "
          f"finder calls {finds}")
    print(f"{label}: measurement routes {sorted(set(routes))}")
    if (finder == "device") != bool(finds) or \
            any(d != "cuda" for d in finds):
        raise AssertionError(f"{label}: setup ran the device finder on "
                             f"{finds}, expected the {finder} finder")
    if measured is not None:
        shape, kernel = measured
        if {sh for sh, _ in routes} != {shape} or any(
                not r.startswith(f"B3 {kernel},") for _, r in routes):
            raise AssertionError(f"{label}: measured {sorted(set(routes))}"
                                 f", expected {shape} by B3's {kernel}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    # B1: one per-plane launch for the initial drizzle (the stacked
    # execute), then the whole stack in one launch per iteration, or once
    # per exposure under otf; under otf B2 (and B3) measure one exposure's
    # set a launch
    otf = config.get("wcsupdate") == "otf"
    per_iter = len(exps) if otf else 1
    if launches["drizzle_deposit"] != 1 + per_iter * res.n_iterations:
        raise AssertionError(f"{label}: {launches['drizzle_deposit']} B1 "
                             f"launches for {len(exps)} exposures and "
                             f"{res.n_iterations} iterations")
    if otf and any(launches[k] != per_iter * res.n_iterations
                   for k in expect if k != "drizzle_deposit"):
        raise AssertionError(f"{label}: {launches} for {res.n_iterations} "
                             "otf iterations")
    shifts = np.asarray(res.shifts)
    if shifts.shape != (8, 2) or not np.isfinite(shifts).all():
        raise AssertionError(f"bad shifts {shifts}")
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    iter_ms = 1e3 * res.history[-1][0].iter_s
    print(f"{label}: setup_s {res.setup_s:.3f}, {res.n_iterations} "
          f"iterations at {iter_ms:.3f} ms each, fit error "
          f"{err_mpix:.3f} mpix, sources {res.history[0][0].nmatches}")
    print(f"{label}: setup_breakdown " + json.dumps(
        {k: round(v, 4) for k, v in res.setup_breakdown.items()}))
    if res.n_iterations != iters or not err_mpix < 10.0:
        raise AssertionError(f"{label}: {res.n_iterations} iterations, "
                             f"error {err_mpix} mpix")
    mode = ("host" if config.get("device_loop", "auto") is False
            else loop_mode(config["mesh"]) if "mesh" in config else "graph")
    check_loop(label, res.setup_breakdown, res.n_iterations, mode)
    # the first call in a process pays cuFFT plans and lazy kernel loads;
    # a second call shows the steady state
    warm = align_images(max_iterations=iters, **kw)
    warm_ms = 1e3 * warm.history[-1][0].iter_s
    print(f"{label}, second call: setup_s {warm.setup_s:.3f}, "
          f"{warm_ms:.3f} ms per iteration")
    check_loop(f"{label}, second call", warm.setup_breakdown,
               warm.n_iterations, mode, cached=True)
    if mode == "nccl":  # the parent's loop: the masked step, eagerly
        with eager_loop():
            eager = align_images(max_iterations=iters, **kw)
        check_loop(f"{label}, capture off", eager.setup_breakdown,
                   eager.n_iterations, "eager")
        check_eager(label, res, eager)
    print(f"{label}, second call: setup_breakdown " + json.dumps(
        {k: round(v, 4) for k, v in warm.setup_breakdown.items()}))
    # the same run forced through the plain versions on the card
    with _plain_versions():
        res_p = align_images(max_iterations=1, **kw)
    d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
            for a, b in zip(res.history[0], res_p.history[0]))
    print(f"{label}: first-iteration shifts vs plain versions: "
          f"max |diff| {d:.3e} px")
    if not d < 1e-3:
        raise AssertionError(f"{label}: first iteration differs from the "
                             f"plain run by {d} px")
    return launches, res


def phase_use_pallas_false(dev):
    """The new path's scene (8 x 1024², 60 stars, phase 9's
    configuration, 4 iterations) through ``align_images(...,
    use_pallas=False)`` on the card: zero kernel launches, every
    iteration's shifts within 1e-6 px of the same call under
    ``_plain_versions`` (the wrappers patched to their plain versions),
    fit error under 10 mpix, warm ms an iteration printed beside the
    kernels' (the default call). Then ``Drizzle(..., use_pallas=False)
    .execute()``: zero B1 launches, planes within REL_TOL of the plain
    per-plane run, and the default ``Drizzle`` still launching B1.
    Returns the launch counts of the first call and its result."""
    import torch

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.resample import Drizzle
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    label = "use_pallas=False path"
    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11)
    kw = dict(exposures=exps, device=dev, eps_shift=1e-7, max_iterations=4,
              **NEW_PATH)
    cold_loop()
    kernels.reset_launch_counts()
    res = align_images(use_pallas=False, **kw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    warm = align_images(use_pallas=False, **kw)
    warm_k = align_images(**kw)
    with _plain_versions():
        res_p = align_images(**kw)
    d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
            for ra, rb in zip(res.history, res_p.history)
            for a, b in zip(ra, rb))
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    print(f"{label}: launches {launches}, {res.n_iterations} iterations, "
          f"fit error {err_mpix:.3f} mpix, setup_s {res.setup_s:.3f}; "
          f"every iteration vs the _plain_versions run: max |diff| "
          f"{d:.3e} px")
    print(f"{label}, second call: {1e3 * warm.history[-1][0].iter_s:.3f} "
          f"ms per iteration, setup_s {warm.setup_s:.3f}; the kernels' "
          f"(use_pallas='auto') second call: "
          f"{1e3 * warm_k.history[-1][0].iter_s:.3f} ms per iteration, "
          f"setup_s {warm_k.setup_s:.3f}")
    if any(launches.values()):
        raise AssertionError(f"{label} launched {launches}")
    check_loop(label, res.setup_breakdown, res.n_iterations)
    check_loop(f"{label}, second call", warm.setup_breakdown,
               warm.n_iterations, cached=True)
    if res.n_iterations != 4 or len(res.history) != len(res_p.history) \
            or not d < 1e-6:
        raise AssertionError(f"{label}: {res.n_iterations} iterations, "
                             f"{d} px from the plain versions' run")
    if not err_mpix < 10.0:
        raise AssertionError(f"{label}: fit error {err_mpix} mpix")
    kernels.reset_launch_counts()
    dz = Drizzle(exps, device=dev, use_pallas=False)
    dz.execute()
    torch.cuda.synchronize()
    n_plain = kernels.LAUNCHES["drizzle_deposit"]
    with _plain_versions():
        dp = Drizzle(exps, device=dev)
        dp.execute()
    kernels.reset_launch_counts()
    dk = Drizzle(exps, device=dev)
    dk.execute()
    torch.cuda.synchronize()
    n_default = kernels.LAUNCHES["drizzle_deposit"]
    errs = [_rel_err(dz._per_exp[e.name][i], dp._per_exp[e.name][i])[0]
            for e in exps for i in (0, 1)]
    print(f"{label}: Drizzle.execute B1 launches {n_plain} "
          f"(use_pallas=False), {n_default} (default); planes vs the plain "
          f"per-plane run: max rel err {max(errs):.3e}; stacked: "
          f"{'deposit_stack' in dz.last_execute_breakdown}")
    if n_plain != 0 or n_default != 1 or not max(errs) <= REL_TOL:
        raise AssertionError(f"{label}: Drizzle launches {n_plain} / "
                             f"{n_default}, planes off by {max(errs)}")
    return launches, res


def phase_device_scene(dev, host_run):
    """Phase 9's scene rendered on the card (``simulate_stack(device=
    'cuda')``): ``planted`` equal to the host render's, the frames CUDA
    tensors, and the new path on it to under 10 mpix. Prints setup_s of a
    warm call and the host-to-device copies of a profiled call for the
    device- and the host-rendered scene. Returns the launch counts of the
    first call and its result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    label = "device-rendered scene"
    scene = dict(n_exp=8, shape=(1024, 1024), n_stars=60, seed=11)
    t0 = time.time()
    dexps, dplanted = simulate_stack(device=dev, **scene)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    t0 = time.time()
    hexps, hplanted = simulate_stack(**scene)
    host_render_s = time.time() - t0
    if dplanted != hplanted or any(
            not isinstance(e.data, torch.Tensor) or e.data.device.type
            != torch.device(dev).type for e in dexps):
        raise AssertionError(f"{label}: planted {dplanted} vs {hplanted}, "
                             f"frames {[type(e.data) for e in dexps]}")
    kw = dict(device=dev, eps_shift=1e-7, max_iterations=4, **NEW_PATH)
    cold_loop()
    kernels.reset_launch_counts()
    res = align_images(exposures=dexps, **kw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, dplanted)
    d_host = float(np.abs(res.shifts - host_run.shifts).max())
    out = {}
    for name, exps in (("device", dexps), ("host", hexps)):
        warm = align_images(exposures=exps, **kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            align_images(exposures=exps, **kw)
            torch.cuda.synchronize()
        h2d = [e for e in prof.key_averages() if "HtoD" in e.key]
        out[name] = (warm.setup_s, sum(e.count for e in h2d))
    print(f"{label}: render {render_s:.3f} s on the card, "
          f"{host_render_s:.3f} s on the host; launches {launches}, fit "
          f"error {err_mpix:.3f} mpix, shifts vs the host scene's run "
          f"(other noise) {d_host:.3e} px")
    print(f"{label}: warm setup_s {out['device'][0]:.4f} with "
          f"{out['device'][1]} host-to-device copies a call; host-rendered "
          f"scene: setup_s {out['host'][0]:.4f} with {out['host'][1]}")
    if res.n_iterations != 4 or not err_mpix < 10.0:
        raise AssertionError(f"{label}: {res.n_iterations} iterations, fit "
                             f"error {err_mpix} mpix")
    check_loop(label, res.setup_breakdown, res.n_iterations)
    return launches, res


def phase_mesh_one_rank(dev, ref):
    """Phase 14: phase 9's configuration (``ref``: its result) under
    ``mesh=make_mesh(1)``, one NCCL rank. Returns the launch counts and
    the result."""
    import torch.distributed as dist

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1)
    backend = dist.get_backend(mesh.group())
    print(f"mesh path, one rank: {mesh}, backend {backend}")
    if backend != "nccl":
        raise AssertionError(f"make_mesh(1) on the card took {backend}")
    try:
        launches, res = phase_align(
            dev, "mesh path, one NCCL rank", tuple(kernels.LAUNCHES),
            mesh=mesh, **NEW_PATH)
    finally:
        dist.destroy_process_group()
    n = res.n_iterations
    if launches["blot_gather"] != n or launches["measure_displacement"] != n:
        raise AssertionError(f"mesh path, one rank: {launches} for {n} "
                             "iterations")
    d = float(np.abs(np.asarray(res.shifts) - np.asarray(ref.shifts)).max())
    print(f"mesh path, one rank, vs phase 9 without a mesh: max |dshift| "
          f"{d:.3e} px")
    if not d < 5e-4:
        raise AssertionError(f"the one-rank mesh differs from phase 9 by "
                             f"{d} px")
    return launches, res


#: one rank of phase 9's configuration under ``mesh=``: argv[4] is the
#: backend, argv[5] the rank's device ('auto': cuda:LOCAL_RANK)
_MESH_RANK = r"""
import json, sys, time
from unittest import mock

import numpy as np
import torch

from subpixal_tpu_torch import align_images, catalogs_device, kernels
from subpixal_tpu_torch.parallel import init_distributed, make_mesh
from subpixal_tpu_torch.testing import pairwise_shift_errors, simulate_stack

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(addr, world, rank, backend=sys.argv[4])
mesh = make_mesh(world, device=None if sys.argv[5] == "auto" else sys.argv[5])
exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                               seed=11)
kw = dict(exposures=exps, mesh=mesh, device="cuda", eps_shift=1e-7,
          max_iterations=4, fitgeom="shift", usfac=8, fit_type="gaussian")
finds = []
finder = catalogs_device.find_sources_device


def spy(image, *a, **k):
    finds.append(image.device.type)
    return finder(image, *a, **k)


from chip_smoke import (_plain_versions, eager_loop, eager_record, loop_mode,
                        route_spy)

routes = []
kernels.reset_launch_counts()
t0 = time.time()
with mock.patch.object(catalogs_device, "find_sources_device", spy), \
        route_spy(routes):
    res = align_images(**kw)
torch.cuda.synchronize()
wall = time.time() - t0
launches = dict(kernels.LAUNCHES)
warm = align_images(**kw)
eager = None
if loop_mode(mesh) == "nccl":  # the same call with capture turned off
    with eager_loop():
        eager = align_images(**kw)
# the first iteration forced through the kernels' plain versions on the
# card: B1 on this rank's frames, B2 and B3 on its block of the cutout rows

with _plain_versions():
    res_p = align_images(**dict(kw, max_iterations=1))
plain_diff = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
                 for a, b in zip(res.history[0], res_p.history[0]))
print("RESULT " + json.dumps(dict(
    rank=rank, device=str(mesh.device), launches=launches, finds=finds,
    routes=sorted(set(routes)), wall=wall, plain_diff=plain_diff,
    shifts=np.asarray(res.shifts).tolist(), n_iterations=res.n_iterations,
    err_mpix=1e3 * pairwise_shift_errors(res.shifts, planted),
    nmatches=res.history[0][0].nmatches, setup_s=res.setup_s,
    iter_ms=1e3 * res.history[-1][0].iter_s, warm_setup_s=warm.setup_s,
    warm_iter_ms=1e3 * warm.history[-1][0].iter_s,
    loop_mode=loop_mode(mesh), setup_breakdown=res.setup_breakdown,
    warm_n_iterations=warm.n_iterations,
    warm_setup_breakdown=warm.setup_breakdown, eager=eager_record(
        f"rank {rank}", eager, res))), flush=True)
"""


def phase_mesh_ranks(ref, world=2, backend="gloo", device="cuda:0"):
    """Phase 15 (the defaults: two processes sharing ``cuda:0`` over
    gloo), or ``--cards N`` (N NCCL ranks, one card each): phase 9's
    configuration under ``mesh=`` in ``world`` processes; ``ref`` is the
    result the ranks' shifts are held to. Returns rank 0's launch counts
    and its record."""
    from subpixal_tpu_torch.testing import SpawnedRanks

    label = f"mesh path, {world} {backend} ranks"
    t0 = time.time()
    outs = SpawnedRanks(_MESH_RANK, world,
                        args=(backend, device)).wait(timeout=600)
    recs = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]
    print(f"{label}: {time.time() - t0:.2f} s wall for all {world} "
          "processes (start, import, two align calls and a plain one)")
    for r in recs:
        n = r["n_iterations"]
        print(f"{label}, rank {r['rank']} on {r['device']}: launches "
              f"{r['launches']}, measurement routes {r['routes']}, device "
              f"finder calls {r['finds']}, "
              f"{n} iterations, fit error {r['err_mpix']:.3f} mpix, sources "
              f"{r['nmatches']}; first call setup_s {r['setup_s']:.3f}, "
              f"{r['iter_ms']:.3f} ms per iteration, wall {r['wall']:.2f} "
              f"s; second call setup_s {r['warm_setup_s']:.3f}, "
              f"{r['warm_iter_ms']:.3f} ms per iteration")
        for key in ("setup_breakdown", "warm_setup_breakdown"):
            print(f"{label}, rank {r['rank']}, {key}: " + json.dumps(
                {k: round(v, 4) for k, v in r[key].items()}))
        check_loop_record(f"{label}, rank {r['rank']}", r)
        la = r["launches"]
        if (la["drizzle_deposit"] != 1 + n or la["blot_gather"] != n
                or la["measure_displacement"] != n or n != 4):
            raise AssertionError(f"{label}: rank {r['rank']} launched "
                                 f"{la} in {n} iterations")
        if r["finds"] != ["cuda"] * len(r["finds"]) or not r["finds"]:
            raise AssertionError(f"rank {r['rank']} ran the device finder "
                                 f"on {r['finds']}")
        if not r["err_mpix"] < 10.0:
            raise AssertionError(f"rank {r['rank']}: fit error "
                                 f"{r['err_mpix']} mpix")
        print(f"{label}, rank {r['rank']}: first-iteration shifts vs plain "
              f"versions: max |diff| {r['plain_diff']:.3e} px")
        if not r["plain_diff"] < 1e-3:
            raise AssertionError(f"{label}: rank {r['rank']}'s first "
                                 "iteration differs from the plain run by "
                                 f"{r['plain_diff']} px")
    check_ranks_loop(label, recs)
    if any(r["shifts"] != recs[0]["shifts"] for r in recs):
        raise AssertionError(f"{label}: the ranks returned different shifts")
    d = float(np.abs(np.asarray(recs[0]["shifts"])
                     - np.asarray(ref.shifts)).max())
    print(f"{label} vs the reference run: max |dshift| {d:.3e} px")
    if not d < 5e-4:
        raise AssertionError(f"{label} differ from the reference by {d} px")
    return recs[0]["launches"], recs[0]


#: the spatial mosaics' scenes (``bench.py``'s): exposures, frame shape,
#: stars, seed
SPATIAL_SCENES = {"1k": (8, (1024, 1024), 60, 11),     # bench.py:517-566
                  "4k": (4, (4096, 4096), 80, 23)}     # bench.py:569-609


def spatial_run(mesh, scene: str, iters: int) -> dict:
    """One rank of the spatial path: ``align_images`` through
    ``Drizzle(spatial_mesh=mesh)`` on ``scene`` with phase 9's
    configuration for ``iters`` iterations, with the launch counts set to
    0 just before and read just after, a spy on the band-local finder
    and on the shapes B1 is given; then a warm second call, and the first
    iteration through the kernels' plain versions on the card. Every rank
    of the mesh calls it. Returns a JSON-able record."""
    import torch

    from subpixal_tpu_torch import catalogs_spatial, kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.parallel import spatial as spatial_mod
    from subpixal_tpu_torch.resample import Drizzle
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    n_exp, shape, n_stars, seed = SPATIAL_SCENES[scene]
    exps, planted = simulate_stack(n_exp=n_exp, shape=shape,
                                   n_stars=n_stars, seed=seed)
    kw = dict(device="cuda", eps_shift=1e-7, max_iterations=iters,
              **NEW_PATH)
    finds, b1_shapes = [], []
    finder = catalogs_spatial.find_sources_spatial
    b1 = spatial_mod.drizzle_deposit_stack

    def finder_spy(mesh_, band, *a, **k):
        finds.append(band.device.type)
        return finder(mesh_, band, *a, **k)

    def b1_spy(data, *a, **k):
        b1_shapes.append(tuple(data.shape))
        return b1(data, *a, **k)

    def run(**over):
        return align_images(resample=Drizzle(exps, spatial_mesh=mesh),
                            **dict(kw, **over))

    routes = []
    cold_loop()
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    kernels.reset_launch_counts()
    t0 = time.time()
    with mock.patch.object(catalogs_spatial, "find_sources_spatial",
                           finder_spy), \
            mock.patch.object(spatial_mod, "drizzle_deposit_stack",
                              b1_spy), route_spy(routes):
        res = run()
    torch.cuda.synchronize(mesh.device)
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(mesh.device)
    warm = run()
    eager = None
    if loop_mode(mesh) == "nccl":  # the same call with capture turned off
        with eager_loop():
            eager = run()
    with _plain_versions():
        res_p = run(max_iterations=1)
    plain_diff = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
                     for a, b in zip(res.history[0], res_p.history[0]))
    return dict(
        loop_mode=loop_mode(mesh), warm_n_iterations=warm.n_iterations,
        eager=eager_record(repr(mesh), eager, res),
        sinc=spatial_sinc_check(mesh, shape), thin=spatial_thin_check(mesh),
        routes=sorted(set(routes)),
        device=str(mesh.device), mesh=repr(mesh), launches=launches,
        finds=finds, b1_shapes=b1_shapes, wall=wall, plain_diff=plain_diff,
        shifts=np.asarray(res.shifts).tolist(),
        n_iterations=res.n_iterations,
        err_mpix=1e3 * pairwise_shift_errors(res.shifts, planted),
        nmatches=res.history[0][0].nmatches, setup_s=res.setup_s,
        iter_ms=1e3 * res.history[-1][0].iter_s, warm_setup_s=warm.setup_s,
        warm_iter_ms=1e3 * warm.history[-1][0].iter_s,
        setup_breakdown=res.setup_breakdown,
        warm_setup_breakdown=warm.setup_breakdown, peak_bytes=peak)


def spatial_sinc_check(mesh, shape):
    """``sample_spatial(interp='sinc')`` at sinscl 0.5, 1.5 and 2 on this
    rank's band of a seeded plane of ``shape``, at 64 cutout grids of 32²
    spread over the plane (across the bands' boundaries and the edges),
    against the plain version on the whole plane on the card. Every rank
    of the mesh calls it. Returns, per scale, the relative error, whether
    validity is equal and the rank's B2 launches."""
    import torch

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.ops.interp import sample_image
    from subpixal_tpu_torch.parallel import sample_spatial, shard_rows

    H, W = shape
    rng = np.random.default_rng(29)
    gy, gx = np.mgrid[0:32, 0:32].astype(np.float64)
    cen = rng.uniform(-8, (W + 8, H + 8), (64, 2))
    q = [torch.tensor(g[None] + c[:, None, None], dtype=torch.float32,
                      device=mesh.device)
         for g, c in ((gx, cen[:, 0] + 0.37), (gy, cen[:, 1] + 0.61))]
    plane = torch.tensor(rng.uniform(0.0, 4.0, shape), dtype=torch.float32,
                         device=mesh.device)
    band = shard_rows(mesh, plane)
    out = {}
    for sinscl in (0.5, 1.5, 2.0):
        kernels.reset_launch_counts()
        v, ok = sample_spatial(mesh, band, *q, interp="sinc", sinscl=sinscl,
                               fill=-7.0, logical_rows=H)
        torch.cuda.synchronize(mesh.device)
        n = kernels.LAUNCHES["blot_gather"]
        pv, pok = sample_image(plane, *q, interp="sinc", sinscl=sinscl,
                               fill=-7.0)
        out[str(sinscl)] = dict(rel_err=_rel_err(v, pv)[0],
                                valid_equal=bool(torch.equal(ok, pok)),
                                valid=float(ok.float().mean()), launches=n)
    return out


def spatial_thin_check(mesh):
    """``sample_spatial`` on this rank's band of a seeded 8-row plane (4
    rows a band on two bands: thinner than poly5's 6-row footprint) at
    poly5, and at spline3 with ``spline_halo=2`` (below its 4-row
    footprint), under the default ``use_pallas``, against the plain
    ``sample_image`` on the whole plane on the card, at 24 cutout grids
    of 12² across the bands' boundaries and the edges. Such shapes take
    the bands' plain partials (no B2 launch); an explicit
    ``use_pallas=True`` refuses them. Every rank of the mesh calls it.
    Returns, per case, the relative error, whether validity is equal, the
    rank's B2 launches, the band rows and whether use_pallas=True
    raised."""
    import torch

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.ops.interp import sample_image
    from subpixal_tpu_torch.parallel import (band_rows, sample_spatial,
                                             shard_rows)

    H, W = 8, 96
    rng = np.random.default_rng(31)
    gy, gx = np.mgrid[0:12, 0:12].astype(np.float64)
    cen = np.stack([rng.uniform(-4, W - 8, 24), rng.uniform(-10, H, 24)], 1)
    q = [torch.tensor(g[None] + c[:, None, None], dtype=torch.float32,
                      device=mesh.device)
         for g, c in ((gx, cen[:, 0] + 0.37), (gy, cen[:, 1] + 0.61))]
    plane = torch.tensor(rng.uniform(0.0, 4.0, (H, W)), dtype=torch.float32,
                         device=mesh.device)
    band = shard_rows(mesh, plane)
    out = {}
    for interp, halo in (("poly5", 32), ("spline3", 2)):
        kernels.reset_launch_counts()
        v, ok = sample_spatial(mesh, band, *q, interp=interp, fill=-7.0,
                               logical_rows=H, spline_halo=halo)
        torch.cuda.synchronize(mesh.device)
        n = kernels.LAUNCHES["blot_gather"]
        pv, pok = sample_image(plane, *q, interp=interp, fill=-7.0)
        try:
            sample_spatial(mesh, band, *q, interp=interp, logical_rows=H,
                           spline_halo=halo, use_pallas=True)
            refused = False
        except ValueError:
            refused = True
        out[interp] = dict(rel_err=_rel_err(v, pv)[0],
                           valid_equal=bool(torch.equal(ok, pok)),
                           valid=float(ok.float().mean()), launches=n,
                           band_rows=band_rows(mesh, H), refused=refused)
    return out


def _check_thin(label, r):
    """``spatial_thin_check``'s record: validity equal to the whole
    plane's; poly5 within REL_TOL of it; B2 launched (and use_pallas=True
    accepted) only where the band holds poly5's footprint; spline3 at
    spline_halo 2 never launched and always refused under True."""
    print(f"{label}, {r['mesh']}: sample_spatial on an 8-row plane vs "
          f"plain on the whole plane: " + json.dumps(r["thin"]))
    for interp, c in r["thin"].items():
        fits = interp == "poly5" and c["band_rows"] >= 6
        if (not c["valid_equal"] or c["launches"] != int(fits)
                or c["refused"] == fits
                or (interp == "poly5" and c["rel_err"] > REL_TOL)):
            raise AssertionError(f"{label}: {r['mesh']}'s thin-band "
                                 f"sample_spatial {interp}: {c}")


def _check_spatial(label, recs, iters, ref=None, sparse=False):
    """Phase 16/17 checks on every rank's ``spatial_run`` record: B1 once
    at setup and once an iteration, B2 and B3 once an iteration, the
    band-local finder run on the card, fit error under 10 mpix, the first
    iteration within 1e-3 px of the plain versions, the ranks' shifts
    equal and (``ref``: phase 9's result) within 2e-3 px of the run
    without a spatial mesh; ``sparse``: the band-local sparse deposit
    engaged and B1 took its compacted blocks in the loop."""
    for r in recs:
        n, la = r["n_iterations"], r["launches"]
        print(f"{label}, {r['mesh']}: launches {la}, band-local finder "
              f"calls {r['finds']}, {n} iterations, fit error "
              f"{r['err_mpix']:.3f} mpix, sources {r['nmatches']}; first "
              f"call setup_s {r['setup_s']:.3f}, {r['iter_ms']:.3f} ms per "
              f"iteration, wall {r['wall']:.2f} s; second call setup_s "
              f"{r['warm_setup_s']:.3f}, {r['warm_iter_ms']:.3f} ms per "
              f"iteration; memory peak {r['peak_bytes'] / 2**20:.1f} MiB")
        for key in ("setup_breakdown", "warm_setup_breakdown"):
            print(f"{label}, {r['mesh']}, {key}: " + json.dumps(
                {k: round(v, 4) for k, v in r[key].items()}))
        print(f"{label}, {r['mesh']}: B1 inputs {r['b1_shapes'][:3]}; "
              f"measurement routes {r['routes']}; first-iteration shifts "
              f"vs plain versions: max |diff| {r['plain_diff']:.3e} px")
        print(f"{label}, {r['mesh']}: sample_spatial sinc vs plain on the "
              f"whole plane: " + json.dumps(r["sinc"]))
        if any(c["rel_err"] > REL_TOL or not c["valid_equal"]
               or c["launches"] != 1 for c in r["sinc"].values()):
            raise AssertionError(f"{label}: {r['mesh']}'s sample_spatial "
                                 f"sinc disagrees: {r['sinc']}")
        _check_thin(label, r)
        check_loop_record(f"{label}, {r['mesh']}", r)
        if (n != iters or la["drizzle_deposit"] != 1 + n
                or la["blot_gather"] != n or la["measure_displacement"] != n):
            raise AssertionError(f"{label}: {r['mesh']} launched {la} in "
                                 f"{n} iterations")
        if not r["finds"] or any(d != "cuda" for d in r["finds"]):
            raise AssertionError(f"{label}: the band-local finder ran on "
                                 f"{r['finds']}")
        if not r["err_mpix"] < 10.0:
            raise AssertionError(f"{label}: fit error {r['err_mpix']} mpix")
        if not r["plain_diff"] < 1e-3:
            raise AssertionError(f"{label}: {r['mesh']}'s first iteration "
                                 f"differs from the plain run by "
                                 f"{r['plain_diff']} px")
        if sparse and ("sparse_live_frac" not in r["setup_breakdown"]
                       or any(sh[-1] != 128 for sh in r["b1_shapes"][1:])):
            raise AssertionError(f"{label}: the band-local sparse deposit "
                                 f"did not engage: {r['setup_breakdown']}, "
                                 f"B1 on {r['b1_shapes']}")
    check_ranks_loop(label, recs)
    if any(r["shifts"] != recs[0]["shifts"] for r in recs):
        raise AssertionError(f"{label}: the ranks returned different shifts")
    if ref is not None:
        d = float(np.abs(np.asarray(recs[0]["shifts"])
                         - np.asarray(ref.shifts)).max())
        print(f"{label} vs phase 9 without a spatial mesh: max |dshift| "
              f"{d:.3e} px")
        if not d < 2e-3:
            raise AssertionError(f"{label} differs from phase 9 by {d} px")


def phase_spatial_one_rank(ref):
    """Phase 16, first part: ``bench.py``'s spatial scene (8 x 1024²,
    phase 9's configuration) through ``Drizzle(spatial_mesh=...)`` on a
    one-rank NCCL rows mesh. Returns the launch counts and the record."""
    import torch.distributed as dist

    from subpixal_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, axis_name="rows")
    if dist.get_backend(mesh.group()) != "nccl":
        raise AssertionError("make_mesh(1) on the card did not take NCCL")
    try:
        rec = spatial_run(mesh, "1k", 4)
    finally:
        dist.destroy_process_group()
    _check_spatial("spatial path, one NCCL band", [rec], 4, ref)
    return rec["launches"], rec


#: one rank of the spatial path: argv[4] the backend, argv[5] the rank's
#: device ('auto': cuda:LOCAL_RANK), argv[6] the scene, argv[7] the
#: iterations, argv[8] the mesh ('rows', or 'FxR' for make_mesh2d)
_SPATIAL_RANK = r"""
import json, sys

from subpixal_tpu_torch.parallel import (init_distributed, make_mesh,
                                         make_mesh2d)

rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
backend, device, scene, iters, shape = sys.argv[4:9]
init_distributed(addr, world, rank, backend=backend)
dev = None if device == "auto" else device
if shape == "rows":
    mesh = make_mesh(world, axis_name="rows", device=dev)
else:
    mesh = make_mesh2d(*map(int, shape.split("x")), device=dev)
from chip_smoke import spatial_run

rec = spatial_run(mesh, scene, int(iters))
print("RESULT " + json.dumps(dict(rec, rank=rank)), flush=True)
"""


def phase_spatial_ranks(label, world, backend="gloo", device="cuda:0",
                        scene="1k", iters=4, shape="rows", ref=None,
                        sparse=False):
    """Phases 16 (two gloo ranks sharing ``cuda:0``: two bands) and 17
    (the 4 × 4096² scene so), and ``--cards N``'s spatial runs (N NCCL
    bands, a card each; a (2, 2) mesh): ``spatial_run`` in ``world``
    processes, held by :func:`_check_spatial`. Returns rank 0's launch
    counts and record."""
    from subpixal_tpu_torch.testing import SpawnedRanks

    t0 = time.time()
    outs = SpawnedRanks(_SPATIAL_RANK, world, args=(
        backend, device, scene, iters, shape)).wait(timeout=900)
    recs = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("RESULT "))[7:]) for o in outs]
    print(f"{label}: {time.time() - t0:.2f} s wall for all {world} "
          "processes (start, import, two align calls and a plain one)")
    _check_spatial(label, recs, iters, ref, sparse)
    return recs[0]["launches"], recs[0]


def phase_catalog(dev):
    """The device finder on the main path's reference: the 8 x 1024²
    stack drizzled on the card, found on the card and on the CPU (rows,
    areas, bboxes and segmentation planes equal, positions within 1e-4
    px, fluxes within 1e-5 relative); warm ms of each beside the host
    finder's on the same image."""
    import torch

    from subpixal_tpu_torch.catalogs import find_sources
    from subpixal_tpu_torch.catalogs_device import find_sources_device
    from subpixal_tpu_torch.ops.drizzle import drizzle_combine
    from subpixal_tpu_torch.resample import Drizzle
    from subpixal_tpu_torch.testing import simulate_stack

    exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                             seed=11)
    drz = Drizzle(exps, device=dev)
    drz.execute()
    img = drizzle_combine(drz._sci_acc, drz._wht_acc, fill=drz.fillval)
    host = img.cpu()

    t0 = time.perf_counter()
    gc, gseg = find_sources_device(img)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    cc, cseg = find_sources_device(host)
    same = (len(gc) == len(cc) and all(
        np.array_equal(gc[k], cc[k])
        for k in ("id", "area", "xmin", "xmax", "ymin", "ymax")))
    dpos = max(float(np.abs(gc[k] - cc[k]).max()) for k in ("x", "y")) \
        if same and len(gc) else float("inf")
    dflux = float(np.abs(gc["flux"] / cc["flux"] - 1).max()) \
        if same and len(gc) else float("inf")
    seg_eq = bool(torch.equal(gseg.cpu(), cseg))
    print(f"catalog: device finder on {tuple(img.shape)}: {len(gc)} sources "
          f"on the card, {len(cc)} on the CPU; rows equal {same}, max "
          f"|dpos| {dpos:.2e} px, max flux rel {dflux:.2e}, segmentation "
          f"equal {seg_eq}")
    if not (same and dpos < 1e-4 and dflux < 1e-5 and seg_eq and len(gc)):
        raise AssertionError("the device finder on the card disagrees "
                             "with its CPU run")
    dev_ms = wall_ms(lambda: find_sources_device(img), 10)
    cpu_ms = wall_ms(lambda: find_sources_device(host), 3)
    arr = host.numpy()
    host_ms = wall_ms(lambda: find_sources(arr), 3)
    n_host = len(find_sources(arr)[0])
    print(f"catalog: device finder on the card {dev_ms:.3f} ms warm (first "
          f"call {cold_ms:.3f}), on the CPU {cpu_ms:.3f} ms; host finder "
          f"{host_ms:.3f} ms ({n_host} sources)")
    return dict(device_ms=dev_ms, first_ms=cold_ms, cpu_ms=cpu_ms,
                host_ms=host_ms, n=len(gc), n_host=n_host)


#: each setup program's bar between its replay and its eager run: B1's
#: atomics (deposit_stack) and index_add_'s (render_stack) sum in an order
#: that changes from run to run (REL_TOL); the programs that derive the
#: finder's threshold (cat_count, cat_find) take the finder's own bar on
#: the card (PERF.md §2), since the statistics' float32 prefix sums
#: (cumsum on the card) may round the threshold otherwise from run to
#: run; every other program must be exact
PROGRAM_TOL = {"deposit_stack": REL_TOL, "render_stack": REL_TOL,
               "cat_count": "finder", "cat_find": "finder"}


def finder_close(got, want) -> bool:
    """The finder's bar between two runs of a program on the card: counts,
    flags, areas, bboxes, peak pixels and rank planes equal; the kept
    sources' positions within 1e-4 px, their fluxes and peaks and the
    threshold within 1e-5 relative."""
    import torch

    for g, w in zip(_leaves(got), _leaves(want)):
        if g.dim() == 2 and g.shape[0] == 14 and g.is_floating_point():
            exact = [0, 1, 6, 7, 8, 9, 10, 11, 12, 13]  # the packed table
            kept = w[0] > 0
            if not (torch.equal(g[exact], w[exact]) and bool(
                    ((g[3:5] - w[3:5])[:, kept].abs() <= 1e-4).all()) and bool(
                    ((g[(2, 5),] - w[(2, 5),])[:, kept].abs()
                     <= 1e-5 * w[(2, 5),][:, kept].abs()).all())):
                return False
        elif g.is_floating_point() and g.dim() == 0:  # the threshold
            if not abs(float(g) - float(w)) <= 1e-5 * abs(float(w)):
                return False
        elif not torch.equal(g, w):
            return False
    return True

#: the setup programs this port runs through aot.get_executable
PROGRAMS = ("deposit_stack", "cutout_pixmaps_stack", "device_stage",
            "cat_count", "cat_count_thr", "cat_peaks", "cat_find",
            "cat_remap", "render_stack")


def cold_programs():
    """Empty the package's cache of captured setup programs (where it has
    one), so that the next call of each captures it anew."""
    try:
        from subpixal_tpu_torch import aot
    except ImportError:  # a checkout from before the programs
        return
    aot._MEM.clear()


def _leaves(tree):
    """The leaves of a program's argument or result tree (tuples, lists
    and dicts of tensors, generators and other values)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _fresh(tree):
    """``tree`` with each generator a new copy of its state."""
    import torch

    if isinstance(tree, (tuple, list)):
        return type(tree)(_fresh(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, torch.Generator):
        g = torch.Generator(device=tree.device)
        g.set_state(tree.get_state())
        return g
    return tree


def _program_sig(name, args, statics):
    """What tells two calls of a program apart: its name, statics and each
    argument's shape, dtype and device."""
    import torch

    return (name, repr(sorted(statics.items())), tuple(
        (tuple(a.shape), str(a.dtype), str(a.device))
        if isinstance(a, torch.Tensor) else type(a).__name__
        for a in _leaves(args)))


#: the package's modules that run setup programs through
#: aot.get_executable, under the name they import it as
PROGRAM_MODULES = ("align", "blot", "catalogs_device", "resample", "testing")


@contextmanager
def recorded_programs():
    """A block whose setup program calls are collected, hit or miss, as
    ``(name, fn, args, statics)`` (each generator argument a copy of its
    state at the call), by a spy on ``get_executable`` where each module
    of :data:`PROGRAM_MODULES` imports it."""
    import importlib

    from subpixal_tpu_torch import aot

    calls = []
    real = aot.get_executable

    def spy(name, fn, args, *, statics=None, key_extra=(), timings=None):
        calls.append((name, fn, _fresh(args), dict(statics or {})))
        return real(name, fn, args, statics=statics, key_extra=key_extra,
                    timings=timings)

    with ExitStack() as stack:
        for m in PROGRAM_MODULES:
            mod = importlib.import_module(f"subpixal_tpu_torch.{m}")
            stack.enter_context(mock.patch.object(mod, "get_executable", spy))
        yield calls


def kernels_ran(prof) -> dict:
    """The B1, B2 and B3 kernels a ``torch.profiler`` run saw the card
    run, by wrapper name."""
    return {k: sum(e.count for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and re.search(pat, e.key))
            for k, pat in KERNEL_NAMES.items()}


def host_syncs(fn, where=None):
    """The synchronising CUDA calls (host reads) ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode('warn')`` reports them; ``where``
    (a dict), when given, counts them by the Python line that made them."""
    import os
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in rec if "synchroniz" in str(w.message)]
    for w in syncs if where is not None else ():
        at = f"{os.path.basename(w.filename)}:{w.lineno}"
        where[at] = where.get(at, 0) + 1
    return len(syncs)


def phase_aot(dev):
    """The setup programs (``aot.get_executable``) at the main path's
    shapes: phase 9's scene rendered on the card (``render_stack``) and
    its setup (``align_images``, one iteration: the finder's programs
    warmed by ``warm_compile``, ``deposit_stack``, ``cat_count``,
    ``cat_peaks``, ``cat_remap``, ``cutout_pixmaps_stack``,
    ``device_stage``), and the device finder on its drizzled reference
    with 256 slots (``cat_find``) and at an explicit threshold
    (``cat_count_thr``), recorded with their inputs. For each program,
    from an empty cache: the first call runs it eagerly and captures it
    (CUDA graphs, a ``{name}.compile`` timing), and the launches it
    counts equal the kernels ``torch.profiler`` saw the card run; a
    second ``get_executable`` is a hit (the same executable); its replay
    equals the eager function (the finder's exactly, ``deposit_stack``
    and ``render_stack`` within REL_TOL), and the launches a replay adds
    equal the kernels its graphs hold (B1 once a ``deposit_stack``
    replay, nothing else). Prints each program's capture seconds, eager
    and replay ms, host syncs of an eager and of a replayed call, and the
    finder's host syncs a call with its programs and with them off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import aot, catalogs_device, kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.ops.drizzle import drizzle_combine
    from subpixal_tpu_torch.resample import Drizzle
    from subpixal_tpu_torch.testing import simulate_stack

    cold_programs()
    scene = dict(n_exp=8, shape=(1024, 1024), n_stars=60, seed=11)
    with recorded_programs() as calls:
        exps, _ = simulate_stack(device=dev, **scene)
        res = align_images(exposures=exps, device=dev, max_iterations=1,
                           eps_shift=1e-7, **NEW_PATH)
        drz = Drizzle(exps, device=dev)
        drz.execute()
        img = drizzle_combine(drz._sci_acc, drz._wht_acc, fill=drz.fillval)
        catalogs_device.find_sources_device(img, max_sources=256)
        catalogs_device.find_sources_device(img, threshold=0.05)
    print("aot: setup_breakdown of the recorded call " + json.dumps(
        {k: round(v, 4) for k, v in res.setup_breakdown.items()
         if k.endswith("compile")}))
    progs = {}
    for name, fn, args, statics in calls:  # the last call of each key
        progs[_program_sig(name, args, statics)] = (name, fn, args, statics)
    if {p[0] for p in progs.values()} != set(PROGRAMS):
        raise AssertionError(f"aot: the path ran {sorted(progs)}, expected "
                             f"{PROGRAMS}")
    out = {}
    for name, fn, args, statics in progs.values():
        cold_programs()
        t = {}
        exe = aot.get_executable(name, fn, _fresh(args), statics=statics,
                                 timings=t)
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            exe(*_fresh(args))
            torch.cuda.synchronize()
        first, ran = dict(kernels.LAUNCHES), kernels_ran(prof)
        capture_s = t.get(f"{name}.compile")
        t.clear()
        again = aot.get_executable(name, fn, _fresh(args), statics=statics,
                                   timings=t)
        steps = getattr(exe, "steps", None)
        if not steps or capture_s is None or again is not exe or t:
            raise AssertionError(f"aot {name}: not captured, then hit: "
                                 f"{type(exe).__name__}, {capture_s}, {t}")
        if first != ran:
            raise AssertionError(f"aot {name}: the capturing call counted "
                                 f"{first}, the card ran {ran}")
        kernels.reset_launch_counts()
        got = exe(*_fresh(args))
        launches = dict(kernels.LAUNCHES)
        want = fn(*_fresh(args), **statics)
        errs = [_rel_err(g, w)[0] if g.is_floating_point()
                else (0.0 if torch.equal(g, w) else float("inf"))
                for g, w in zip(_leaves(got), _leaves(want))]
        err = max(errs)
        tol = PROGRAM_TOL.get(name, 0.0)
        close = (finder_close(got, want) if tol == "finder"
                 else err <= tol)
        b1 = 1 if name == "deposit_stack" else 0
        if (not close or launches != exe.launches
                or launches["drizzle_deposit"] != b1
                or sum(launches.values()) != b1):
            raise AssertionError(f"aot {name}: replay vs eager {errs} "
                                 f"(bar {tol}), launches {launches}, "
                                 f"in its graphs {exe.launches}")
        eager_ms = wall_ms(lambda: fn(*_fresh(args), **statics), 5)
        replay_ms = wall_ms(lambda: exe(*_fresh(args)), 5)
        syncs = (host_syncs(lambda: fn(*_fresh(args), **statics)),
                 host_syncs(lambda: exe(*_fresh(args))))
        loops = sum(s.done is not None for s in steps)
        out[name] = dict(capture_s=capture_s, eager_ms=eager_ms,
                         replay_ms=replay_ms, syncs=syncs,
                         graphs=len(steps), loops=loops,
                         launches=exe.launches, max_rel_err=err,
                         held_mib=exe.nbytes / 2**20)
        print(f"aot {name}: first call (eager, then capture) "
              f"{capture_s:.4f} s ({len(steps)} graphs, {loops} of them "
              f"flood blocks; launches counted {json.dumps(first)} = the "
              f"profiler's), then a hit; replay vs eager max rel err "
              f"{err:.3e} (bar {tol}); launches a replay "
              f"{json.dumps(exe.launches)}; eager {eager_ms:.3f} ms, replay "
              f"{replay_ms:.3f} ms; host syncs eager {syncs[0]}, replay "
              f"{syncs[1]}; held {exe.nbytes / 2**20:.1f} MiB (static "
              f"inputs and graph pool)")
    # the finder's host reads a call: through its programs, and with the
    # programs off (the same functions eagerly)
    catalogs_device.find_sources_device(img)
    lines = {}
    on = host_syncs(lambda: catalogs_device.find_sources_device(img), lines)
    with mock.patch.object(aot, "aot_enabled", lambda: False):
        cold_programs()
        off = host_syncs(lambda: catalogs_device.find_sources_device(img))
        off_ms = wall_ms(lambda: catalogs_device.find_sources_device(img), 5)
    cold_programs()
    catalogs_device.find_sources_device(img)
    on_ms = wall_ms(lambda: catalogs_device.find_sources_device(img), 5)
    print(f"aot: device finder on the 1024² reference: {on} host syncs a "
          f"call through its programs ({on_ms:.3f} ms; by line "
          f"{json.dumps(lines)}), {off} with them off ({off_ms:.3f} ms)")
    return out


def wall_ms(fn, reps):
    """Median wall ms of ``fn()`` between two device synchronisations."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def _quiet_spots(img, n, rng, taken=()):
    """``n`` (y, x) pixels at least 50 px from the edges whose 9 x 9 box
    holds only background (no star), apart from ``taken``."""
    out = []
    while len(out) < n:
        y, x = (int(v) for v in rng.integers(50, img.shape[0] - 50, 2))
        if (np.abs(img[y - 4:y + 5, x - 4:x + 5]).max() < 0.1
                and all(abs(y - a) + abs(x - b) > 8 for a, b in
                        list(taken) + out)):
            out.append((y, x))
    return out


def _pipeline_files(root):
    """Phase 7's scene as FITS files: 4 gzip'd files of two SCI chips
    (exposures 2f, 2f + 1) with WHT extensions of ones. Each exposure gets
    a sky level of its own (positive, as real skies are: the output grid's
    uncovered border, filled with 0, must not stand above the matched
    sky), 6 dead pixels (-5, in every exposure) and 3 cosmic-ray hits of
    its own (+500); files 2 and 3 hold counts (BUNIT ELECTRONS),
    files 0 and 1 rates, all with EXPTIMEs of 300-580 s. Returns (paths,
    planted shifts, hits as (exposure, y, x), dead pixels)."""
    import os

    from subpixal_tpu_torch.fitswcs import wcs_to_header
    from subpixal_tpu_torch.io.fits import HDU, Header, write_fits
    from subpixal_tpu_torch.testing import simulate_stack

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11)
    rng = np.random.default_rng(12)
    dead = _quiet_spots(np.maximum.reduce([e.data for e in exps]), 6, rng)
    hits = [(e, y, x) for e, ex in enumerate(exps)
            for y, x in _quiet_spots(ex.data, 3, rng, dead)]
    paths = []
    for f in range(4):
        hdus = [HDU()]
        for c in range(2):
            e = 2 * f + c
            img = exps[e].data + np.float32(0.01 + 0.02 * e)  # sky
            for y, x in dead:
                img[y, x] = -5.0
            for k, y, x in hits:
                if k == e:
                    img[y, x] += 500.0
            t = 300.0 + 40.0 * e
            h = Header()
            for key, val in (("EXTNAME", "SCI"), ("EXTVER", c + 1),
                             ("EXPTIME", t),
                             ("BUNIT", "ELECTRONS" if f >= 2
                              else "ELECTRONS/S")):
                h[key] = val
            wcs_to_header(exps[e].wcs, h)
            hdus.append(HDU((img * np.float32(t) if f >= 2 else img)
                            .astype(np.float32), h))
            w = Header()
            w["EXTNAME"], w["EXTVER"] = "WHT", c + 1
            hdus.append(HDU(np.ones(img.shape, np.float32), w))
        paths.append(os.path.join(root, f"visit{f}_flt.fits.gz"))
        write_fits(paths[-1], hdus)
    return paths, planted, hits, dead


def phase_pipeline(dev):
    """``align_fits`` on 4 gzip'd 2-chip files with the three AstroDrizzle
    stages, phase 9's configuration, 4 iterations; then the stages'
    tensor branches on device-resident copies of the exposures against
    their host branches. Returns the launch counts and the result."""
    import os
    import shutil
    import tempfile

    import torch

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.fitswcs import wcs_from_hdul
    from subpixal_tpu_torch.io.fits import read_fits
    from subpixal_tpu_torch.pipeline import (AlignState, align_fits,
                                             load_exposures)
    from subpixal_tpu_torch.resample import Drizzle, Exposure
    from subpixal_tpu_torch.testing import pairwise_shift_errors

    kw = dict(wht_ext="WHT", device=dev, match_sky=True, static_mask=True,
              reject_cr=True, fitgeom="shift", usfac=8, fit_type="gaussian",
              max_iterations=4, eps_shift=1e-7)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        paths, planted, hits, dead = _pipeline_files(root)
        spare = os.path.join(root, "spare")
        os.mkdir(spare)
        for p in paths:  # unaligned copies for the warm and plain runs
            shutil.copy(p, spare)
        copies = [os.path.join(spare, os.path.basename(p)) for p in paths]
        print(f"pipeline: wrote {len(paths)} files "
              f"({sum(os.path.getsize(p) for p in paths) / 2 ** 20:.1f} "
              f"MiB gzip'd) in {time.time() - t0:.2f} s")
        state = os.path.join(root, "state.json")
        cold_loop()
        kernels.reset_launch_counts()
        t0 = time.time()
        res = align_fits(paths, state_file=state, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        per = 2 if "big_bucket_stage" in res.setup_breakdown else 1
        print(f"pipeline path: launches {launches}, wall {wall:.2f} s "
              "(load, align, header write-back)")
        if (launches["drizzle_deposit"] != 2 + res.n_iterations
                or launches["blot_gather"] != per * res.n_iterations
                or launches["measure_displacement"]
                != per * res.n_iterations):
            raise AssertionError(f"pipeline path: {launches} for "
                                 f"{res.n_iterations} iterations")
        err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
        print(f"pipeline path: setup_s {res.setup_s:.3f}, "
              f"{res.n_iterations} iterations at "
              f"{1e3 * res.history[-1][0].iter_s:.3f} ms each, fit error "
              f"{err_mpix:.3f} mpix, sources {res.history[0][0].nmatches}")
        print("pipeline path: setup_breakdown " + json.dumps(
            {k: round(v, 4) for k, v in res.setup_breakdown.items()}))
        if res.n_iterations != 4 or not err_mpix < 10.0:
            raise AssertionError(f"pipeline path: {res.n_iterations} "
                                 f"iterations, error {err_mpix} mpix")
        check_loop("pipeline path", res.setup_breakdown, res.n_iterations)
        missed = [(e, y, x) for e, y, x in hits
                  if res.exposures[e].weight[y, x] != 0]
        missed += [(e, y, x) for y, x in dead
                   for e in range(8) if res.exposures[e].weight[y, x] != 0]
        print(f"pipeline path: {len(hits)} planted hits and {len(dead)} "
              f"dead pixels, {len(missed)} left with weight")
        if missed:
            raise AssertionError(f"pipeline path: not masked: {missed}")
        # the rewritten headers reload to the returned WCSs, the state too
        for k, exp in enumerate(res.exposures):
            w = wcs_from_hdul(read_fits(paths[k // 2]),
                              ext=("SCI", k % 2 + 1), chip=k % 2 + 1)
            for f in ("crpix", "crval", "cd"):
                if not np.array_equal(getattr(w, f), getattr(exp.wcs, f)):
                    raise AssertionError(f"pipeline path: header of "
                                         f"{exp.name} reloads another {f}")
        st = AlignState.load(state)
        if st.n_iterations != res.n_iterations or not np.array_equal(
                st.shifts, np.asarray(res.shifts).tolist()):
            raise AssertionError("pipeline path: the state file differs")
        warm = align_fits(copies, update_headers=False, **kw)
        print(f"pipeline path, second call: setup_s {warm.setup_s:.3f}, "
              f"{1e3 * warm.history[-1][0].iter_s:.3f} ms per iteration")
        print("pipeline path, second call: setup_breakdown " + json.dumps(
            {k: round(v, 4) for k, v in warm.setup_breakdown.items()}))
        check_loop("pipeline path, second call", warm.setup_breakdown,
                   warm.n_iterations, cached=True)
        with _plain_versions():
            res_p = align_fits(copies, update_headers=False,
                               **dict(kw, max_iterations=1))
        d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
                for a, b in zip(res.history[0], res_p.history[0]))
        print(f"pipeline path: first-iteration shifts vs plain versions: "
              f"max |diff| {d:.3e} px")
        if not d < 1e-3:
            raise AssertionError(f"pipeline path: first iteration differs "
                                 f"from the plain run by {d} px")
        host = load_exposures(copies, wht_ext="WHT")
    # the stages' tensor branches on device-resident exposures vs the host
    # branches, both drizzling on the card
    gpu = [Exposure(torch.tensor(e.data, device=dev), e.wcs,
                    weight=torch.tensor(e.weight, device=dev),
                    exptime=e.exptime, name=e.name, data_units=e.data_units)
           for e in host]
    hd, gd = Drizzle(host, device=dev), Drizzle(gpu, device=dev)
    t0 = time.time()
    sky_h = hd.match_sky()
    mask_h = hd.apply_static_mask()
    cr_h = hd.reject_cr()
    host_s = time.time() - t0
    t0 = time.time()
    sky_g = gd.match_sky()
    mask_g = gd.apply_static_mask()
    cr_g = gd.reject_cr()
    torch.cuda.synchronize()
    dev_s = time.time() - t0
    dsky = float(np.abs(sky_g - sky_h).max())
    n_h = sum(int(m.sum()) for m in cr_h)
    n_g = sum(int(m.sum()) for m in cr_g)
    flagged = all(m[e][y, x] for m in (cr_h, cr_g) for e, y, x in hits)
    print(f"pipeline stages, tensor vs host branches: skies max |d| "
          f"{dsky:.2e}, static masks equal {np.array_equal(mask_g, mask_h)} "
          f"({int(mask_h.sum())} px), CR flags {n_g} vs {n_h}, planted hits "
          f"flagged by both {flagged}; {dev_s:.3f} s vs {host_s:.3f} s")
    if not (dsky < 1e-4 and np.array_equal(mask_g, mask_h) and flagged
            and abs(n_g - n_h) <= 2
            and gd.exposures[0].weight.device.type == "cuda"):
        raise AssertionError("the stages' tensor branches disagree with "
                             "their host branches on the card")
    return launches, res


def profile_redrizzle(dev) -> None:
    """``--profile``: device time of one iteration's re-drizzle as the
    imported package's align step runs it (the 8 x 1024² stack, square,
    pixfrac 1: pixmap affine, deposit, combine), and of B1, B2 and B3 per
    launch at the align paths' shapes (32², 48²) and the bucket's 256²
    (B3 also at 64² and 128², and its mixed-radix kernel asked for at 32²
    and 64²)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch.kernels import drizzle as kdriz
    from subpixal_tpu_torch.kernels.blot import sample_cutouts
    from subpixal_tpu_torch.kernels.measure import measure_window
    from subpixal_tpu_torch.ops.drizzle import drizzle_combine
    from subpixal_tpu_torch.ops.peaks import normalize_search_box

    E, oshape, ratios = 8, (1032, 1032), (1.0,) * 8
    t = _deposit_planes(dev, E, 1024, 1024, 0.0, ratios, 6)
    rng = np.random.default_rng(7)
    Ms = torch.tensor(np.eye(2)[None] + rng.normal(0, 1e-4, (E, 2, 2)),
                      dtype=torch.float32, device=dev)
    ts = torch.tensor(rng.normal(0, 0.3, (E, 2)), dtype=torch.float32,
                      device=dev)
    if hasattr(kdriz, "drizzle_deposit_stack"):
        form = "one stacked deposit"

        def step():
            px, py = align_mod._affine_apply_grid(Ms, ts, t["x"], t["y"])
            sci, wht, esc = kdriz.drizzle_deposit_stack(
                t["d"], t["w"], px, py, oshape, pixfrac=1.0,
                pscale_ratio=ratios, kernel="square")
            return drizzle_combine(sci, wht), esc
    else:
        form = "a deposit per exposure"

        def step():  # the align step's re-drizzle before the stacked one
            sci = wht = None
            esc = []
            for e in range(E):
                px, py = align_mod._affine_apply_grid(Ms[e], ts[e], t["x"][e],
                                                      t["y"][e])
                s, w, es = kdriz.drizzle_deposit(
                    t["d"][e], t["w"][e], px, py, oshape, pixfrac=1.0,
                    pscale_ratio=ratios[e], kernel="square")
                sci = s if sci is None else sci + s
                wht = w if wht is None else wht + w
                esc.append(es)
            return drizzle_combine(sci, wht), torch.stack(esc)

    reps = 10
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in ev) / reps
    n = sum(e.count for e in ev) / reps
    b1 = sum(e.self_device_time_total for e in ev if "deposit" in e.key)
    print(f"re-drizzle per iteration ({form}), 8 x 1024², square, "
          f"pixfrac 1: {total:.3f} us of device time in {n:.0f} device "
          f"operations, of which B1 {b1 / reps:.3f} us")
    one = {k: v[0] for k, v in t.items()}
    print("B1 1024², square, pixfrac 1: %.3f us per launch" % device_us(
        rotating(lambda *a: kdriz.drizzle_deposit(*a, oshape), one["d"],
                 one["w"], one["x"], one["y"]), "deposit"))
    for B, n, seed in ((512, 32, 2), (512, 48, 4), (16, 256, 6)):
        img_t, x_t, y_t = _b2_inputs(dev, B, n, seed)
        print("B2 %d x %d², poly5: %.3f us per launch" % (B, n, device_us(
            rotating(sample_cutouts, img_t, x_t, y_t), "gather_kernel")))
    # the mixed-radix kernel asked for where the FFT kernel takes the
    # shape, when the imported package can be asked
    asks = [None] + (["mixed_radix"] if "kernel" in inspect.signature(
        measure_window).parameters else [])
    for B, n, sigma, seed in ((512, 32, 1.6, 3), (500, 64, 2.0, 0),
                              (512, 48, 3.0, 5), (512, 128, 3.0, 9),
                              (16, 256, 1.6, 7)):
        ref, img, m = _b3_inputs(dev, B, n, 0.45, sigma, True, seed)
        kw = dict(cc_type="NCC", usfac=8, nwin=16,
                  bounds=normalize_search_box("fitbox", n, n, 5))
        for ask in asks if n in (32, 64) else [None]:
            extra = {} if ask is None else {"kernel": ask}

            def call(r, i, mk):
                return measure_window(r, i, mk, mk, **kw, **extra)

            print("B3 %d x %d², masked NCC, usfac 8%s: %.3f us per launch"
                  % (B, n, f", {ask} asked for" if ask else "",
                     device_us(rotating(call, ref, img, m), "measure")))


def loop_marked():
    """A context under which each call of the align loop
    (``align._fixed_point``) is a ``torch.profiler`` range named
    ``align_loop``, so a trace splits setup from the loop."""
    import functools

    from torch.profiler import record_function

    from subpixal_tpu_torch import align as align_mod

    real = align_mod._fixed_point

    @functools.wraps(real)
    def marked(*a, **k):
        with record_function("align_loop"):
            return real(*a, **k)

    return mock.patch.object(align_mod, "_fixed_point", marked)


def profile_finder(dev) -> None:
    """``--profile``: the device finder on the main path's reference (the
    8 x 1024² stack drizzled on the card), warm: its host syncs a call
    and its wall ms."""
    from subpixal_tpu_torch.catalogs_device import find_sources_device
    from subpixal_tpu_torch.ops.drizzle import drizzle_combine
    from subpixal_tpu_torch.resample import Drizzle
    from subpixal_tpu_torch.testing import simulate_stack

    exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                             seed=11)
    drz = Drizzle(exps, device=dev)
    drz.execute()
    img = drizzle_combine(drz._sci_acc, drz._wht_acc, fill=drz.fillval)
    find_sources_device(img)
    syncs = host_syncs(lambda: find_sources_device(img))
    print(f"device finder, 1024² reference, warm: {syncs} host syncs a "
          f"call, {wall_ms(lambda: find_sources_device(img), 10):.3f} ms")


def profile_memory_4k(dev) -> None:
    """``--profile``: the memory of a one-card align of ``bench.py``'s
    4 x 4096² seed-23 scene (the new path, 2 iterations): a warm call
    with the setup programs off (run eagerly), then with them on, its
    capturing call and a warm call; each call's peak allocated and
    reserved MiB and what the cached programs hold."""
    import importlib.util

    import torch

    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import simulate_stack

    n, shape, stars, seed = SPATIAL_SCENES["4k"]
    exps, _ = simulate_stack(n_exp=n, shape=shape, n_stars=stars, seed=seed)
    kw = dict(exposures=exps, device=dev, max_iterations=2, eps_shift=1e-7,
              **NEW_PATH)

    def measured(label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = align_images(**kw)
        torch.cuda.synchronize()
        held = sum(getattr(e, "nbytes", 0) for e in (
            aot._MEM.values() if aot is not None else ()))
        print(f"4 x 4096² one card, {label}: wall {time.time() - t0:.3f} s, "
              f"setup_s {res.setup_s:.4f}, memory peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"allocated, {torch.cuda.max_memory_reserved() / 2**20:.1f} "
              f"MiB reserved; the cached programs hold "
              f"{held / 2**20:.1f} MiB")

    if importlib.util.find_spec("subpixal_tpu_torch.aot") is None:
        aot = None  # a checkout from before the programs
        align_images(**kw)
        measured("no programs, warm call")
        return
    from subpixal_tpu_torch import aot

    with mock.patch.object(aot, "aot_enabled", lambda: False):
        cold_programs()
        torch.cuda.empty_cache()
        align_images(**kw)
        measured("programs off, warm call")
    cold_programs()
    torch.cuda.empty_cache()
    measured("programs on, capturing call")
    measured("programs on, warm call")


def profile_paths(dev) -> None:
    """``--profile``: torch.profiler over one warm align call of each path
    (after a warm-up call, and a call that captures the loop's graph
    anew): device time by kernel, device busy time per iteration,
    launches, the host ops that take the most host time, and the
    collectives (the mesh path, one NCCL rank, where the imported package
    has ``parallel``). Prints the loop's time a call (iterations plus
    ``loop_compile``) of the capturing and the profiled call, and holds
    the B1, B2 and B3 kernels the profiler saw to the launch counts. The
    defaults' path runs a second time at the defaults' ``eps_shift`` and
    ``max_iterations``, where the loop converges."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import simulate_stack

    new = dict(fitgeom="shift", usfac=8, fit_type="gaussian")
    cells = [("defaults' path", 1.8, {}),
             ("defaults' path, converging", 1.8,
              dict(eps_shift=0.004, max_iterations=10)),
             ("defaults' path, host finder", 1.8,
              dict(device_catalog="host")),
             ("new path", 1.8, new), ("48² path", 3.0, new),
             ("otf path", 1.8, dict(new, wcsupdate="otf"))]
    mesh = None
    if importlib.util.find_spec("subpixal_tpu_torch.parallel") is not None:
        from subpixal_tpu_torch.parallel import make_mesh

        mesh = make_mesh(1)
        cells.append(("mesh path, one NCCL rank", 1.8, dict(new, mesh=mesh)))
        if importlib.util.find_spec("subpixal_tpu_torch.parallel.spatial"):
            cells.append(("spatial path, one NCCL band", 1.8,
                          dict(new, spatial_mesh=mesh)))
    wrong = []
    for label, sigma, config in cells:
        exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                 seed=11, sigma=sigma)
        config = dict(config)
        smesh = config.pop("spatial_mesh", None)
        kw = dict(exposures=exps, device=dev, eps_shift=1e-7,
                  max_iterations=4)
        kw.update(config)

        def call():
            if smesh is None:
                return align_images(**kw)
            from subpixal_tpu_torch.resample import Drizzle

            return align_images(
                resample=Drizzle(exps, spatial_mesh=smesh),
                **{k: v for k, v in kw.items() if k != "exposures"})

        call()
        # a call that captures its loop in a warm process, then (profiled)
        # one served by the cached graph; a package without the cache
        # runs both alike
        cold_loop()
        torch.cuda.synchronize()
        t0 = time.time()
        cold = call()
        torch.cuda.synchronize()
        cold_wall = time.time() - t0
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                loop_marked():
            res = call()
            torch.cuda.synchronize()
        wall = time.time() - t0
        # the host's launch API calls outside the fixed-point loop: setup's
        loops = [e.time_range for e in prof.events()
                 if e.name == "align_loop"]
        setup_api = sum(
            1 for e in prof.events()
            if e.device_type.name == "CPU" and "Launch" in e.name
            and not any(r.start <= e.time_range.start <= r.end
                        for r in loops))
        launches = dict(kernels.LAUNCHES)
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in events)
        n_launch = sum(e.count for e in events)
        # the host's launch API calls (kernels, and whole graphs); the
        # kernels the card ran beyond the host's kernel launches ran
        # inside the replayed graphs
        api = {e.key: e.count for e in prof.key_averages()
               if e.device_type.name == "CPU" and "Launch" in e.key}
        n_graph = sum(c for k, c in api.items() if "Graph" in k)
        n_kern = sum(e.count for e in events
                     if "Memcpy" not in e.key and "Memset" not in e.key)
        # the kernels the card ran against the wrappers' launch counts
        ran = {k: sum(e.count for e in events if re.search(pat, e.key))
               for k, pat in KERNEL_NAMES.items()}

        def loop_ms(r):  # the loop's time in a call: iterations + capture
            return 1e3 * (r.n_iterations * r.history[-1][0].iter_s
                          + r.setup_breakdown.get("loop_compile", 0.0))

        cbd = cold.setup_breakdown
        print(f"{label}: loop ms a call (iterations + loop_compile): "
              f"capturing call {loop_ms(cold):.3f} ({cold.n_iterations} x "
              f"{1e3 * cold.history[-1][0].iter_s:.3f} + "
              f"{1e3 * cbd.get('loop_compile', 0.0):.3f}; wall "
              f"{cold_wall:.3f} s, setup_s {cold.setup_s:.3f}), cached "
              f"call {loop_ms(res):.3f} ({res.n_iterations} iterations, "
              f"{res.setup_breakdown.get('loop_steps')} steps; wall "
              f"{wall:.3f} s, profiled); kernels the profiler saw "
              f"{json.dumps(ran)}, launch counts {json.dumps(launches)}")
        if ran != launches:
            wrong.append(f"{label}: the profiler saw {ran} kernel "
                         f"launches, the counts say {launches}")
        iter_ms = 1e3 * res.history[-1][0].iter_s
        print(f"{label} (profiled call): setup's host launch API calls "
              f"{setup_api} (outside the loop), memory peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"allocated, {torch.cuda.memory_reserved() / 2**20:.1f} MiB "
              f"reserved, setup_s {res.setup_s:.4f}, "
              "setup_breakdown " + json.dumps(
                  {k: round(v, 4) for k, v in res.setup_breakdown.items()
                   if not k.startswith("loop_")}))
        print(f"{label} (profiled call): wall {wall:.3f} s, setup_s "
              f"{res.setup_s:.3f}, {iter_ms:.3f} ms per iteration; device "
              f"kernels {dev_us / 1e3:.3f} ms in all over {n_launch} "
              f"launches; host launch API calls {sum(api.values())} "
              f"({n_graph} of them graph launches) {json.dumps(api)}; "
              f"kernels in graphs "
              f"{n_kern - (sum(api.values()) - n_graph)}; "
              "setup_breakdown " + json.dumps(
                  {k: round(v, 4) for k, v in res.setup_breakdown.items()
                   if k.startswith("loop_")}))
        ranked = sorted(events, key=lambda e: -e.self_device_time_total)
        # the 12 longest entries, then the three kernels and the copies
        # wherever they rank
        own = ("deposit", "gather_kernel", "measure", "Memcpy")
        for i, e in enumerate(ranked):
            if i < 12 or any(k in e.key for k in own):
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.count:6d}x  {e.key[:90]}")
        host = sorted((e for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)
        coll = [e for e in host if "all_reduce" in e.key
                or "allreduce" in e.key]
        print(f"  host: {sum(e.self_cpu_time_total for e in host) / 1e3:.3f}"
              f" ms of self CPU time in all; collectives "
              f"{sum(e.self_cpu_time_total for e in coll) / 1e3:.3f} ms "
              f"over {sum(e.count for e in coll)} calls; the 6 longest:")
        for e in host[:6]:
            print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]} (host)")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if wrong:
        raise AssertionError("; ".join(wrong))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if "--root" in args:  # the package of another checkout
        sys.path.insert(0, args[args.index("--root") + 1])
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.kernels import _build

    print(f"package: {kernels.__file__}")
    print(_run([_build._nvcc(), "--version"]))
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)

    t0 = time.time()
    times = kernels.build()
    print(f"build: {time.time() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in times.items())})")
    for k in _build.SOURCES:
        _build.load(k)
    if "--profile" in args:
        profile_redrizzle(dev)
        profile_finder(dev)
        profile_paths(dev)
        profile_memory_4k(dev)
        return 0
    if "--cards" in args:  # the mesh path over N NCCL ranks, a card each
        cards = int(args[args.index("--cards") + 1])
        if torch.cuda.device_count() < cards:
            raise AssertionError(f"--cards {cards}: "
                                 f"{torch.cuda.device_count()} cards")
        _, ref = phase_align(dev, "new path", tuple(kernels.LAUNCHES),
                             **NEW_PATH)
        phase_mesh_ranks(ref, cards, "nccl", "auto")
        phase_spatial_ranks(f"spatial path, {cards} NCCL bands", cards,
                            "nccl", "auto", ref=ref)
        if cards == 4:
            phase_spatial_ranks("spatial path, (2, 2) NCCL mesh", 4, "nccl",
                                "auto", shape="2x2", ref=ref)
        return 0

    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    phase_blot_sinc(dev)
    b3 = phase_b3(dev)
    phase_b3_routes(dev)
    phase_catalog(dev)
    phase_aot(dev)
    new = NEW_PATH
    runs = {
        "defaults": phase_align(dev, "defaults' path",
                                ("drizzle_deposit", "blot_gather")),
        "defaults_host_finder": phase_align(
            dev, "defaults' path, host finder",
            ("drizzle_deposit", "blot_gather"), finder="host",
            device_catalog="host"),
        "align_usfac8": phase_align(dev, "new path", tuple(kernels.LAUNCHES),
                                    **new),
        "align_usfac8_48": phase_align(
            dev, "48² path", tuple(kernels.LAUNCHES), sigma=3.0,
            measured=((512, 48, 48), "mixed_radix"), **new),
        # otf converges geometrically where batch corrects every exposure
        # to the mean in one step (the JAX package's otf does the same):
        # 2 iterations leave ~24 mpix on this scene, 4 well under 10
        "otf": phase_align(dev, "otf path", tuple(kernels.LAUNCHES),
                           iters=4, wcsupdate="otf", **new),
        "host_loop": phase_align(dev, "host-loop path",
                                 tuple(kernels.LAUNCHES), iters=2,
                                 device_loop=False, **new),
        "pipeline": phase_pipeline(dev),
    }
    runs["mesh_1rank"] = phase_mesh_one_rank(dev, runs["align_usfac8"][1])
    runs["mesh_2ranks"] = phase_mesh_ranks(runs["mesh_1rank"][1])
    runs["spatial_1band"] = phase_spatial_one_rank(runs["align_usfac8"][1])
    runs["spatial_2bands"] = phase_spatial_ranks(
        "spatial path, two gloo bands on one card", 2,
        ref=runs["align_usfac8"][1])
    runs["spatial_4k_2bands"] = phase_spatial_ranks(
        "spatial 4k path, two gloo bands on one card", 2, scene="4k",
        iters=2, sparse=True)
    runs["use_pallas_false"] = phase_use_pallas_false(dev)
    runs["device_scene"] = phase_device_scene(dev, runs["align_usfac8"][1])
    # the reference's own bar between the finders (tests/test_align.py)
    d_fin = float(np.abs(runs["defaults"][1].shifts
                         - runs["defaults_host_finder"][1].shifts).max())
    print(f"defaults' path, device vs host finder: max |dshift| "
          f"{1e3 * d_fin:.3f} mpix")
    if not d_fin < 3e-3:
        raise AssertionError(f"the finders' shifts differ by {d_fin} px")
    # the host loop follows the device loop
    d_loop = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
                 for ra, rb in zip(runs["host_loop"][1].history,
                                   runs["align_usfac8"][1].history)
                 for a, b in zip(ra, rb))
    print(f"host loop vs device loop, 2 iterations: max |dshift| "
          f"{d_loop:.3e} px")
    if not d_loop < 1e-4:
        raise AssertionError(f"the host loop differs by {d_loop} px")
    by_path = {p: r[0] for p, r in runs.items()}

    def entries(name, source, replaces, shapes):
        return [{"name": name, "route": "cuda",
                 "source": f"subpixal_tpu_torch/csrc/{source}",
                 "replaces": replaces,
                 "launches": by_path["align_usfac8"][name],
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "device_us": k["device_us"], "plain_ms": k["plain_ms"],
                 "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                 "library_ms": k.get("library_ms"), "at": k["shape"],
                 "launches_by_path": {p: c[name]
                                      for p, c in by_path.items()}}
                for k in shapes]

    record = {"kernels": (
        entries("drizzle_deposit", "drizzle_deposit.cu",
                "subpixal_tpu/kernels/drizzle.py:444", b1)
        + entries("blot_gather", "blot_gather.cu",
                  "subpixal_tpu/kernels/blot.py:283", b2)
        + entries("measure_displacement", "measure_displacement.cu",
                  "subpixal_tpu/kernels/measure.py:427", b3))}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
