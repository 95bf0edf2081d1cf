#!/usr/bin/env python3
"""Check that the PyTorch/CUDA port runs on one NVIDIA GPU, and time it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --cards N`` (a machine with N cards) builds the
kernels, runs phase 9 on one card and then phase 15's checks on phase
9's configuration over N NCCL ranks, one card each.

``python3 chip_smoke.py --profile [--root DIR]`` builds the kernels and
instead measures device time with ``torch.profiler``: one iteration's
re-drizzle as the package's align step runs it, the kernels per launch,
and one warm align call of each path. ``--root DIR`` imports the package
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
   interpolants on 512 cutouts of 32² (the shape the main path picks for
   its scene), 512 of 48² (the 48² path's) and 16 of 256² (the oversized
   bucket's cap); the linear interpolant at 32² also beside
   ``grid_sample``, the one PyTorch call that computes it at interior
   points;
5. B3: the measurement kernels against their plain version (the
   ``torch.fft`` chain), each route asserted: the FFT kernel on 512
   masked NCC pairs of 32² at ``usfac`` 8 (the new path's shape) and on
   ``bench.py``'s 500 unmasked NCC pairs of 64² at ``usfac`` 10, and the
   mixed-radix kernel asked for on the same pairs; the mixed-radix kernel
   on 512 masked pairs of 48² (the 48² path's), of 128²
   (``max_cut_size``) and on 16 of 256² (the oversized bucket's cap);
6. the catalog phase: the device source finder on the main path's
   reference (the 8 x 1024², 60-star stack drizzled on the card), held
   to its own run on the CPU (rows, areas, bboxes and segmentation planes
   equal, positions within 1e-4 px, fluxes within 1e-5 relative); warm
   ms on the card beside the CPU run and the host finder;
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
    the same run through the plain versions, a warm second call; and its
    shifts within 5e-4 px of phase 9's run without a mesh;
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
    phase.

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
import statistics
import subprocess
import sys
import time
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


def _b2_bound(img, x, y, interp):
    """Bound of one gather: the image pixels the footprints need (the
    union of each cutout's footprint bounding box, clipped to the image),
    x and y read, values (f32) and validity (bytes) written; per output
    taps² multiply-adds and two axes of Lagrange weights in product form
    (~5 operations a tap). Returns (ms, by, image pixels counted)."""
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
                   n * (2 * taps * taps + 2 * 5 * taps))
    return ms, by, npix


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


def phase_b2(dev):
    """Gather kernel vs plain version: all six interpolants on 512
    cutouts of 32² and of 48² and on the 16 x 256² bucket; times at poly5
    (and linear at 32², beside grid_sample)."""
    import torch

    from subpixal_tpu_torch.kernels.blot import sample_cutouts
    from subpixal_tpu_torch.ops.interp import INTERP_TAPS, sample_image

    out = []
    for B, n, seed in ((512, 32, 2), (512, 48, 4), (16, 256, 6)):
        img_t, x_t, y_t = _b2_inputs(dev, B, n, seed)
        H, W = img_t.shape
        worst_abs = 0.0
        for interp in INTERP_TAPS:
            v, ok, esc = sample_cutouts(img_t, x_t, y_t, interp=interp)
            pv, pok = sample_image(img_t, x_t, y_t, interp=interp)
            torch.cuda.synchronize()
            r, a = _rel_err(v, pv)
            same_valid = bool(torch.equal(ok, pok))
            print(f"B2 {B} x {n}² {interp:8s}: rel err {r:.2e}, validity "
                  f"equal {same_valid} ({float(ok.float().mean()):.3f} "
                  f"valid), escaped {int(esc.sum())}")
            if not (r <= REL_TOL and same_valid) or int(esc.sum()) != 0:
                raise AssertionError(f"B2 {B} x {n}² {interp} disagrees "
                                     "with the plain version")
            worst_abs = max(worst_abs, a)
        timed = ["poly5"] + (["linear"] if n == 32 else [])
        for interp in timed:
            def call():
                return sample_cutouts(img_t, x_t, y_t, interp=interp)

            ms = cuda_ms(call)
            dev_us = device_us(rotating(
                lambda *a: sample_cutouts(*a, interp=interp), img_t, x_t,
                y_t), "gather_kernel")
            plain_ms = cuda_ms(lambda: sample_image(img_t, x_t, y_t,
                                                    interp=interp))
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
            print(f"B2 {B} x {n}², {interp}: wrapper {ms:.4f} ms, device "
                  f"{dev_us:.3f} us per launch, plain {plain_ms:.4f} ms, "
                  f"library {library_ms}, bound {bound_ms:.4f} ms ({by}; "
                  f"{npix} of {H * W} image pixels needed; "
                  f"{bound_ms * 1e3 / dev_us:.1%} of it reached)")
            out.append(dict(shape=f"{B} x {n}², {interp}",
                            max_abs_err=worst_abs, ms=ms, device_us=dev_us,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=by, library_ms=library_ms))
    return out


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
    """Star cutout pairs (img shifted by up to ``shift`` px) with masks."""
    import torch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    dx = rng.uniform(-shift, shift, B)[:, None, None]
    dy = rng.uniform(-shift, shift, B)[:, None, None]

    def star(ox, oy):
        return np.exp(-((xx - n / 2 - ox) ** 2 + (yy - n / 2 - oy) ** 2)
                      / (2 * sigma ** 2))

    refs = star(0.0, 0.0)[None] + rng.normal(0, 1e-3, (B, n, n))
    imgs = star(dx, dy) + rng.normal(0, 1e-3, (B, n, n))
    t = [torch.tensor(a, dtype=torch.float32, device=dev)
         for a in (refs, imgs)]
    mask = None
    if masked:  # the align loop's masks: bool, shared by both sides
        mask = torch.tensor(rng.random((B, n, n)) > 0.05, device=dev)
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


def _plain_deposit(*args, **kw):
    import torch

    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit

    s, w = drizzle_deposit(*args, **kw)
    return s, w, torch.zeros((), dtype=torch.int32, device=s.device)


def _plain_deposit_stack(*args, **kw):
    import torch

    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack

    s, w = drizzle_deposit_stack(*args, **kw)
    return s, w, torch.zeros(args[0].shape[0], dtype=torch.int32,
                             device=s.device)


def _plain_gather(image, x, y, interp="poly5", fill=0.0, prefiltered=False):
    import torch

    from subpixal_tpu_torch.ops.interp import sample_image

    v, ok = sample_image(image, x, y, interp=interp, fill=fill,
                         prefiltered=prefiltered)
    return v, ok, torch.zeros(x.shape[0], dtype=torch.int32,
                              device=x.device)


def _plain_versions():
    """Patches under which the align path (setup drizzle, loop) runs the
    kernels' plain versions on the card."""
    from contextlib import ExitStack

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch import blot as blot_mod
    from subpixal_tpu_torch import resample as resample_mod
    from subpixal_tpu_torch.ops.correlate import measure_window

    stack = ExitStack()
    for mod, name, fn in (
            (align_mod, "drizzle_deposit_stack", _plain_deposit_stack),
            (blot_mod, "sample_cutouts", _plain_gather),
            (blot_mod, "measure_window", measure_window),
            (resample_mod, "drizzle_deposit", _plain_deposit),
            (resample_mod, "drizzle_deposit_stack", _plain_deposit_stack)):
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


def phase_align(dev, label, expect, sigma=1.8, measured=None, iters=4,
                finder="device", **config):
    """align_images on 8 x 1024², 60 stars of width ``sigma``, ``iters``
    iterations, on the card.

    ``expect`` names the kernels this path must launch; ``measured`` is
    None or ((B, H, W), route): the batch B3 must measure each iteration
    and the route it must take; ``finder`` the source finder setup must
    run ('device': the device finder, counted by a spy; 'host': never the
    device finder). Returns the launch counts of the first call and its
    result."""
    import torch

    from subpixal_tpu_torch import blot as blot_mod
    from subpixal_tpu_torch import catalogs_device, kernels
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11, sigma=sigma)
    kw = dict(exposures=exps, device=dev, eps_shift=1e-7, **config)
    seen = []
    finds = []
    kernel_measure = blot_mod.measure_window
    device_finder = catalogs_device.find_sources_device

    def spy(ref, *a, **k):  # the batches the loop hands to B3
        seen.append((tuple(ref.shape), k["nwin"], tuple(k["bounds"])))
        return kernel_measure(ref, *a, **k)

    def finder_spy(image, *a, **k):  # the device finder's calls
        finds.append(image.device.type)
        return device_finder(image, *a, **k)

    kernels.reset_launch_counts()
    t0 = time.time()
    with mock.patch.object(blot_mod, "measure_window", spy), \
            mock.patch.object(catalogs_device, "find_sources_device",
                              finder_spy):
        res = align_images(max_iterations=iters, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"{label}: launches {launches}, wall {wall:.2f} s, device "
          f"finder calls {finds}")
    if (finder == "device") != bool(finds) or \
            any(d != "cuda" for d in finds):
        raise AssertionError(f"{label}: setup ran the device finder on "
                             f"{finds}, expected the {finder} finder")
    if measured is not None:
        from subpixal_tpu_torch.kernels.measure import kernel_route

        shape, route = measured
        routes = {kernel_route(*sh, nwin, bo) for sh, nwin, bo in seen}
        print(f"{label}: B3 batches {sorted(set(seen))}, routes {routes}")
        if {sh for sh, _, _ in seen} != {shape} or \
                {r.kernel for r in routes} != {route}:
            raise AssertionError(f"{label}: B3 measured {seen[:2]} by "
                                 f"{routes}, expected {shape} by {route}")
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
    # the first call in a process pays cuFFT plans and lazy kernel loads;
    # a second call shows the steady state
    warm = align_images(max_iterations=iters, **kw)
    warm_ms = 1e3 * warm.history[-1][0].iter_s
    print(f"{label}, second call: setup_s {warm.setup_s:.3f}, "
          f"{warm_ms:.3f} ms per iteration")
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


def phase_mesh_one_rank(dev, ref):
    """Phase 14: phase 9's configuration (``ref``: its result) under
    ``mesh=make_mesh(1)``, one NCCL rank. Returns the launch counts and
    the result."""
    import torch.distributed as dist

    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1)
    backend = dist.get_backend(mesh.group)
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


kernels.reset_launch_counts()
t0 = time.time()
with mock.patch.object(catalogs_device, "find_sources_device", spy):
    res = align_images(**kw)
torch.cuda.synchronize()
wall = time.time() - t0
launches = dict(kernels.LAUNCHES)
warm = align_images(**kw)
# the first iteration forced through the kernels' plain versions on the
# card: B1 on this rank's frames, B2 and B3 on its block of the cutout rows
from chip_smoke import _plain_versions

with _plain_versions():
    res_p = align_images(**dict(kw, max_iterations=1))
plain_diff = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
                 for a, b in zip(res.history[0], res_p.history[0]))
print("RESULT " + json.dumps(dict(
    rank=rank, device=str(mesh.device), launches=launches, finds=finds,
    wall=wall, plain_diff=plain_diff,
    shifts=np.asarray(res.shifts).tolist(), n_iterations=res.n_iterations,
    err_mpix=1e3 * pairwise_shift_errors(res.shifts, planted),
    nmatches=res.history[0][0].nmatches, setup_s=res.setup_s,
    iter_ms=1e3 * res.history[-1][0].iter_s, warm_setup_s=warm.setup_s,
    warm_iter_ms=1e3 * warm.history[-1][0].iter_s,
    setup_breakdown=warm.setup_breakdown)), flush=True)
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
              f"{r['launches']}, device finder calls {r['finds']}, "
              f"{n} iterations, fit error {r['err_mpix']:.3f} mpix, sources "
              f"{r['nmatches']}; first call setup_s {r['setup_s']:.3f}, "
              f"{r['iter_ms']:.3f} ms per iteration, wall {r['wall']:.2f} "
              f"s; second call setup_s {r['warm_setup_s']:.3f}, "
              f"{r['warm_iter_ms']:.3f} ms per iteration")
        print(f"{label}, rank {r['rank']}, second call: "
              "setup_breakdown " + json.dumps(
                  {k: round(v, 4) for k, v in r["setup_breakdown"].items()}))
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
    if any(r["shifts"] != recs[0]["shifts"] for r in recs):
        raise AssertionError(f"{label}: the ranks returned different shifts")
    d = float(np.abs(np.asarray(recs[0]["shifts"])
                     - np.asarray(ref.shifts)).max())
    print(f"{label} vs the reference run: max |dshift| {d:.3e} px")
    if not d < 5e-4:
        raise AssertionError(f"{label} differ from the reference by {d} px")
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

    def wall_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

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


def profile_paths(dev) -> None:
    """``--profile``: torch.profiler over one warm align call of each path
    (after a warm-up call): device time by kernel, device busy time per
    iteration, launches, the host ops that take the most host time, and
    the collectives (the mesh path, one NCCL rank, where the imported
    package has ``parallel``)."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import simulate_stack

    new = dict(fitgeom="shift", usfac=8, fit_type="gaussian")
    cells = [("defaults' path", 1.8, {}),
             ("defaults' path, host finder", 1.8,
              dict(device_catalog="host")),
             ("new path", 1.8, new), ("48² path", 3.0, new),
             ("otf path", 1.8, dict(new, wcsupdate="otf"))]
    mesh = None
    if importlib.util.find_spec("subpixal_tpu_torch.parallel") is not None:
        from subpixal_tpu_torch.parallel import make_mesh

        mesh = make_mesh(1)
        cells.append(("mesh path, one NCCL rank", 1.8, dict(new, mesh=mesh)))
    for label, sigma, config in cells:
        exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                 seed=11, sigma=sigma)
        kw = dict(exposures=exps, device=dev, eps_shift=1e-7,
                  max_iterations=4, **config)
        align_images(**kw)
        torch.cuda.synchronize()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = align_images(**kw)
            torch.cuda.synchronize()
        wall = time.time() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in events)
        n_launch = sum(e.count for e in events)
        iter_ms = 1e3 * res.history[-1][0].iter_s
        print(f"{label} (profiled call): wall {wall:.3f} s, setup_s "
              f"{res.setup_s:.3f}, {iter_ms:.3f} ms per iteration; device "
              f"kernels {dev_us / 1e3:.3f} ms in all over {n_launch} "
              "launches")
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
        profile_paths(dev)
        return 0
    if "--cards" in args:  # the mesh path over N NCCL ranks, a card each
        cards = int(args[args.index("--cards") + 1])
        if torch.cuda.device_count() < cards:
            raise AssertionError(f"--cards {cards}: "
                                 f"{torch.cuda.device_count()} cards")
        _, ref = phase_align(dev, "new path", tuple(kernels.LAUNCHES),
                             **NEW_PATH)
        phase_mesh_ranks(ref, cards, "nccl", "auto")
        return 0

    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    b3 = phase_b3(dev)
    phase_catalog(dev)
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
