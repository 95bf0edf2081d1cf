#!/usr/bin/env python3
"""Check that the PyTorch/CUDA port runs on one NVIDIA GPU, and time it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

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
   and 2.0 for all seven kernels; the main path's stack of 8 × 1024² in
   one launch; and that stack compacted to (8, L·16, 128) block columns,
   as the sparse deposit stages it;
4. B2: the blot gather kernel against its plain version on 512 cutouts
   of 32², the shape the main path picks for its scene, for all six
   interpolants;
5. B3: the measurement kernels against their plain version (the
   ``torch.fft`` chain): the FFT kernel on 512 masked NCC
   pairs of 32² at ``usfac`` 8 (the shape the new path picks) and on
   ``bench.py``'s 500 unmasked NCC pairs of 64² at ``usfac`` 10; the
   one-block-per-pair kernel on 16 masked pairs of 256² (the oversized
   bucket's cap);
6. the defaults' path: ``align_images`` on an 8 x 1024², 60-star
   simulated stack for 4 iterations, with the kernels' launch counts set
   to 0 just before and read just after (B1 and B2 must have run, B1
   once per exposure at setup and once per iteration); the fit error
   against the planted shifts must be under 10 mpix, and the first
   iteration's shifts must agree within 1e-3 px with the same run forced
   through the plain versions on the card. A second call of the same run
   gives the steady-state time per iteration;
7. the new path: the same scene with the JAX package's own align
   configuration (``bench.py``'s align smoke: shift fit, ``usfac`` 8,
   Gaussian peak), whose 'auto' settings on the card take device
   pixmaps and the sparse deposit; B1, B2 and B3 must all have run, with
   the same checks and a second, warm call.

Each kernel is timed three ways at each shape: ``ms``, the median of 30
CUDA-event timings of one wrapper call (host launch overhead and the
wrapper's allocations included); ``device_us``, the kernel's own device
time per launch from ``torch.profiler`` over 20 back-to-back calls; and
``plain_ms`` for the plain version. Each bound is the larger of the bytes
the function must move (each input read once, each output written once)
over 3.35 TB/s and the f32 operations it does on these inputs over 67
TFLOP/s (the H100 SXM's published rates). The line before the last is
the card's name and power limit as ``nvidia-smi`` reports them; the one
before it is a JSON record of every kernel and shape. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

#: B3's window is compared relative to its largest value: the kernels sum
#: their own FFTs or direct DFTs where the plain version runs torch.fft
#: (the JAX package holds its own fused kernel to its XLA path with the
#: same bar)
C2_TOL = 5e-4

#: published H100 SXM rates: device-memory bytes/s, f32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


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


def device_us(fn, key, reps=20):
    """Device microseconds per launch of the kernels whose name holds
    ``key``, from ``torch.profiler`` over ``reps`` back-to-back calls of
    ``fn`` (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    n = sum(e.count for e in ev)
    if n == 0:
        raise AssertionError(f"the profiler saw no launch of {key!r}")
    return sum(e.self_device_time_total for e in ev) / n


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


def _b1_check(t, oshape, ratios, kernel, pixfrac, label, direct=None):
    """Kernel vs plain stack; ``direct`` (None: any) is whether strips
    must take the direct-atomics path. Returns the max abs error."""
    import torch

    from subpixal_tpu_torch.kernels.drizzle import _deposit_stack
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack

    n_direct = torch.zeros(1, dtype=torch.int32, device=t["d"].device)
    s, w, esc = _deposit_stack(t["d"], t["w"], t["x"], t["y"], oshape,
                               pixfrac, ratios, kernel, n_direct)
    ps, pw = drizzle_deposit_stack(t["d"], t["w"], t["x"], t["y"], oshape,
                                   pixfrac=pixfrac, pscale_ratio=ratios,
                                   kernel=kernel)
    torch.cuda.synchronize()
    rs, as_ = _rel_err(s, ps)
    rw, aw = _rel_err(w, pw)
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


def _b1_time(t, oshape, ratios, label):
    """Wrapper, device and plain times and the bound, square/pixfrac 1."""
    from subpixal_tpu_torch.kernels.drizzle import drizzle_deposit_stack
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit_stack as plain

    args = (t["d"], t["w"], t["x"], t["y"], oshape)
    ms = cuda_ms(lambda: drizzle_deposit_stack(*args, pscale_ratio=ratios))
    dev_us = device_us(lambda: drizzle_deposit_stack(
        *args, pscale_ratio=ratios), "deposit_tiles")
    plain_ms = cuda_ms(lambda: plain(*args, pscale_ratio=ratios), reps=5,
                       warmup=1)
    # data, weight, x, y read; sci, wht written; ~20 flops for each of
    # the K x K = 4 cells a pixel meets at square/pixfrac 1
    npix = t["d"].numel()
    bound_ms, by = bound(4 * (4 * npix + 2 * oshape[0] * oshape[1]),
                         20 * 4 * npix)
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
    # the main path's stack: 8 exposures of 1024², ratio 1, one launch
    ones = (1.0,) * 8
    t8 = _deposit_planes(dev, 8, 1024, 1024, 0.3, ones, 4)
    worst = max(worst, _b1_check(t8, oshape, ones, "square", 1.0,
                                 "8 x 1024² stack", direct=False))
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
             _b1_time(tc, oshape, ones,
                      "8 x (256·16, 128) compacted, square, pixfrac 1")]
    for r in times:
        r["max_abs_err"] = worst
    return times


def phase_b2(dev):
    """Gather kernel vs plain version on 512 cutouts of 32²."""
    import torch

    from subpixal_tpu_torch.kernels.blot import sample_cutouts
    from subpixal_tpu_torch.ops.interp import INTERP_TAPS, sample_image

    rng = np.random.default_rng(2)
    H = W = 1024
    B, h, w = 512, 32, 32
    image = rng.normal(0.0, 0.01, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for cx, cy in rng.uniform(0, W, (200, 2)):
        image += 25.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.48)
    # cutout grids: centers over the whole frame (edge cutouts go partly
    # invalid), a small rotation and a fractional offset per cutout
    th = np.deg2rad(0.2)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    cen = rng.uniform(-8, W + 8, (B, 2))
    off = rng.uniform(-0.5, 0.5, (B, 2))
    x = (np.cos(th) * gx - np.sin(th) * gy)[None] + (cen[:, 0] + off[:, 0]
                                                      - w / 2)[:, None, None]
    y = (np.sin(th) * gx + np.cos(th) * gy)[None] + (cen[:, 1] + off[:, 1]
                                                      - h / 2)[:, None, None]
    img_t = torch.tensor(image, dtype=torch.float32, device=dev)
    x_t = torch.tensor(x, dtype=torch.float32, device=dev)
    y_t = torch.tensor(y, dtype=torch.float32, device=dev)
    worst_abs = 0.0
    for interp in INTERP_TAPS:
        v, ok, esc = sample_cutouts(img_t, x_t, y_t, interp=interp)
        pv, pok = sample_image(img_t, x_t, y_t, interp=interp)
        torch.cuda.synchronize()
        r, a = _rel_err(v, pv)
        same_valid = bool(torch.equal(ok, pok))
        print(f"B2 {interp:8s}: rel err {r:.2e}, validity equal "
              f"{same_valid} ({float(ok.float().mean()):.3f} valid), "
              f"escaped {int(esc.sum())}")
        if not (r <= REL_TOL and same_valid) or int(esc.sum()) != 0:
            raise AssertionError(f"B2 {interp} disagrees with the plain "
                                 "version")
        worst_abs = max(worst_abs, a)
    ms = cuda_ms(lambda: sample_cutouts(img_t, x_t, y_t))
    dev_us = device_us(lambda: sample_cutouts(img_t, x_t, y_t),
                       "gather_kernel")
    plain_ms = cuda_ms(lambda: sample_image(img_t, x_t, y_t))
    # image, x, y read; values (f32) and validity (bytes) written; per
    # output 6x6 multiply-adds and 2 x 6 Lagrange weights of 15 flops
    n = B * h * w
    bound_ms, by = bound(4 * H * W + 8 * n + 5 * n, n * (2 * 36 + 180))
    print(f"B2 poly5 on 512 x 32²: wrapper {ms:.4f} ms, device "
          f"{dev_us:.3f} us per launch, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by})")
    return [dict(shape="512 x 32², poly5", max_abs_err=worst_abs, ms=ms,
                 device_us=dev_us, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=by)]


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

    from subpixal_tpu_torch.kernels.measure import (measure_window,
                                                    uses_fft_kernel)
    from subpixal_tpu_torch.ops.correlate import measure_window as plain
    from subpixal_tpu_torch.ops.peaks import normalize_search_box

    out = []
    for label, B, n, usfac, masked, sigma, seed in (
            ("512 x 32², masked NCC, usfac 8", 512, 32, 8, True, 1.6, 3),
            ("500 x 64², unmasked NCC, usfac 10", 500, 64, 10, False, 2.0,
             0),
            ("16 x 256², masked NCC, usfac 8", 16, 256, 8, True, 1.6, 7)):
        ref, img, m = _b3_inputs(dev, B, n, 0.45, sigma, masked, seed)
        bounds = normalize_search_box("fitbox", n, n, 5)
        nwin = -(-(usfac + 5 + 1) // 8) * 8
        ny, nx = bounds[1] - bounds[0], bounds[3] - bounds[2]
        which = ("FFT" if uses_fft_kernel(n, n, nwin, ny)
                 else "one-block-per-pair")
        kw = dict(cc_type="NCC", usfac=usfac, nwin=nwin, bounds=bounds)
        c2, sy, sx = measure_window(ref, img, m, m, **kw)
        pc2, psy, psx = plain(ref, img, m, m, **kw)
        torch.cuda.synchronize()
        err = float((c2 - pc2).abs().max())
        scale = float(pc2.abs().max())
        same_s0 = bool(torch.equal(sy, psy) and torch.equal(sx, psx))
        print(f"B3 {label} ({which} kernel): max |C2 - plain| {err:.3e} "
              f"({err / scale:.2e} of max |C2|), s0 equal {same_s0}")
        if not (err <= C2_TOL * scale and same_s0):
            raise AssertionError(f"B3 {label} disagrees with the plain "
                                 "version")
        ms = cuda_ms(lambda: measure_window(ref, img, m, m, **kw))
        dev_us = device_us(lambda: measure_window(ref, img, m, m, **kw),
                           "measure")
        plain_ms = cuda_ms(lambda: plain(ref, img, m, m, **kw))
        # ref, img (f32) and the shared bool mask read; C2, s0 written
        nbytes = B * (n * n * (8 + masked) + 4 * nwin * nwin + 8)
        bound_ms, by = bound(nbytes, _b3_flops(B, n, n, nwin, ny, nx))
        print(f"B3 {label}: wrapper {ms:.4f} ms, device {dev_us:.3f} us per "
              f"launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}, {bound_ms * 1e3 / dev_us:.1%} of it reached)")
        out.append(dict(shape=f"{label} ({which})", max_abs_err=err, ms=ms,
                        device_us=dev_us, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by))
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


def phase_align(dev, label, expect, **config):
    """align_images on 8 x 1024², 60 stars, 4 iterations, on the card.

    ``expect`` names the kernels this path must launch. Returns the
    launch counts of the first call."""
    import torch

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch import resample as resample_mod
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.ops.correlate import measure_window
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11)
    kw = dict(exposures=exps, device=dev, eps_shift=1e-7, **config)
    kernels.reset_launch_counts()
    t0 = time.time()
    res = align_images(max_iterations=4, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"{label}: launches {launches}, wall {wall:.2f} s")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{label} never launched {name}")
    # B1: one launch per exposure for the initial drizzle, then the whole
    # stack in one launch per iteration
    if launches["drizzle_deposit"] != len(exps) + res.n_iterations:
        raise AssertionError(f"{label}: {launches['drizzle_deposit']} B1 "
                             f"launches for {len(exps)} exposures and "
                             f"{res.n_iterations} iterations")
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
    if res.n_iterations != 4 or not err_mpix < 10.0:
        raise AssertionError(f"{label}: {res.n_iterations} iterations, "
                             f"error {err_mpix} mpix")
    # the first call in a process pays cuFFT plans and lazy kernel loads;
    # a second call shows the steady state
    warm = align_images(max_iterations=4, **kw)
    warm_ms = 1e3 * warm.history[-1][0].iter_s
    print(f"{label}, second call: setup_s {warm.setup_s:.3f}, "
          f"{warm_ms:.3f} ms per iteration")
    # the same run forced through the plain versions on the card
    with mock.patch.object(align_mod, "drizzle_deposit_stack",
                           _plain_deposit_stack), \
            mock.patch.object(align_mod, "sample_cutouts", _plain_gather), \
            mock.patch.object(resample_mod, "drizzle_deposit",
                              _plain_deposit), \
            mock.patch.object(align_mod, "measure_window", measure_window):
        res_p = align_images(max_iterations=1, **kw)
    d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
            for a, b in zip(res.history[0], res_p.history[0]))
    print(f"{label}: first-iteration shifts vs plain versions: "
          f"max |diff| {d:.3e} px")
    if not d < 1e-3:
        raise AssertionError(f"{label}: first iteration differs from the "
                             f"plain run by {d} px")
    return launches


def profile_redrizzle(dev) -> None:
    """``--profile``: device time of one iteration's re-drizzle as the
    imported package's align step runs it (the 8 x 1024² stack, square,
    pixfrac 1: pixmap affine, deposit, combine), and of B1 and B3 per
    launch at the main path's shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch.kernels import drizzle as kdriz
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
        lambda: kdriz.drizzle_deposit(one["d"], one["w"], one["x"],
                                      one["y"], oshape), "deposit"))
    ref, img, m = _b3_inputs(dev, 512, 32, 0.45, 1.6, True, 3)
    kw = dict(cc_type="NCC", usfac=8, nwin=16,
              bounds=normalize_search_box("fitbox", 32, 32, 5))
    print("B3 512 x 32², masked NCC, usfac 8: %.3f us per launch" % device_us(
        lambda: measure_window(ref, img, m, m, **kw), "measure"))


def profile_paths(dev) -> None:
    """``--profile``: torch.profiler over one warm align call of each path
    (after a warm-up call): device time by kernel, device busy time per
    iteration, and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import simulate_stack

    exps, _ = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                             seed=11)
    for label, config in (("defaults' path", {}),
                          ("new path", dict(fitgeom="shift", usfac=8,
                                            fit_type="gaussian"))):
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

    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    b3 = phase_b3(dev)
    by_path = {
        "defaults": phase_align(dev, "defaults' path",
                                ("drizzle_deposit", "blot_gather")),
        "align_usfac8": phase_align(
            dev, "new path", tuple(kernels.LAUNCHES), fitgeom="shift",
            usfac=8, fit_type="gaussian"),
    }

    def entries(name, source, replaces, shapes):
        return [{"name": name, "route": "cuda",
                 "source": f"subpixal_tpu_torch/csrc/{source}",
                 "replaces": replaces,
                 "launches": by_path["align_usfac8"][name],
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "device_us": k["device_us"], "plain_ms": k["plain_ms"],
                 "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                 "library_ms": None, "at": k["shape"],
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
