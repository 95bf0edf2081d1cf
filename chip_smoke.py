#!/usr/bin/env python3
"""Check that the PyTorch/CUDA port runs on one NVIDIA GPU, and time it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches another's
failure):

1. toolchain: torch/CUDA versions, the card, ``nvcc --version``;
2. build both kernels from ``subpixal_tpu_torch/csrc`` with nvcc
   (``sm_90a``), one nvcc per source, started together;
3. B1: the drizzle deposit kernel against its plain PyTorch version on
   the card, on a 1024² frame with a small rotation and fractional
   offsets, for all seven drizzle kernels at pixfrac 1.0 and 0.8;
4. B2: the blot gather kernel against its plain version on 512 cutouts
   of 32², the shape the main path picks for its scene, for all six
   interpolants;
5. the main path: ``align_images`` on an 8 x 1024², 60-star simulated
   stack for 4 iterations, with the kernels' launch counts set to 0
   just before and read just after; the fit error against the planted
   shifts must be under 10 mpix, and the first iteration's shifts must
   agree within 1e-3 px with the same run forced through the plain
   versions on the card. A second call of the same run gives the
   steady-state time per iteration.

The line before the last is the card's name and power limit as
``nvidia-smi`` reports them; the one before it is a JSON record of every
kernel (launches in the main path, error against the plain version, and
median times of kernel and plain version from CUDA events). The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

#: both kernels are compared with their plain versions to this bound on
#: max |kernel - plain| / max(1, max |plain|): the kernels evaluate the
#: same f32 formulas, but atomics (B1) and fused multiply-adds (B1, B2)
#: change the order and rounding of the float sums
REL_TOL = 1e-5


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


def _rel_err(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale, float(
        (got - want).abs().max())


def phase_b1(dev):
    """Deposit kernel vs plain version on a rotated, offset 1024² frame."""
    import torch

    from subpixal_tpu_torch.kernels.drizzle import drizzle_deposit
    from subpixal_tpu_torch.ops.drizzle import DRIZZLE_KERNELS
    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit as plain

    rng = np.random.default_rng(1)
    H = W = 1024
    th = np.deg2rad(0.3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xo = np.cos(th) * xx - np.sin(th) * yy + 3.37
    yo = np.sin(th) * xx + np.cos(th) * yy - 2.61
    data = rng.normal(1.0, 0.5, (H, W))
    wht = rng.uniform(0.5, 1.5, (H, W)) * (rng.random((H, W)) > 0.05)
    t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in dict(d=data, w=wht, x=xo, y=yo).items()}
    oshape = (H + 8, W + 8)
    worst_abs = 0.0
    for kernel in DRIZZLE_KERNELS:
        for pixfrac in (1.0, 0.8):
            s, w, esc = drizzle_deposit(t["d"], t["w"], t["x"], t["y"],
                                        oshape, pixfrac=pixfrac,
                                        kernel=kernel)
            ps, pw = plain(t["d"], t["w"], t["x"], t["y"], oshape,
                           pixfrac=pixfrac, kernel=kernel)
            torch.cuda.synchronize()
            rs, as_ = _rel_err(s, ps)
            rw, aw = _rel_err(w, pw)
            print(f"B1 {kernel:9s} pixfrac={pixfrac}: rel err sci {rs:.2e} "
                  f"wht {rw:.2e}, escaped {int(esc)}")
            if not (rs <= REL_TOL and rw <= REL_TOL) or int(esc) != 0:
                raise AssertionError(f"B1 {kernel} pixfrac={pixfrac} "
                                     f"disagrees with the plain version")
            worst_abs = max(worst_abs, as_, aw)
    # times at the main path's configuration (square kernel, pixfrac 1)
    ms = cuda_ms(lambda: drizzle_deposit(t["d"], t["w"], t["x"], t["y"],
                                         oshape))
    plain_ms = cuda_ms(lambda: plain(t["d"], t["w"], t["x"], t["y"],
                                     oshape))
    print(f"B1 square pixfrac=1 on 1024²: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 30, CUDA events)")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)


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
    plain_ms = cuda_ms(lambda: sample_image(img_t, x_t, y_t))
    print(f"B2 poly5 on 512 x 32²: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 30, CUDA events)")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)


def _plain_deposit(*args, **kw):
    import torch

    from subpixal_tpu_torch.ops.drizzle import drizzle_deposit

    s, w = drizzle_deposit(*args, **kw)
    return s, w, torch.zeros((), dtype=torch.int32, device=s.device)


def _plain_gather(image, x, y, interp="poly5", fill=0.0, prefiltered=False):
    import torch

    from subpixal_tpu_torch.ops.interp import sample_image

    v, ok = sample_image(image, x, y, interp=interp, fill=fill,
                         prefiltered=prefiltered)
    return v, ok, torch.zeros(x.shape[0], dtype=torch.int32,
                              device=x.device)


def phase_main_path(dev):
    """align_images on 8 x 1024², 60 stars, 4 iterations, on the card."""
    import torch

    from subpixal_tpu_torch import align as align_mod
    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch import resample as resample_mod
    from subpixal_tpu_torch.align import align_images
    from subpixal_tpu_torch.testing import (pairwise_shift_errors,
                                            simulate_stack)

    exps, planted = simulate_stack(n_exp=8, shape=(1024, 1024), n_stars=60,
                                   seed=11)
    kw = dict(exposures=exps, device=dev, eps_shift=1e-7)
    kernels.reset_launch_counts()
    t0 = time.time()
    res = align_images(max_iterations=4, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"main path: launches {launches}, wall {wall:.2f} s")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    shifts = np.asarray(res.shifts)
    if shifts.shape != (8, 2) or not np.isfinite(shifts).all():
        raise AssertionError(f"bad shifts {shifts}")
    err_mpix = 1e3 * pairwise_shift_errors(res.shifts, planted)
    iter_ms = 1e3 * res.history[-1][0].iter_s
    print(f"main path: setup_s {res.setup_s:.3f}, {res.n_iterations} "
          f"iterations at {iter_ms:.3f} ms each, fit error "
          f"{err_mpix:.3f} mpix, sources {res.history[0][0].nmatches}")
    if res.n_iterations != 4 or not err_mpix < 10.0:
        raise AssertionError(f"main path: {res.n_iterations} iterations, "
                             f"error {err_mpix} mpix")
    # the first call in a process pays cuFFT plans and lazy kernel loads;
    # a second call shows the steady state
    warm = align_images(max_iterations=4, **kw)
    warm_ms = 1e3 * warm.history[-1][0].iter_s
    print(f"main path, second call: setup_s {warm.setup_s:.3f}, "
          f"{warm_ms:.3f} ms per iteration")
    # the same run forced through the plain versions on the card
    with mock.patch.object(align_mod, "drizzle_deposit", _plain_deposit), \
            mock.patch.object(align_mod, "sample_cutouts", _plain_gather), \
            mock.patch.object(resample_mod, "drizzle_deposit",
                              _plain_deposit):
        res_p = align_images(max_iterations=1, **kw)
    d = max(float(np.hypot(*np.subtract(a.shift, b.shift)))
            for a, b in zip(res.history[0], res_p.history[0]))
    print(f"main path: first-iteration shifts vs plain versions: "
          f"max |diff| {d:.3e} px")
    if not d < 1e-3:
        raise AssertionError(f"first iteration differs from the plain "
                             f"run by {d} px")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    from subpixal_tpu_torch import kernels
    from subpixal_tpu_torch.kernels import _build

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

    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    launches = phase_main_path(dev)

    record = {"kernels": [
        {"name": "drizzle_deposit", "route": "cuda",
         "source": "subpixal_tpu_torch/csrc/drizzle_deposit.cu",
         "replaces": "subpixal_tpu/kernels/drizzle.py:444",
         "launches": launches["drizzle_deposit"],
         "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
         "plain_ms": b1["plain_ms"]},
        {"name": "blot_gather", "route": "cuda",
         "source": "subpixal_tpu_torch/csrc/blot_gather.cu",
         "replaces": "subpixal_tpu/kernels/blot.py:283",
         "launches": launches["blot_gather"],
         "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"]},
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
