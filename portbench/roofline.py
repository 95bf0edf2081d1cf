"""Frozen copy of chip_smoke.py's bound arithmetic (HBM_BPS, F32_FLOPS,
L2_BYTES, bound, _b2_bound's byte count, B2_WEIGHT_OPS, _b3_flops), and a
kernel's share of its roofline over a traced window. Each roofline
metric's reader (``metrics/<kernel>_roofline.py``) carries its kernel's
name pattern and counts its work from the shapes each call took.

A kernel's least time is the larger of its bytes over the card's memory
bandwidth and its float32 operations over the card's non-tensor float32
rate. Each input byte counts once and each output byte once, whatever the
kernel reads again; the work is counted from the inputs and the call's
result, never from a kernel's launch geometry, so a later kernel doing
the same work is held to the same least time.
"""

from __future__ import annotations

import math

#: published H100 SXM rates (700 W): device-memory bytes/s, f32
#: (non-tensor) FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: the H100 SXM's L2 cache
L2_BYTES = 50 * 2 ** 20

#: per-axis weight operations of one blot tap (chip_smoke.B2_WEIGHT_OPS)
B2_WEIGHT_OPS = {"nearest": 0, "linear": 1, "poly3": 5, "poly5": 5,
                 "spline3": 5, "sinc": 10}
#: taps a side of each blot interpolant
B2_TAPS = {"nearest": 1, "linear": 2, "poly3": 4, "poly5": 6, "spline3": 4,
           "sinc": 6}


def bound(nbytes, flops):
    """(seconds, 'bytes' | 'operations'): the least time for the work."""
    tb, tf = nbytes / HBM_BPS, flops / F32_FLOPS
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def b1_work(in_pixels: float, out_planes: int, out_shape, weights: bool,
            pixfrac: float = 1.0, ratio: float = 1.0):
    """(bytes, flops) of one square-kernel deposit: each input pixel's
    value, optional weight and pixmap read (4 + 4 + 8 bytes), its
    overlap with K x K cells (~12 operations each), and ``out_planes``
    science and weight planes of ``out_shape`` written."""
    K = int(math.ceil(pixfrac * ratio)) + 1
    per_in = 4 + (4 if weights else 0) + 8
    Ho, Wo = out_shape
    return (in_pixels * per_in + out_planes * Ho * Wo * 8,
            in_pixels * K * K * 12)


def b2_work(rows: int, cut_shape, footprints: int, image_pixels: int,
            interp: str = "poly5"):
    """(bytes, flops) of one blot gather of ``rows`` cutouts: the image
    pixels their footprints cover (``footprints`` distinct windows of the
    cutout plus the interpolant's reach, at most the image), x and y read,
    values (f32) and validity (bytes) written; per output taps² multiply-
    adds and two axes of tap weights."""
    h, w = cut_shape
    taps = B2_TAPS[interp]
    n = rows * h * w
    npix = min(footprints * (h + taps - 1) * (w + taps - 1), image_pixels)
    return (4 * npix + 8 * n + 5 * n,
            n * (2 * taps * taps + 2 * B2_WEIGHT_OPS[interp] * taps))


def b3_flops(B, H, W, nwin, ny, nx):
    """Least f32 operations of the windowed measurement on B pairs: each
    side's normalisation and its half-spectrum as a real FFT (~2.5 N log2
    N), then the matrix DFTs of the coarse lags and the window, which an
    FFT would not shorten."""
    Wr = W // 2 + 1
    per = (2 * (2.5 * H * W * math.log2(H * W) + 8 * H * W)
           + 8 * H * Wr
           + ny * Wr * H * 8 + ny * nx * Wr * 5
           + 12 * H * Wr
           + nwin * Wr * H * 8 + nwin * nwin * Wr * 4)
    return B * per


def b3_work(pairs: int, cut_shape, usfac: int, fit_box: int):
    """(bytes, flops) of one windowed measurement of ``pairs`` masked
    pairs: both cutouts and their mask read (4 + 4 + 1 bytes a pixel), the
    (nwin, nwin) window and the two coarse shifts written."""
    h, w = cut_shape
    nwin = -(-(usfac + fit_box + 1) // 8) * 8
    return (pairs * (h * w * 9 + nwin * nwin * 4 + 8),
            b3_flops(pairs, h, w, nwin, fit_box, fit_box))


def visit_sources(run, call):
    """(sources, cutout shape) of ``call``'s visit as the yardstick's
    catalog of the same frames counts them (the program's result carries
    neither), or None where the reference did not run on it."""
    ref = run.refs.get(call["k"])
    return None if ref is None else (ref.n_sources, ref.cut_shape)


def share(run, label: str, pattern: str, work):
    """100 x the least time of the traced calls' kernel launches over the
    device time of the traced operations whose name matches ``pattern``;
    None where the trace saw none. ``work(run, call)`` gives a call's
    [(bytes, flops, launches)]. Notes which of bytes and operations bound
    the work, and the launches counted beside those traced."""
    from portbench.trace import kernel

    seen = kernel(run.trace, pattern)
    if seen is None:
        return None
    dev_s, traced = seen
    least, counted, kinds = 0.0, 0, set()
    for call in run.calls[:run.traced_calls]:
        for nbytes, flops, count in work(run, call):
            if count <= 0:
                continue
            s, by = bound(nbytes, flops)
            least += s * count
            counted += count
            kinds.add(by)
    if not counted or dev_s <= 0:
        return None
    run.notes.append(f"{label}: bound by {'/'.join(sorted(kinds))}; "
                     f"launches counted {counted}, traced {traced}")
    return 100.0 * least / dev_s
