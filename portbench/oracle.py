"""Frozen copy of bench.py's _np_find_displacement: the float64 oracle of
one pair's displacement (NCC, FFT, matrix-DFT upsampling around the coarse
peak, weighted log-quadratic fit), kept here as the benchmark's own."""

import numpy as np


def find_displacement(ref, img, usfac=10, kfit=5):
    """One pair, reference-style: NCC + FFT + upsampled DFT + peak fit."""
    h, w = ref.shape

    def norm(a):
        a = a.astype(np.float64)
        a = a - a.mean()
        s = a.std()
        return a / (s * np.sqrt(a.size) + 1e-30)

    r = norm(ref)
    i = norm(img)
    Fr = np.fft.fft2(r)
    Fi = np.fft.fft2(i)
    G = Fi * np.conj(Fr)
    cc = np.fft.ifft2(G).real
    cc_s = np.fft.fftshift(cc)
    py, px = np.unravel_index(np.argmax(cc_s), cc_s.shape)
    s0y, s0x = py - h // 2, px - w // 2

    # matrix-DFT upsampling around the coarse peak (Guizar-Sicairos style)
    n = usfac + kfit + 3
    fy = np.fft.fftfreq(h) * h
    fx = np.fft.fftfreq(w) * w
    ty = s0y + (np.arange(n) - n // 2) / usfac
    tx = s0x + (np.arange(n) - n // 2) / usfac
    kr = np.exp(2j * np.pi * np.outer(ty, fy) / h)
    kc = np.exp(2j * np.pi * np.outer(fx, tx) / w)
    C = (kr @ G @ kc).real / (h * w)

    # quadratic fit on log surface around the argmax
    qy, qx = np.unravel_index(np.argmax(C), C.shape)
    k = kfit
    y0 = min(max(qy - k // 2, 0), n - k)
    x0 = min(max(qx - k // 2, 0), n - k)
    box = C[y0:y0 + k, x0:x0 + k]
    bmax = box.max()
    z = np.log(np.clip(box / bmax, 1e-8, None))
    wts = np.clip(box / bmax, 0, 1).ravel()
    c = (k - 1) / 2.0
    gy, gx = np.mgrid[0:k, 0:k].astype(np.float64)
    X = np.stack([np.ones(k * k), (gx - c).ravel(), (gy - c).ravel(),
                  ((gx - c) ** 2).ravel(), ((gx - c) * (gy - c)).ravel(),
                  ((gy - c) ** 2).ravel()], 1)
    A = X * wts[:, None]
    coef, *_ = np.linalg.lstsq(A, z.ravel() * wts, rcond=None)
    c0, c1, c2, c3, c4, c5 = coef
    det = 4 * c3 * c5 - c4 * c4
    if det > 0 and c3 < 0:
        sx = (-2 * c5 * c1 + c4 * c2) / det
        sy = (c4 * c1 - 2 * c3 * c2) / det
    else:
        sx = sy = 0.0
    ux = x0 + c + sx
    uy = y0 + c + sy
    dx = s0x + (ux - n // 2) / usfac
    dy = s0y + (uy - n // 2) / usfac
    return dx, dy
