"""Resample: combine exposures into a reference image (drizzle on the card).

Counterpart of ``subpixal_tpu/resample/__init__.py``: the ``Exposure``
container, rate-unit data and statistical weights
(``exposure_rate_data``, ``exposure_pixel_weight``), the output grid
(``make_output_wcs``) and ``Drizzle`` with ``execute`` and its products.
Pixmaps are host float64 (:func:`subpixal_tpu_torch.blot.compute_pixmap`)
below :func:`~subpixal_tpu_torch.blot.device_pixmap_min_pixels` and
float32 on the Drizzle's device from there (256² on CUDA, 2048² on the
CPU, as the JAX package's ``_frame_pixmap``); every deposit goes through
kernel B1
(:func:`subpixal_tpu_torch.kernels.drizzle.drizzle_deposit`) on the
Drizzle's ``device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .blot import (compute_pixmap, compute_pixmap_device,
                   device_pixmap_min_pixels)
from .kernels.drizzle import drizzle_deposit
from .ops.drizzle import drizzle_combine
from .wcs import TanWCS

__all__ = ["Drizzle", "Exposure", "make_output_wcs", "exposure_rate_data",
           "exposure_pixel_weight"]


def _plane(a):
    return None if a is None else np.asarray(a, np.float32)


class Exposure:
    """One input exposure: science data + weight + WCS (+ metadata), all
    host numpy. ``data_units`` is ``'rate'`` or ``'counts'`` (converted
    to rate with ``exptime`` before combination); ``err`` / ``ivm`` are
    optional error / inverse-variance maps in the units of ``data``."""

    def __init__(self, data, wcs: TanWCS, weight=None, exptime: float = 1.0,
                 name: str = "", data_units: str = "rate", err=None,
                 ivm=None):
        if data_units not in ("rate", "counts"):
            raise ValueError(f"data_units must be 'rate' or 'counts', "
                             f"got {data_units!r}")
        self.data = _plane(data)
        self.wcs = wcs
        self.weight = _plane(weight)
        self.exptime = float(exptime)
        self.data_units = data_units
        self.err = _plane(err)
        self.ivm = _plane(ivm)
        self.name = name or f"exposure@{id(self):x}"

    def __repr__(self):
        return f"Exposure({self.name!r}, shape={self.data.shape})"


def exposure_rate_data(exp: Exposure) -> np.ndarray:
    """Science data in rate units ('counts' data divided by exptime)."""
    if exp.data_units == "counts":
        return exp.data / np.float32(max(exp.exptime, 1e-30))
    return exp.data


def exposure_pixel_weight(exp: Exposure, wht_type: str = "exptime") -> tuple:
    """(base, mask): the exposure's statistical deposit weight (scalar
    when uniform) and its user/bad-pixel weight (``exp.weight``, may be
    None). ``wht_type``: 'exptime' (w = exptime), 'ivm', 'error'
    (w = 1/err²) or 'uniform' — AstroDrizzle's ``final_wht_type``."""
    t = max(float(exp.exptime), 1e-30)
    if wht_type in ("exptime", "exp"):
        base = t
    elif wht_type == "uniform":
        base = 1.0
    elif wht_type == "ivm":
        if exp.ivm is None:
            raise ValueError(f"wht_type='ivm' but exposure {exp.name!r} "
                             "has no ivm array")
        ivm = np.asarray(exp.ivm, np.float32)
        # var(rate) = var(counts) / t^2  ->  ivm_rate = ivm_counts * t^2
        base = ivm * np.float32(t * t) if exp.data_units == "counts" else ivm
    elif wht_type in ("error", "err"):
        if exp.err is None:
            raise ValueError(f"wht_type='error' but exposure {exp.name!r} "
                             "has no err array")
        err = np.asarray(exp.err, np.float64)
        if exp.data_units == "counts":
            err = err / t
        with np.errstate(divide="ignore", invalid="ignore"):
            base = np.where(err > 0, 1.0 / (err * err), 0.0
                            ).astype(np.float32)
    else:
        raise ValueError(f"unknown wht_type: {wht_type!r} (expected "
                         "'exptime' | 'ivm' | 'error' | 'uniform')")
    return base, exp.weight


def make_output_wcs(wcs_list: Sequence[TanWCS],
                    shapes: Sequence[tuple[int, int]],
                    pscale: float | None = None,
                    pscale_ratio: float = 1.0):
    """North-up TAN output grid at the mean sky position covering every
    input footprint (pixel scale ``pscale`` arcsec, default the mean
    input scale times ``pscale_ratio``). Returns (wcs, (H, W))."""
    crvals = np.array([w.crval for w in wcs_list])
    ra0 = np.deg2rad(crvals[:, 0])
    dec0 = np.deg2rad(crvals[:, 1])
    cen = np.array([(np.cos(dec0) * np.cos(ra0)).mean(),
                    (np.cos(dec0) * np.sin(ra0)).mean(),
                    np.sin(dec0).mean()])
    cen /= np.linalg.norm(cen)
    crval = np.array([np.rad2deg(np.arctan2(cen[1], cen[0])) % 360.0,
                      np.rad2deg(np.arcsin(cen[2]))])
    if pscale is None:
        pscale = float(np.mean([w.pscale for w in wcs_list])) * pscale_ratio
    s = pscale / 3600.0
    out = TanWCS(crpix=np.zeros(2), crval=crval,
                 cd=np.array([[-s, 0.0], [0.0, s]]))
    xs, ys = [], []
    for w, (H, W) in zip(wcs_list, shapes):
        cx = np.array([0.0, W - 1.0, 0.0, W - 1.0])
        cy = np.array([0.0, 0.0, H - 1.0, H - 1.0])
        px, py = out.world_to_pixel(*w.pixel_to_world(cx, cy))
        xs.append(px)
        ys.append(py)
    xs = np.concatenate(xs)
    ys = np.concatenate(ys)
    x0, x1 = np.floor(xs.min()) - 1, np.ceil(xs.max()) + 1
    y0, y1 = np.floor(ys.min()) - 1, np.ceil(ys.max()) + 1
    out = out.replace(crpix=np.array([-x0, -y0]))
    return out, (int(y1 - y0 + 1), int(x1 - x0 + 1))


def _not_in_slice(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, {item})")


class Drizzle:
    """Drizzle combiner on one device.

    ``pixfrac``, ``kernel``, ``fillval``, the output pixel scale
    (``pscale`` / ``pscale_ratio``) and ``wht_type`` mirror the JAX
    package's ``Drizzle``. ``device`` ('cuda' by default) holds the
    accumulators; on a CUDA device every deposit runs kernel B1, on the
    CPU its plain version.
    """

    def __init__(self, exposures: Sequence[Exposure] | None = None,
                 output_wcs: TanWCS | None = None,
                 output_shape: tuple[int, int] | None = None,
                 pixfrac: float = 1.0, kernel: str = "square",
                 fillval: float = 0.0, pscale: float | None = None,
                 pscale_ratio: float = 1.0, wht_type: str = "exptime",
                 device="cuda", spatial_mesh=None):
        if spatial_mesh is not None:
            raise _not_in_slice("Drizzle(spatial_mesh=...)", "A16")
        self.exposures: list[Exposure] = list(exposures or [])
        names = [e.name for e in self.exposures]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate exposure name(s) {dup}: give each "
                             "exposure a unique name")
        self.pixfrac = float(pixfrac)
        self.kernel = kernel
        self.fillval = float(fillval)
        self.pscale = pscale
        self.pscale_ratio = float(pscale_ratio)
        self.wht_type = wht_type
        self.device = torch.device(device)
        self._owcs = output_wcs
        self._oshape = output_shape
        self._sci_acc = None
        self._wht_acc = None

    def _ensure_output_grid(self):
        if self._owcs is None or self._oshape is None:
            if not self.exposures:
                raise ValueError("no exposures and no explicit output grid")
            owcs, oshape = make_output_wcs(
                [e.wcs for e in self.exposures],
                [e.data.shape for e in self.exposures],
                pscale=self.pscale, pscale_ratio=self.pscale_ratio)
            self._owcs = self._owcs or owcs
            self._oshape = self._oshape or oshape

    def _frame_pixmap(self, wcs: TanWCS, shape: tuple[int, int]):
        """Drizzle pixmap: f64 host for small frames, f32 on the device
        from ``device_pixmap_min_pixels`` (the deposit only needs
        mpix-class grids)."""
        if shape[0] * shape[1] >= device_pixmap_min_pixels(self.device):
            return compute_pixmap_device(wcs, self._owcs, shape,
                                         device=self.device)
        return compute_pixmap(wcs, self._owcs, shape)

    def _deposit(self, exp: Exposure):
        H, W = exp.data.shape
        px, py = self._frame_pixmap(exp.wcs, (H, W))
        base, mask = exposure_pixel_weight(exp, self.wht_type)
        # a scalar base weight scales the (linear) deposit afterwards
        scale = 1.0
        if np.isscalar(base) or np.ndim(base) == 0:
            scale, wht = float(base), mask
        else:
            wht = base if mask is None else base * mask

        def dev(a):  # host planes, or device pixmaps already in place
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a, np.float32)
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=self.device).contiguous()

        s, w, _ = drizzle_deposit(
            dev(exposure_rate_data(exp)), None if wht is None else dev(wht),
            dev(px), dev(py), self._oshape, pixfrac=self.pixfrac,
            pscale_ratio=exp.wcs.pscale / self._owcs.pscale,
            kernel=self.kernel)
        if scale != 1.0:
            s = s * np.float32(scale)
            w = w * np.float32(scale)
        return s, w

    def execute(self) -> None:
        """(Re)drizzle the full stack."""
        self._ensure_output_grid()
        sci = torch.zeros(self._oshape, dtype=torch.float32,
                          device=self.device)
        wht = torch.zeros_like(sci)
        for exp in self.exposures:
            s, w = self._deposit(exp)
            sci = sci + s
            wht = wht + w
        self._sci_acc, self._wht_acc = sci, wht

    def fast_add_image(self, exp: Exposure) -> None:
        raise _not_in_slice("Drizzle.fast_add_image", "A10")

    def fast_drop_image(self, name: str) -> None:
        raise _not_in_slice("Drizzle.fast_drop_image", "A10")

    def fast_replace_image(self, exp: Exposure) -> None:
        raise _not_in_slice("Drizzle.fast_replace_image", "A10")

    @property
    def output_sci(self) -> np.ndarray:
        if self._sci_acc is None:
            self.execute()
        return drizzle_combine(self._sci_acc, self._wht_acc,
                               fill=self.fillval).cpu().numpy()

    @property
    def output_wht(self) -> np.ndarray:
        if self._wht_acc is None:
            self.execute()
        return self._wht_acc.cpu().numpy()

    @property
    def output_wcs(self) -> TanWCS:
        self._ensure_output_grid()
        return self._owcs

    @property
    def output_shape(self) -> tuple[int, int]:
        self._ensure_output_grid()
        return self._oshape
