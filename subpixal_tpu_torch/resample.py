"""Resample: combine exposures into a reference image (drizzle on the card).

Counterpart of ``subpixal_tpu/resample/__init__.py``: the ``Resample``
interface, the ``Exposure`` container, rate-unit data and statistical
weights (``exposure_rate_data``, ``exposure_pixel_weight``), the output
grid (``make_output_wcs``), the static bad-pixel mask
(``make_static_mask``) and ``Drizzle``: ``execute`` with its per-exposure
cache, fast add / drop / replace, the context map, and the AstroDrizzle
stages ``match_sky``, ``apply_static_mask`` and ``reject_cr``.

Every deposit goes through kernel B1
(:mod:`subpixal_tpu_torch.kernels.drizzle`) on the Drizzle's ``device``.
A same-shape stack of more than one exposure, in the device-pixmap regime
(:func:`~subpixal_tpu_torch.blot.device_pixmap_min_pixels`: 256² on CUDA,
2048² on the CPU), is deposited by ONE launch that keeps each exposure's
(Ho, Wo) planes, inside the setup program ``deposit_stack``
(``aot.get_executable``: a CUDA graph replayed on a card); otherwise
each exposure is deposited on its own, through host float64 pixmaps
below that size and float32 device pixmaps from it.

Under ``spatial_mesh=`` the accumulators and the per-exposure planes are
this rank's row band of the output (:mod:`.parallel.spatial`): the same
deposits through kernel B1 with the band's row offset.

An exposure may hold ``torch.Tensor`` planes (the JAX package's
device-resident ``jax.Array`` contract): they are kept on their device as
float32 and never fetched; the stages then run their tensor branches.
No stage writes into a caller's tensor or array: it rebinds the
exposure's attribute to a new one.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .aot import get_executable
from .blot import (_pixmap_stack_core, _stacked_wcs_params, compute_pixmap,
                   compute_pixmap_device, device_pixmap_min_pixels)
from .kernels import use_pallas as _use_pallas
from .kernels.drizzle import drizzle_deposit, drizzle_deposit_stack
from .ops.drizzle import drizzle_combine
from .ops.interp import sample_image
from .parallel.spatial import (_agree, band_rows, drizzle_deposit_spatial,
                               gather_rows, sample_spatial)
from .tracing import recording, span, to_host
from .wcs import TanWCS

__all__ = ["Resample", "Drizzle", "Exposure", "make_output_wcs",
           "make_static_mask", "exposure_rate_data", "exposure_pixel_weight",
           "nanmedian"]


def _plane(a):
    """float32 plane: a tensor stays on its device, anything else becomes
    host numpy."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a if a.dtype == torch.float32 else a.to(torch.float32)
    return np.asarray(a, np.float32)


def _host(a):
    """A plane as host numpy (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return to_host(a.detach()).numpy()
    return np.asarray(a)


def _mul(a, b):
    """a * b for arrays, tensors or scalars, on the tensor's device when
    either is a tensor."""
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor) \
            and np.ndim(b):
        b = torch.as_tensor(np.asarray(b, np.float32), device=a.device)
    return a * b


def _stack_planes(planes, shape, device) -> torch.Tensor:
    """(E, H, W) float32 stack on ``device`` of planes given as arrays,
    tensors or scalars (a scalar fills its plane). Host planes cross to
    the device in one copy; tensors are stacked where they are moved."""
    if any(isinstance(p, torch.Tensor) for p in planes):
        return torch.stack([torch.as_tensor(
            p, dtype=torch.float32, device=device).expand(tuple(shape))
            for p in planes])
    return torch.as_tensor(np.stack([
        np.broadcast_to(np.asarray(p, np.float32), tuple(shape))
        for p in planes]), device=device)


def nanmedian(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """``np.nanmedian``: the median of the non-NaN values along ``dim``
    (of all values when None), NaN where there is none. ``torch.median``
    and ``torch.nanmedian`` take the lower of the two middle values of an
    even count; this averages them, as numpy does: sort (NaN sorts last),
    count the non-NaN values and take the mean of the middle pair."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    s = torch.sort(x, dim=dim).values
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = s.gather(dim, torch.clamp((n - 1) // 2, min=0))
    hi = s.gather(dim, torch.clamp(n // 2, min=0))
    med = torch.where(n > 0, (lo + hi) / 2, torch.full_like(lo, torch.nan))
    return med.squeeze(dim)


def _deposit_stack_core(params, data, wht, scales, *, shape, modes, oshape,
                        pixfrac, kernel, ratios, use_pallas):
    """The program ``deposit_stack``: the stack's pixmaps from its packed
    WCS parameters (``blot._stacked_wcs_params``), ONE per-plane B1
    launch, each exposure's planes times its weight scale, and the sums
    over the exposures. Returns (sci planes, wht planes, sci, wht)."""
    px, py = _pixmap_stack_core(params, shape=shape, modes=modes)
    s, w, _ = drizzle_deposit_stack(data, wht, px, py, oshape,
                                    pixfrac=pixfrac, pscale_ratio=ratios,
                                    kernel=kernel, per_plane=True,
                                    use_pallas=use_pallas)
    sc = scales[:, None, None]
    s, w = s * sc, w * sc
    return s, w, s.sum(0), w.sum(0)


def _exposure_stack_key(exposures):
    """Identity key for a cached device rate-data stack: any rebinding
    of an exposure's ``.data`` (e.g. ``match_sky``) or a different
    exposure list produces a different key."""
    return tuple((id(e), id(e.data), float(e.exptime), str(e.data_units))
                 for e in exposures)


def make_static_mask(exposures: "Sequence[Exposure]",
                     nsigma: float = 4.0) -> np.ndarray:
    """Static bad-pixel mask in the DETECTOR frame (True = bad).

    The AstroDrizzle "static mask" stage: a pixel whose sky-subtracted,
    noise-normalized value is below ``-nsigma`` in EVERY exposure (the
    pixel-wise maximum over the stack) is a detector defect; a transient
    low pixel has a normal value in some exposure and escapes. When any
    exposure holds a tensor the stack is normalized and max-combined on
    its device and only the boolean mask comes back to the host.
    """
    from .catalogs import sigma_clipped_stats

    dev = next((e.data.device for e in exposures
                if isinstance(e.data, torch.Tensor)), None)
    if dev is not None:
        from .catalogs_device import sigma_clipped_stats_device

        hi = None
        for exp in exposures:
            d = torch.as_tensor(exp.data, dtype=torch.float32, device=dev)
            _, med, std = sigma_clipped_stats_device(d)
            z = (d - med) / torch.clamp(std, min=1e-12)
            hi = z if hi is None else torch.maximum(hi, z)
        return to_host(hi < -float(nsigma)).numpy()
    stack = []
    for exp in exposures:
        _, med, std = sigma_clipped_stats(exp.data)
        stack.append((exp.data - med) / max(std, 1e-12))
    hi = np.max(np.stack(stack), axis=0)
    return hi < -float(nsigma)


def _reject_cr_one_device(blot, ok, rate, weight, snr, scale):
    """One exposure's driz_cr flagging on the tensors' device.

    The host branch of :meth:`Drizzle.reject_cr` in torch: local
    4-neighbour gradient of the blotted model, a MAD-robust residual sigma
    over the usable pixels, ``|resid| > snr*sig + scale*deriv`` flags.
    Returns (cr_mask bool, new_weight f32).
    """
    p = F.pad(blot[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    deriv = torch.maximum(
        torch.maximum((blot - p[:-2, 1:-1]).abs(), (blot - p[2:, 1:-1]).abs()),
        torch.maximum((blot - p[1:-1, :-2]).abs(), (blot - p[1:-1, 2:]).abs()))
    resid = rate - blot
    sel = ok & torch.isfinite(resid)
    if weight is not None:
        sel = sel & (weight > 0)
    rs = torch.where(sel, resid, torch.full_like(resid, torch.nan))
    sig_std = torch.nan_to_num(torch.sqrt(torch.nanmean(
        (rs - torch.nanmean(rs)) ** 2)))
    med_r = nanmedian(rs)
    mad = nanmedian((rs - med_r).abs()) * 1.4826
    sig = torch.where(mad > 0, mad, sig_std)
    sig = torch.where(sel.any(), sig, torch.zeros_like(sig))
    cr = ok & (resid.abs() > snr * sig + scale * deriv)
    wht = torch.ones_like(blot) if weight is None else weight
    return cr, torch.where(cr, torch.zeros_like(wht), wht)


class Exposure:
    """One input exposure: science data + weight + WCS (+ metadata).

    ``data_units`` is ``'rate'`` or ``'counts'`` (converted to rate with
    ``exptime`` before combination); ``err`` / ``ivm`` are optional error
    / inverse-variance maps in the units of ``data``. Planes given as
    ``torch.Tensor`` stay on their device (as float32); anything else is
    held as host float32 numpy.
    """

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

    def copy(self) -> "Exposure":
        """A new Exposure: host arrays are copied, tensors shared (no
        stage writes into one)."""
        def cp(a):
            return a if a is None or isinstance(a, torch.Tensor) else a.copy()

        return Exposure(cp(self.data), self.wcs.copy(),
                        weight=cp(self.weight), exptime=self.exptime,
                        name=self.name, data_units=self.data_units,
                        err=cp(self.err), ivm=cp(self.ivm))

    def __repr__(self):
        return f"Exposure({self.name!r}, shape={tuple(self.data.shape)})"


def exposure_rate_data(exp: Exposure):
    """Science data in rate units ('counts' data divided by exptime), on
    the data's own device when it is a tensor."""
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
        ivm = np.asarray(_host(exp.ivm), np.float32)
        # var(rate) = var(counts) / t^2  ->  ivm_rate = ivm_counts * t^2
        base = ivm * np.float32(t * t) if exp.data_units == "counts" else ivm
    elif wht_type in ("error", "err"):
        if exp.err is None:
            raise ValueError(f"wht_type='error' but exposure {exp.name!r} "
                             "has no err array")
        err = np.asarray(_host(exp.err), np.float64)
        if exp.data_units == "counts":
            err = err / t
        with np.errstate(divide="ignore", invalid="ignore"):
            base = np.where(err > 0, 1.0 / (err * err), 0.0
                            ).astype(np.float32)
    else:
        raise ValueError(f"unknown wht_type: {wht_type!r} (expected "
                         "'exptime' | 'ivm' | 'error' | 'uniform')")
    return base, exp.weight


def _weight_parts(exp: Exposure, wht_type: str):
    """(scale, plane): the deposit weight as a scalar that scales the
    (linear) deposit afterwards and a per-pixel plane (None: unit)."""
    base, mask = exposure_pixel_weight(exp, wht_type)
    if np.isscalar(base) or np.ndim(base) == 0:
        return float(base), mask
    return 1.0, base if mask is None else _mul(base, mask)


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


class Resample:
    """Interface: combine input exposures into one reference image.

    ``execute()`` (re)builds the combined product; ``output_sci`` /
    ``output_wht`` / ``output_wcs`` expose it; ``fast_add_image`` /
    ``fast_drop_image`` update it incrementally.
    """

    def execute(self) -> None:
        raise NotImplementedError

    @property
    def output_sci(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def output_wht(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def output_wcs(self) -> TanWCS:
        raise NotImplementedError


class Drizzle(Resample):
    """Drizzle combiner on one device, with cached per-exposure deposits.

    ``pixfrac``, ``kernel``, ``fillval``, the output pixel scale
    (``pscale`` / ``pscale_ratio``) and ``wht_type`` mirror the JAX
    package's ``Drizzle``; ``config`` takes AstroDrizzle-style keys
    (:attr:`CONFIG_KEYS`). ``device`` ('cuda' by default) holds the
    accumulators; on a CUDA device every deposit runs kernel B1, on the
    CPU its plain version. ``use_pallas`` (also a ``config`` key, kept as
    ``self.use_pallas``, :func:`~subpixal_tpu_torch.kernels.use_pallas`
    on ``device``): ``False`` runs the plain versions on any device, in
    ``execute``, fast add / replace and the stages' blot-back; ``True``
    on a device that is not CUDA raises ``ValueError`` here.

    ``spatial_mesh`` (a 1-D rows mesh from ``parallel.make_mesh`` or a
    2-D one from ``parallel.make_mesh2d``) row-band-shards the output:
    every rank of the mesh builds the same Drizzle, and its accumulators
    and per-exposure planes are its own band of the mosaic
    (``parallel.band_rows`` rows, on ``spatial_mesh.device``), deposited
    by kernel B1 with the band's row offset
    (``parallel.drizzle_deposit_spatial``). ``execute``, fast add / drop /
    replace, the stages and ``align_images`` work band by band;
    ``output_sci``, ``output_wht`` and ``output_ctx`` gather the bands and
    so are collectives: EVERY rank must read them, or every rank waits.
    Ranks of a 2-D mesh's frames axis hold the same band: after each
    deposit they take the planes of the rank at frames index 0, so they
    agree to the bit.
    """

    #: AstroDrizzle config keys accepted via ``Drizzle(config=...)`` and
    #: the constructor argument each maps to
    CONFIG_KEYS = {
        "final_pixfrac": "pixfrac",
        "final_kernel": "kernel",
        "final_fillval": "fillval",
        "final_scale": "pscale",
        "final_wht_type": "wht_type",
    }

    #: AstroDrizzle stage keys a real config carries; they are ignored
    #: with a warning (the stages are methods here). ``final_*`` keys are
    #: listed one by one, so a typo of a supported one still raises.
    _ASTRODRIZZLE_PREFIXES = (
        "driz_sep_", "driz_cr", "combine_", "sky", "static", "median",
        "blot", "crbit", "in_memory", "build", "context", "clean",
        "preserve", "restore", "resetbits", "num_cores", "runfile",
        "input", "output", "updatewcs", "wcskey", "proc_unit", "coeffs",
        "group", "mdriztab", "stepsize")
    _ASTRODRIZZLE_FINAL = {
        "final_wcs", "final_rot", "final_units", "final_bits",
        "final_wt_scl", "final_refimage", "final_outnx", "final_outny",
        "final_ra", "final_dec", "final_crpix1", "final_crpix2"}

    #: the stacked execute holds every frame's pixmap pair at once: stacks
    #: whose pixmaps would take more bytes than this go frame by frame
    _STACK_EXEC_MAX_PIXMAP_BYTES = 1_500_000_000

    def __init__(self, exposures: Sequence[Exposure] | None = None,
                 output_wcs: TanWCS | None = None,
                 output_shape: tuple[int, int] | None = None,
                 pixfrac: float = 1.0, kernel: str = "square",
                 fillval: float = 0.0, pscale: float | None = None,
                 pscale_ratio: float = 1.0,
                 use_pallas: bool | str = "auto", wht_type: str = "exptime",
                 config: dict | None = None, device=None,
                 spatial_mesh=None):
        if spatial_mesh is not None:
            if device is not None and torch.device(device).type \
                    != spatial_mesh.device.type:
                raise ValueError(f"spatial_mesh runs on "
                                 f"{spatial_mesh.device}, but "
                                 f"device={device}")
            device = spatial_mesh.device
        if config:
            args = dict(pixfrac=pixfrac, kernel=kernel, fillval=fillval,
                        pscale=pscale, pscale_ratio=pscale_ratio,
                        wht_type=wht_type, use_pallas=use_pallas)
            args.update(self._from_config(config, set(args)))
            pixfrac, kernel, fillval = (args["pixfrac"], args["kernel"],
                                        args["fillval"])
            pscale, pscale_ratio, wht_type = (args["pscale"],
                                              args["pscale_ratio"],
                                              args["wht_type"])
            use_pallas = args["use_pallas"]
        self.exposures: list[Exposure] = list(exposures or [])
        names = [e.name for e in self.exposures]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"duplicate exposure name(s) {dup}: the per-exposure "
                "deposit cache and fast add/drop/replace paths are keyed "
                "by name — give each exposure a unique name")
        self.pixfrac = float(pixfrac)
        self.kernel = kernel
        self.fillval = float(fillval)
        self.pscale = pscale
        self.pscale_ratio = float(pscale_ratio)
        self.use_pallas = use_pallas
        self.wht_type = wht_type
        self.device = torch.device("cuda" if device is None else device)
        # use_pallas=True off CUDA raises before any work
        _use_pallas(use_pallas, self.device)
        self.spatial_mesh = spatial_mesh
        self._owcs = output_wcs
        self._oshape = output_shape
        self._sci_acc = None
        self._wht_acc = None
        self._per_exp: dict[str, tuple] = {}  # name -> (sci_dep, wht_dep)
        self._data_stack = None   # device rate-data stack (stacked path)
        self._data_stack_key = None
        self.last_execute_breakdown: dict[str, float] = {}

    @classmethod
    def _from_config(cls, config: dict, known: set) -> dict:
        """Constructor arguments from an AstroDrizzle-style config dict:
        EXP/IVM/ERR weight names and the 'INDEF' fill value mapped,
        recognised stage keys warned about and dropped, anything else
        rejected."""
        kw = {}
        for key, val in config.items():
            name = cls.CONFIG_KEYS.get(key, key)
            if name == "wht_type" and isinstance(val, str):
                val = {"EXP": "exptime", "IVM": "ivm",
                       "ERR": "error"}.get(val.upper(), val)
            if name == "fillval" and isinstance(val, str):
                # AstroDrizzle's default final_fillval is 'INDEF'
                # (undefined): the no-coverage fill here is 0.0
                val = 0.0 if val.strip().upper() == "INDEF" else float(val)
            kw[name] = val
        bad = set(kw) - known
        recognized = {k for k in bad
                      if str(k).lower().startswith(cls._ASTRODRIZZLE_PREFIXES)
                      or str(k).lower() in cls._ASTRODRIZZLE_FINAL}
        if recognized:
            warnings.warn(
                "ignoring AstroDrizzle config key(s) with no "
                f"equivalent here: {sorted(recognized)} (the sky/"
                "static-mask/CR stages are explicit methods: "
                "match_sky(), apply_static_mask(), reject_cr())",
                stacklevel=3)
            for k in recognized:
                kw.pop(k)
            bad -= recognized
        if bad:
            raise ValueError(
                f"unknown Drizzle config key(s): {sorted(bad)} "
                f"(accepted: {sorted(known | set(cls.CONFIG_KEYS))})")
        return kw

    def _invalidate(self):
        """Drop the combined product and the per-exposure cache."""
        self._per_exp.clear()
        self._sci_acc = self._wht_acc = None

    def _acc_shape(self) -> tuple[int, int]:
        """The accumulators' shape: the output grid, or this rank's band
        of it under a spatial mesh."""
        Ho, Wo = self._oshape
        if self.spatial_mesh is None:
            return Ho, Wo
        return band_rows(self.spatial_mesh, Ho), Wo

    def _zeros(self):
        return torch.zeros(self._acc_shape(), dtype=torch.float32,
                           device=self.device)

    def _gathered(self, band: torch.Tensor) -> np.ndarray:
        """A band plane as the whole (Ho, Wo) host plane (a collective
        under a spatial mesh)."""
        if self.spatial_mesh is None:
            return _host(band)
        return gather_rows(band, self._oshape[0], mesh=self.spatial_mesh)

    # -- setup ----------------------------------------------------------- #
    def _ensure_output_grid(self):
        if self._owcs is None or self._oshape is None:
            if not self.exposures:
                raise ValueError("no exposures and no explicit output grid")
            owcs, oshape = make_output_wcs(
                [e.wcs for e in self.exposures],
                [tuple(e.data.shape) for e in self.exposures],
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

    def _dev(self, a) -> torch.Tensor:
        """A plane as a contiguous float32 tensor on the Drizzle's device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, np.float32)
        return torch.as_tensor(a, dtype=torch.float32,
                               device=self.device).contiguous()

    def _deposit(self, exp: Exposure):
        """One exposure's (sci, wht) deposit, its scalar weight applied."""
        H, W = exp.data.shape
        px, py = self._frame_pixmap(exp.wcs, (H, W))
        scale, wht = _weight_parts(exp, self.wht_type)
        args = (self._dev(exposure_rate_data(exp)),
                None if wht is None else self._dev(wht), self._dev(px),
                self._dev(py), self._oshape)
        kw = dict(pixfrac=self.pixfrac,
                  pscale_ratio=exp.wcs.pscale / self._owcs.pscale,
                  kernel=self.kernel)
        if self.spatial_mesh is None:
            s, w, _ = drizzle_deposit(*args, **kw,
                                      use_pallas=self.use_pallas)
        else:  # this rank's band
            s, w = drizzle_deposit_spatial(self.spatial_mesh, *args, **kw,
                                           use_pallas=self.use_pallas)
        if scale != 1.0:
            s = s * np.float32(scale)
            w = w * np.float32(scale)
        return s, w

    def _execute_stack(self):
        """The whole stack in ONE deposit launch that keeps each
        exposure's planes: the program ``deposit_stack``
        (:func:`_deposit_stack_core`, eagerly under a spatial mesh), its
        inputs stacked and copied to the device first. Returns
        (sci_planes, wht_planes, sci, wht) or None when the stack is not
        eligible: one exposure, shapes that differ, frames below the
        device-pixmap size, or pixmaps beyond the memory gate. (The JAX
        package also needs one SIP structure across the stack; the port
        evaluates mixed stacks per group.) Each stage is a span of the
        current record."""
        exps = self.exposures
        E = len(exps)
        if E < 2 or len({tuple(e.data.shape) for e in exps}) != 1:
            return None
        shape = tuple(exps[0].data.shape)
        if shape[0] * shape[1] < device_pixmap_min_pixels(self.device):
            return None
        if E * shape[0] * shape[1] * 8 > self._STACK_EXEC_MAX_PIXMAP_BYTES:
            return None
        with span("resample.h2d_stack"):  # pageable copies: synchronous
            scales, whts = zip(*(_weight_parts(e, self.wht_type)
                                 for e in exps))
            data = _stack_planes([exposure_rate_data(e) for e in exps],
                                 shape, self.device)
            # no per-pixel weight anywhere: the kernel takes unit weights
            wht = (None if all(w is None for w in whts) else _stack_planes(
                [1.0 if w is None else w for w in whts], shape,
                self.device))
        with span("resample.wcs_params", device=self.device):
            params, modes = _stacked_wcs_params([e.wcs for e in exps],
                                                self._owcs, self.device)
            sc = torch.as_tensor(np.asarray(scales, np.float32),
                                 device=self.device)
        ratios = tuple(round(float(e.wcs.pscale / self._owcs.pscale), 6)
                       for e in exps)
        statics = dict(shape=shape, modes=modes, oshape=tuple(self._oshape),
                       pixfrac=self.pixfrac, kernel=self.kernel,
                       ratios=ratios, use_pallas=self.use_pallas)
        with span("resample.deposit_stack", device=self.device):
            if self.spatial_mesh is None:
                args = (params, data, wht, sc)
                out = get_executable("deposit_stack", _deposit_stack_core,
                                     args, statics=statics)(*args)
            else:  # the planes of this rank's band, eagerly (_agree gathers)
                px, py = _pixmap_stack_core(params, shape=shape, modes=modes)
                s, w = drizzle_deposit_spatial(
                    self.spatial_mesh, data, wht, px, py, self._oshape,
                    pixfrac=self.pixfrac, pscale_ratio=ratios,
                    kernel=self.kernel, per_plane=True,
                    use_pallas=self.use_pallas)
                s, w = _agree(self.spatial_mesh, s * sc[:, None, None],
                              w * sc[:, None, None])
                out = (s, w, s.sum(0), w.sum(0))
        # the rate-data stack stays for the align loop's staging, keyed on
        # the exposures' identities (any .data rebinding invalidates it)
        self._data_stack = data
        self._data_stack_key = _exposure_stack_key(exps)
        return out

    # -- public API ------------------------------------------------------ #
    def execute(self) -> None:
        """(Re)drizzle the full stack; caches per-exposure deposits.

        Each stage's host seconds land in ``self.last_execute_breakdown``
        (``output_grid``, ``h2d_stack``, ``wcs_params``, ``deposit_stack``
        or ``deposits``, and a program's ``{name}.compile``), and as
        ``resample.<stage>`` in the record of an ``align_images`` call
        around it (:mod:`~subpixal_tpu_torch.tracing`), with the device
        stages' ``.device`` seconds there. Nothing here waits for the
        device.
        """
        bd = self.last_execute_breakdown = {}
        with recording(bd, strip="resample."):
            with span("resample.output_grid"):
                self._ensure_output_grid()
            self._per_exp.clear()
            self._data_stack = self._data_stack_key = None  # free stale memory
            out = self._execute_stack()
            if out is not None:
                sci_s, wht_s, sci, wht = out
                for e, exp in enumerate(self.exposures):
                    self._per_exp[exp.name] = (sci_s[e], wht_s[e])
                self._sci_acc, self._wht_acc = sci, wht
                return
            with span("resample.deposits", device=self.device):
                sci, wht = self._zeros(), self._zeros()
                for exp in self.exposures:
                    s, w = _agree(self.spatial_mesh, *self._deposit(exp))
                    self._per_exp[exp.name] = (s, w)
                    sci = sci + s
                    wht = wht + w
                self._sci_acc, self._wht_acc = sci, wht

    def fast_add_image(self, exp: Exposure) -> None:
        """Add one exposure's contribution without redoing the stack."""
        self._ensure_output_grid()
        if self._sci_acc is None:
            self._sci_acc, self._wht_acc = self._zeros(), self._zeros()
        if exp not in self.exposures:
            if any(e.name == exp.name for e in self.exposures):
                raise ValueError(
                    f"an exposure named {exp.name!r} is already in the "
                    "stack (the deposit cache is keyed by name); use "
                    "fast_replace_image or a unique name")
            self.exposures.append(exp)
        s, w = _agree(self.spatial_mesh, *self._deposit(exp))
        self._per_exp[exp.name] = (s, w)
        self._sci_acc = self._sci_acc + s
        self._wht_acc = self._wht_acc + w

    def fast_drop_image(self, name: str) -> None:
        """Remove one exposure's cached contribution."""
        if name not in self._per_exp:
            raise KeyError(f"no cached deposit for {name!r}")
        s, w = self._per_exp.pop(name)
        self._sci_acc = self._sci_acc - s
        self._wht_acc = self._wht_acc - w
        self.exposures = [e for e in self.exposures if e.name != name]

    def fast_replace_image(self, exp: Exposure) -> None:
        """Drop + add in one call: refresh one exposure (e.g. after a WCS
        update) in the combined product."""
        if exp.name in self._per_exp:
            self.fast_drop_image(exp.name)
        self.fast_add_image(exp)

    @property
    def output_sci(self) -> np.ndarray:
        """The combined science plane on the host (under a spatial mesh
        the bands gathered, padding cropped: a collective)."""
        if self._sci_acc is None:
            self.execute()
        return self._gathered(drizzle_combine(self._sci_acc, self._wht_acc,
                                              fill=self.fillval))

    @property
    def output_wht(self) -> np.ndarray:
        """The summed weight plane on the host (a collective under a
        spatial mesh, as ``output_sci``)."""
        if self._wht_acc is None:
            self.execute()
        return self._gathered(self._wht_acc)

    @property
    def output_ctx(self) -> np.ndarray:
        """Context map: bit e set where exposure e contributed weight
        (AstroDrizzle's CTX product): (Ho, Wo) int32 for up to 32
        exposures, else (nplanes, Ho, Wo) with exposure e in plane
        e // 32, bit e % 32. The bit planes are built on the host."""
        if self._sci_acc is None:
            self.execute()
        Ho, Wo = self._oshape
        nplanes = max(1, -(-len(self.exposures) // 32))
        ctx = np.zeros((nplanes, Ho, Wo), np.uint32)
        for e, exp in enumerate(self.exposures):
            dep = self._per_exp.get(exp.name)
            if dep is not None:
                plane, bit = divmod(e, 32)
                ctx[plane] |= ((self._gathered(dep[1]) > 0).astype(
                    np.uint32) << np.uint32(bit))
        ctx = ctx.view(np.int32)
        return ctx[0] if nplanes == 1 else ctx

    def match_sky(self, subtract: bool = True,
                  skymethod: str = "match") -> np.ndarray:
        """Per-exposure sky estimation / matching (AstroDrizzle's sky
        stage).

        Each exposure's sky is the sigma-clipped median of its pixels (on
        the tensor's device for a tensor), taken to RATE units so that
        exposures of different exptimes compare. ``skymethod='match'``
        subtracts ``sky_e - min(sky)`` (the common level stays),
        ``'localmin'`` each absolute sky; the subtraction goes back to
        each exposure's own units and rebinds ``exp.data``. Returns the
        skies in rate units (before differencing).
        """
        from .catalogs import sigma_clipped_stats

        if skymethod not in ("match", "localmin"):
            raise ValueError(f"unknown skymethod: {skymethod!r}")
        skies = np.zeros(len(self.exposures))
        to_native = np.ones(len(self.exposures))
        for e, exp in enumerate(self.exposures):
            if isinstance(exp.data, torch.Tensor):
                from .catalogs_device import sigma_clipped_stats_device

                med = float(to_host(sigma_clipped_stats_device(exp.data)[1]))
            else:
                _, med, _ = sigma_clipped_stats(exp.data)
            scale = (float(exp.exptime)
                     if str(exp.data_units).lower().startswith("count")
                     and exp.exptime else 1.0)
            skies[e] = med / scale      # rate units
            to_native[e] = scale
        if subtract and len(self.exposures):
            sub = skies - skies.min() if skymethod == "match" else skies
            for exp, sky, scale in zip(self.exposures, sub, to_native):
                exp.data = exp.data - np.float32(sky * scale)
            self._invalidate()
        return skies

    def apply_static_mask(self, nsigma: float = 4.0) -> np.ndarray:
        """Build the stack's static bad-pixel mask and zero its weight
        in every exposure (AstroDrizzle's static-mask stage); a tensor
        exposure's new weight is built on its device."""
        mask = make_static_mask(self.exposures, nsigma=nsigma)
        if mask.any():
            for exp in self.exposures:
                t = next((a for a in (exp.data, exp.weight)
                          if isinstance(a, torch.Tensor)), None)
                if t is not None:
                    m = torch.as_tensor(mask, device=t.device)
                    wht = (torch.ones(tuple(exp.data.shape),
                                      dtype=torch.float32, device=t.device)
                           if exp.weight is None else torch.as_tensor(
                               exp.weight, dtype=torch.float32,
                               device=t.device))
                    exp.weight = torch.where(m, torch.zeros_like(wht), wht)
                else:
                    wht = (np.ones_like(exp.data) if exp.weight is None
                           else exp.weight.copy())
                    wht[mask] = 0.0
                    exp.weight = wht
            self._invalidate()
        return mask

    def reject_cr(self, snr: float = 4.0, scale: float = 1.2,
                  interp: str = "linear") -> list[np.ndarray]:
        """Cosmic-ray rejection against the median-combined stack
        (AstroDrizzle's ``driz_cr``).

        Each exposure's drizzled plane is median-combined on the output
        grid, the median blotted back onto each exposure's frame (plain
        :func:`~subpixal_tpu_torch.ops.interp.sample_image`), and pixels
        with ``|data - blot| > snr·sigma + scale·deriv`` (deriv: the
        blotted image's local gradient) flagged; their weights are zeroed
        and the stack re-drizzled. With any tensor exposure the median
        and the flagging run on the device, and so they do under a
        spatial mesh: the median of each rank's band, blotted back by
        ``parallel.sample_spatial``. Returns the per-exposure boolean CR
        masks (True = rejected). Needs >= 3 exposures.
        """
        if len(self.exposures) < 3:
            raise ValueError("CR rejection needs >= 3 exposures")
        if self._sci_acc is None:
            self.execute()
        Ho, Wo = self._oshape
        device_mode = self.spatial_mesh is not None or any(
            isinstance(e.data, torch.Tensor) for e in self.exposures)
        if device_mode:
            s_st = torch.stack([self._per_exp[e.name][0]
                                for e in self.exposures])
            w_st = torch.stack([self._per_exp[e.name][1]
                                for e in self.exposures])
            good = w_st > 0
            planes = torch.where(good, s_st / torch.where(
                good, w_st, torch.ones_like(w_st)),
                torch.full_like(s_st, torch.nan))
            med_t = torch.nan_to_num(nanmedian(planes, dim=0),
                                     nan=float(self.fillval))
        else:
            planes = np.full((len(self.exposures), Ho, Wo), np.nan,
                             np.float32)
            for e, exp in enumerate(self.exposures):
                s, w = (_host(a) for a in self._per_exp[exp.name])
                good = w > 0
                planes[e][good] = s[good] / w[good]
            with warnings.catch_warnings():
                # pixels covered by no exposure are all-NaN -> fillval
                warnings.simplefilter("ignore", RuntimeWarning)
                med = np.nanmedian(planes, axis=0)
            med_t = self._dev(np.nan_to_num(med, nan=float(self.fillval)))

        masks: list[np.ndarray] = []
        for exp in self.exposures:
            px, py = compute_pixmap(exp.wcs, self._owcs, exp.data.shape)
            if self.spatial_mesh is None:
                blot_t, ok_t = sample_image(med_t, self._dev(px),
                                            self._dev(py), interp=interp)
            else:
                blot_t, ok_t = sample_spatial(
                    self.spatial_mesh, med_t, self._dev(px), self._dev(py),
                    interp=interp, logical_rows=Ho,
                    use_pallas=self.use_pallas)
            if device_mode:
                weight = (None if exp.weight is None
                          else self._dev(exp.weight))
                cr_t, exp.weight = _reject_cr_one_device(
                    blot_t, ok_t, self._dev(exposure_rate_data(exp)), weight,
                    snr, scale)
                masks.append(to_host(cr_t).numpy())
                continue
            blot = to_host(blot_t).numpy()
            ok = to_host(ok_t).numpy()
            # local gradient of the blotted model (driz_cr's derivative
            # image): max abs difference to the 4 neighbours
            p = np.pad(blot, 1, mode="edge")
            deriv = np.maximum.reduce([
                np.abs(blot - p[:-2, 1:-1]), np.abs(blot - p[2:, 1:-1]),
                np.abs(blot - p[1:-1, :-2]), np.abs(blot - p[1:-1, 2:]),
            ])
            # residuals in RATE units; the noise from weight > 0 pixels
            # only (already-rejected / masked pixels must not feed it)
            resid = exposure_rate_data(exp) - blot
            sel = ok & (np.abs(resid) < np.inf)
            if exp.weight is not None:
                sel = sel & (exp.weight > 0)
            sig = float(np.std(resid[sel])) if sel.any() else 0.0
            if sel.any():  # robust sigma: the MAD around the median
                r = resid[sel]
                med_r = np.median(r)
                mad = np.median(np.abs(r - med_r)) * 1.4826
                sig = float(mad) if mad > 0 else sig
            cr = ok & (np.abs(resid) > snr * sig + scale * deriv)
            masks.append(cr)
            wht = (np.ones_like(exp.data) if exp.weight is None
                   else exp.weight.copy())
            wht[cr] = 0.0
            exp.weight = wht
        self.execute()  # re-drizzle with CRs removed
        return masks

    @property
    def output_wcs(self) -> TanWCS:
        self._ensure_output_grid()
        return self._owcs

    @property
    def output_shape(self) -> tuple[int, int]:
        self._ensure_output_grid()
        return self._oshape

    @property
    def texptime(self) -> float:
        """Total exposure time of the stack (AstroDrizzle's TEXPTIME)."""
        return float(sum(e.exptime for e in self.exposures))
