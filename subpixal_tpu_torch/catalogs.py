"""Source catalogs on the host: detection, measurement, filtering.

Counterpart of ``subpixal_tpu/catalogs/__init__.py`` (its ``Table``,
sigma-clipped statistics, the multi-threshold deblender, ``find_sources``,
``ImageCatalog``, ``ImageSourceCatalog`` and the SExtractor wrappers
``SExCatalog`` and ``SExImageCatalog``), carried into the port as numpy
so that importing it never loads JAX. Labeling runs in the host C++
union-find of :mod:`subpixal_tpu_torch._native`.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ._native import component_stats, label_components

__all__ = [
    "Table",
    "ImageCatalog",
    "ImageSourceCatalog",
    "SExCatalog",
    "SExImageCatalog",
    "find_sources",
    "sigma_clipped_stats",
]


class Table:
    """Minimal ordered column table (numpy-backed).

    Supports: ``t['col']``, ``t['col'] = arr``, ``len(t)``, ``t[mask]``
    (row selection), ``t.colnames``, iteration over rows as dicts.
    """

    def __init__(self, data: dict[str, np.ndarray] | None = None):
        self._cols: dict[str, np.ndarray] = {}
        if data:
            for k, v in data.items():
                self[k] = v

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        # boolean mask or index array -> row-filtered copy
        out = Table()
        for k, v in self._cols.items():
            out._cols[k] = v[key]
        return out

    def __setitem__(self, key: str, value):
        arr = np.asarray(value)
        if self._cols:
            n = len(self)
            if arr.shape[0] != n:
                raise ValueError(
                    f"column {key!r} has length {arr.shape[0]}, expected {n}"
                )
        self._cols[key] = arr

    def __contains__(self, key: str) -> bool:
        return key in self._cols

    def __len__(self) -> int:
        if not self._cols:
            return 0
        return next(iter(self._cols.values())).shape[0]

    @property
    def colnames(self) -> list[str]:
        return list(self._cols)

    def __repr__(self):
        return f"Table(rows={len(self)}, cols={self.colnames})"


def sigma_clipped_stats(data: np.ndarray, sigma: float = 3.0,
                        maxiters: int = 5):
    """(mean, median, std) with iterative sigma clipping (host numpy)."""
    d = np.asarray(data, np.float64).ravel()
    d = d[np.isfinite(d)]
    for _ in range(maxiters):
        med = np.median(d)
        std = np.std(d)
        keep = np.abs(d - med) <= sigma * std
        if keep.all() or keep.sum() < 10:
            break
        d = d[keep]
    return float(np.mean(d)), float(np.median(d)), float(np.std(d))


def _deblend(img: np.ndarray, labels: np.ndarray, n: int,
             threshold: float, nthresh: int, mincont: float,
             connectivity: int) -> tuple[np.ndarray, int]:
    """Multi-threshold deblending of merged components.

    SExtractor-style semantics (DEBLEND_NTHRESH / DEBLEND_MINCONT): for
    each component, scan ``nthresh`` exponentially spaced thresholds
    between the detection threshold and the component peak; where the
    component splits into >=2 sub-components that each carry more than
    ``mincont`` of the total flux, those become separate objects, and
    every remaining component pixel is assigned to the nearest surviving
    seed's flux-weighted centroid. Returns a relabeled segmentation.
    """
    out = labels.astype(np.int32).copy()
    next_id = n + 1
    stats = component_stats(labels, img - np.float32(threshold), n)
    for comp in range(1, n + 1):
        peak = float(stats["peak"][comp - 1]) + threshold
        if peak <= threshold or stats["area"][comp - 1] < 4:
            continue
        y0 = int(stats["ymin"][comp - 1])
        y1 = int(stats["ymax"][comp - 1]) + 1
        x0 = int(stats["xmin"][comp - 1])
        x1 = int(stats["xmax"][comp - 1]) + 1
        sub = img[y0:y1, x0:x1]
        inside = out[y0:y1, x0:x1] == comp
        total = float(np.sum((sub - threshold)[inside]))
        if total <= 0:
            continue
        # cheap pre-check: a single local maximum can never deblend
        p = np.pad(sub, 1, constant_values=-np.inf)
        mx = sub
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    mx = np.maximum(
                        mx, p[1 + dy:p.shape[0] - 1 + dy,
                              1 + dx:p.shape[1] - 1 + dx])
        if np.count_nonzero((sub >= mx) & inside) <= 1:
            continue
        # exponential threshold ladder (skip level 0 = original).
        # SExtractor's ratio ladder needs threshold > 0; for zero/negative
        # detection thresholds (legal here: background-subtracted images)
        # use an exponentially spaced additive ladder over the same span.
        steps = np.arange(1, nthresh) / nthresh
        if threshold > 0:
            levels = threshold * np.power(peak / threshold, steps)
        else:
            frac = np.expm1(4.0 * steps) / np.expm1(4.0)
            levels = threshold + (peak - threshold) * frac
        best_seeds = None
        best_n = 1
        for lev in levels:
            det = inside & (sub > lev)
            if not det.any():
                break
            sl, ns = label_components(det, connectivity=connectivity)
            if ns < 2:
                continue
            st = component_stats(sl, sub - np.float32(threshold), ns)
            frac = st["flux"] / total
            good = frac > mincont
            # SExtractor keeps every branch that passes mincont at ANY
            # level: prefer the split with the MOST surviving children
            # (ties -> the higher level, whose seeds are tighter). Taking
            # simply the last level would merge away faint children that
            # drop below high levels.
            if good.sum() >= max(2, best_n):
                best_seeds = (st["cx"][good], st["cy"][good])
                best_n = int(good.sum())
        if best_seeds is None:
            continue
        sx, sy = best_seeds
        yy, xx = np.nonzero(inside)
        d2 = ((xx[:, None] - sx[None, :]) ** 2
              + (yy[:, None] - sy[None, :]) ** 2)
        owner = np.argmin(d2, axis=1)
        ids = np.concatenate([[comp],
                              np.arange(next_id, next_id + len(sx) - 1)])
        next_id += len(sx) - 1
        out[y0 + yy, x0 + xx] = ids[owner]
    return out, next_id - 1


def find_sources(
    image: np.ndarray,
    threshold: float | None = None,
    nsigma: float = 3.0,
    npixels: int = 5,
    connectivity: int = 8,
    mask: np.ndarray | None = None,
    deblend: bool = True,
    deblend_nthresh: int = 32,
    deblend_cont: float = 0.005,
) -> tuple[Table, np.ndarray]:
    """Detect sources: threshold -> label -> deblend -> measure.

    The SExtractor-replacement detection path (SURVEY §2a "JAX source
    finder: threshold + connected-component labeling + windowed
    centroid/flux"). Labeling runs in native C++; measurements come from
    single-pass native moments; merged neighbors are separated by
    SExtractor-style multi-threshold deblending (``deblend_nthresh`` /
    ``deblend_cont`` mirror DEBLEND_NTHRESH / DEBLEND_MINCONT).

    Returns (catalog Table, segmentation int32 image). Catalog columns:
    ``id`` (segment label), ``x``/``y`` (0-based flux-weighted centroids),
    ``flux``, ``area``, ``peak``, and the bbox ``xmin/xmax/ymin/ymax``.
    """
    img = np.asarray(image, np.float32)
    if threshold is None:
        _, med, std = sigma_clipped_stats(img)
        threshold = med + nsigma * std
    det = img > threshold
    if mask is not None:
        det &= ~np.asarray(mask, bool)
    labels, n = label_components(det, connectivity=connectivity)
    if deblend and n > 0:
        labels, n = _deblend(img, labels, n, float(threshold),
                             int(deblend_nthresh), float(deblend_cont),
                             connectivity)
    if n == 0:
        empty = Table({k: np.zeros(0) for k in
                       ("id", "x", "y", "flux", "area", "peak",
                        "xmin", "xmax", "ymin", "ymax")})
        return empty, labels
    # measure above-threshold flux moments (background-reduced image keeps
    # centroids robust, matching SExtractor's FLUX/X/Y_IMAGE behavior)
    stats = component_stats(labels, img - np.float32(threshold), n)
    keep = stats["area"] >= npixels
    ids = np.nonzero(keep)[0] + 1
    cat = Table({
        "id": ids.astype(np.int32),
        "x": stats["cx"][keep],
        "y": stats["cy"][keep],
        "flux": stats["flux"][keep],
        "area": stats["area"][keep].astype(np.int64),
        "peak": stats["peak"][keep],
        "xmin": stats["xmin"][keep],
        "xmax": stats["xmax"][keep],
        "ymin": stats["ymin"][keep],
        "ymax": stats["ymax"][keep],
    })
    # zero out rejected segments so the segmap matches the catalog
    if not keep.all():
        lut = np.zeros(n + 1, np.int32)
        lut[ids] = ids
        labels = lut[labels]
    return cat, labels


_OPS = {
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


class ImageCatalog:
    """Abstract source catalog with user filters.

    Parity: reference ``catalogs.ImageCatalog``-style ABC (SURVEY §2 #6):
    canonical 0-based ``x``/``y``/``flux`` columns, ``set_filters`` /
    ``append_filters`` with ``[('flux', '>', 100.0), ...]`` conditions,
    an ``execute()`` that (re)builds the raw catalog, and a ``catalog``
    property returning the filtered table.
    """

    #: columns every concrete catalog must provide
    required_colnames: tuple[str, ...] = ("x", "y", "flux")

    def __init__(self):
        self._rawcat: Table | None = None
        self._filters: list[tuple[str, str, float]] = []
        self.segmentation: np.ndarray | None = None

    # -- filters ------------------------------------------------------- #
    @property
    def filters(self) -> list[tuple[str, str, float]]:
        return list(self._filters)

    def set_filters(self, fcond) -> None:
        """Replace the filter list. Each condition is (colname, op, value)
        with op one of > >= < <= == !=."""
        self._filters = []
        self.append_filters(fcond)

    def append_filters(self, fcond) -> None:
        if fcond is None:
            return
        if isinstance(fcond, tuple) and len(fcond) == 3 \
                and isinstance(fcond[0], str):
            fcond = [fcond]
        for col, op, val in fcond:
            if op not in _OPS:
                raise ValueError(f"unsupported filter op: {op!r}")
            self._filters.append((str(col), op, val))

    # -- catalog access ------------------------------------------------ #
    def execute(self) -> None:
        """(Re)compute the raw catalog. Subclasses implement."""
        raise NotImplementedError

    @property
    def rawcat(self) -> Table:
        if self._rawcat is None:
            self.execute()
        assert self._rawcat is not None
        return self._rawcat

    @property
    def catalog(self) -> Table:
        """The filtered catalog (computed lazily)."""
        cat = self.rawcat
        if not self._filters:
            return cat
        keep = np.ones(len(cat), bool)
        for col, op, val in self._filters:
            keep &= _OPS[op](cat[col], val)
        return cat[keep]

    def __len__(self) -> int:
        return len(self.catalog)


class ImageSourceCatalog(ImageCatalog):
    """Catalog produced by the built-in host source finder. ``image`` is a
    2-D array or a FITS path (with an optional ``[ext]`` spec: the first
    HDU with data when none is given)."""

    def __init__(self, image, threshold: float | None = None,
                 nsigma: float = 3.0, npixels: int = 5,
                 connectivity: int = 8):
        super().__init__()
        self._image_spec = image
        self.threshold = threshold
        self.nsigma = nsigma
        self.npixels = npixels
        self.connectivity = connectivity

    def _load_image(self) -> np.ndarray:
        img = self._image_spec
        if isinstance(img, str):
            from .io.fits import read_fits
            from .utils import parse_file_name

            fname, ext = parse_file_name(img)
            hdul = read_fits(fname)
            if ext is None:
                for h in hdul:
                    if h.data is not None:
                        return np.asarray(h.data)
                raise ValueError(f"no image data in {fname}")
            return np.asarray(hdul[ext].data)
        return np.asarray(img)

    def execute(self) -> None:
        img = self._load_image()
        cat, seg = find_sources(
            img, threshold=self.threshold, nsigma=self.nsigma,
            npixels=self.npixels, connectivity=self.connectivity,
        )
        self._rawcat = cat
        self.segmentation = seg


class SExCatalog(ImageCatalog):
    """Wrap an existing SExtractor ASCII catalog (reference parity).

    Parses ``ASCII_HEAD``-style output (``# N NAME`` header lines). The
    1-based ``X_IMAGE``/``Y_IMAGE`` columns are converted to 0-based
    ``x``/``y``; ``FLUX_*`` maps to ``flux`` (reference behavior:
    1-based->0-based conversion, SURVEY §2 #6).
    """

    _FLUX_PREFERENCE = ("FLUX_AUTO", "FLUX_ISO", "FLUX_BEST", "FLUX_APER")

    def __init__(self, catalog_file: str, segmentation_file: str | None = None):
        super().__init__()
        self.catalog_file = catalog_file
        self.segmentation_file = segmentation_file

    def execute(self) -> None:
        names: list[str] = []
        rows: list[list[float]] = []
        with open(self.catalog_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    parts = line[1:].split()
                    if len(parts) >= 2 and parts[0].isdigit():
                        idx = int(parts[0])
                        while len(names) < idx:
                            names.append(f"col{len(names) + 1}")
                        names[idx - 1] = parts[1].upper()
                    continue
                rows.append([float(v) for v in line.split()])
        if not rows:
            self._rawcat = Table({"x": np.zeros(0), "y": np.zeros(0),
                                  "flux": np.zeros(0)})
            return
        arr = np.asarray(rows, np.float64)
        while len(names) < arr.shape[1]:
            names.append(f"col{len(names) + 1}")
        t = Table()
        for i, nm in enumerate(names[: arr.shape[1]]):
            t[nm] = arr[:, i]
        # canonical columns (0-based)
        if "X_IMAGE" in t:
            t["x"] = t["X_IMAGE"] - 1.0
            t["y"] = t["Y_IMAGE"] - 1.0
        for fc in self._FLUX_PREFERENCE:
            if fc in t:
                t["flux"] = t[fc]
                break
        if "NUMBER" in t:
            t["id"] = t["NUMBER"].astype(np.int32)
        self._rawcat = t
        if self.segmentation_file:
            from .io.fits import getdata

            self.segmentation = np.asarray(getdata(self.segmentation_file))


class SExImageCatalog(SExCatalog):
    """Run the SExtractor binary on an image (reference parity,
    ``subpixal/catalogs.py · SExImageCatalog`` — SURVEY §3.3).

    Only usable when a ``sex``/``sextractor`` binary is installed;
    :class:`ImageSourceCatalog` is the built-in default.
    """

    def __init__(self, image: str, sexconfig: str,
                 sextractor_cmd: str | None = None, workdir: str | None = None):
        self.image = image
        self.sexconfig = sexconfig
        self.sextractor_cmd = sextractor_cmd or self._find_sextractor()
        self.workdir = workdir or os.path.dirname(os.path.abspath(image)) or "."
        # absolute output paths: SExtractor runs with cwd=workdir, so a
        # relative workdir would double up in the subprocess's outputs
        cat_file = os.path.abspath(os.path.join(
            self.workdir, os.path.basename(image) + ".cat"))
        seg_file = os.path.abspath(os.path.join(
            self.workdir, os.path.basename(image) + "_seg.fits"))
        super().__init__(cat_file, seg_file)

    @staticmethod
    def _find_sextractor() -> str | None:
        for cmd in ("sex", "sextractor", "source-extractor"):
            if shutil.which(cmd):
                return cmd
        return None

    def execute(self) -> None:
        if self.sextractor_cmd is None:
            raise RuntimeError(
                "no SExtractor binary found on PATH; use "
                "ImageSourceCatalog (the built-in native finder) instead"
            )
        # absolute paths: the subprocess runs with cwd=workdir, so
        # caller-relative image/config paths would resolve wrongly there
        cmd = [
            self.sextractor_cmd, os.path.abspath(self.image),
            "-c", os.path.abspath(self.sexconfig),
            "-CATALOG_NAME", self.catalog_file,
            "-CHECKIMAGE_TYPE", "SEGMENTATION",
            "-CHECKIMAGE_NAME", self.segmentation_file,
        ]
        subprocess.run(cmd, check=True, capture_output=True,
                       cwd=self.workdir)
        super().execute()
