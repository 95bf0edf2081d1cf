"""subpixal_tpu_torch — the PyTorch/CUDA port of ``subpixal_tpu``.

Catalog-driven iterative subpixel alignment of dithered exposures on one
NVIDIA GPU: drizzle -> find sources -> blot each source's cutout ->
normalized cross-correlation -> peak fit -> sigma-clipped linear WCS fit,
repeated until it converges. The JAX package ``subpixal_tpu`` stays
beside it as the reference; this package imports ``torch``, ``numpy``
and ``scipy``, and never ``jax`` or ``subpixal_tpu``.

Module map (JAX package -> here):
  align                  -> align         (align_images, batch mode)
  ops/*                  -> ops/*         (plain PyTorch)
  kernels/drizzle, blot  -> kernels/*     (hand-written CUDA, csrc/*.cu)
  resample, blot, cutout -> resample, blot, cutout
  catalogs, wcs/wcs      -> catalogs, wcs (host numpy, carried over)
"""

from .align import AlignConfig, AlignResult, ImageAlignInfo, align_images
from .catalogs import ImageCatalog, ImageSourceCatalog, Table, find_sources
from .convert import exposures_from_reference
from .cutout import Cutout, create_primary_cutouts
from .ops.correlate import Displacement, cross_correlate, find_displacement
from .ops.fit import LinearFitResult, apply_affine, iter_linear_fit
from .ops.peaks import PeakFitResult, find_peak
from .resample import Drizzle, Exposure, make_output_wcs
from .wcs import DistGrid, TanWCS, apply_tangent_affine

__all__ = [
    "align_images", "AlignConfig", "AlignResult", "ImageAlignInfo",
    "ImageCatalog", "ImageSourceCatalog", "Table", "find_sources",
    "exposures_from_reference", "Cutout", "create_primary_cutouts",
    "Displacement", "cross_correlate", "find_displacement",
    "LinearFitResult", "apply_affine", "iter_linear_fit",
    "PeakFitResult", "find_peak",
    "Drizzle", "Exposure", "make_output_wcs",
    "DistGrid", "TanWCS", "apply_tangent_affine",
]
