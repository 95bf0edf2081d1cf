"""subpixal_tpu_torch — the PyTorch/CUDA port of ``subpixal_tpu``.

Catalog-driven iterative subpixel alignment of dithered exposures on one
NVIDIA GPU: drizzle -> find sources -> blot each source's cutout ->
normalized cross-correlation -> peak fit -> sigma-clipped linear WCS fit,
repeated until it converges. The JAX package ``subpixal_tpu`` stays
beside it as the reference; this package imports ``torch``, ``numpy``
and ``scipy``, and never ``jax`` or ``subpixal_tpu``.

Module map (JAX package -> here):
  align                  -> align         (align_images: batch and otf,
                                           device and host loop, the
                                           AstroDrizzle stages)
  pipeline               -> pipeline      (load_exposures, align_fits,
                                           AlignState)
  catalogs/device        -> catalogs_device (the device source finder,
                                           plain PyTorch)
  ops/*                  -> ops/*         (plain PyTorch)
  kernels/drizzle, blot,
  measure                -> kernels/*     (hand-written CUDA, csrc/*.cu)
  resample, blot, cutout -> resample, blot, cutout
  cc, centroid           -> cc, centroid  (re-exports)
  catalogs, wcs/wcs,
  wcs/fitswcs, io/fits,
  utils                  -> catalogs, wcs, fitswcs, io/fits, utils
                                          (host numpy, carried over)
  parallel/distributed,
  parallel/sharding      -> parallel      (torch.distributed process
                                           groups; align_images(mesh=))
"""

from .version import __version__

from .align import AlignConfig, AlignResult, ImageAlignInfo, align_images
from .blot import blot_cutout, blot_image, compute_pixmap
from .catalogs import (ImageCatalog, ImageSourceCatalog, SExCatalog,
                       SExImageCatalog, Table, find_sources)
from .convert import exposures_from_reference
from .cutout import (Cutout, NoOverlapError, PartialOverlapError,
                     create_cutouts, create_input_image_cutouts,
                     create_primary_cutouts, cutouts_to_batch,
                     drz_from_input_cutouts)
from .kernels.measure import find_displacement
from .ops.correlate import Displacement, cross_correlate
from .ops.cutouts import CutoutBatch, extract_cutouts, insert_cutouts
from .ops.fit import (LinearFitResult, apply_affine, iter_linear_fit,
                      iter_linear_fit_frames, iter_linear_fit_sharded)
from .ops.peaks import PeakFitResult, find_peak
from .fitswcs import wcs_from_hdul, wcs_from_header, wcs_to_header
from .resample import Drizzle, Exposure, Resample, make_output_wcs
from .utils import parse_file_name
from .wcs import DistGrid, TanWCS, apply_tangent_affine

__all__ = [
    "__version__",
    # measurement
    "find_peak", "PeakFitResult",
    "cross_correlate", "find_displacement", "Displacement",
    # fitting
    "iter_linear_fit", "iter_linear_fit_frames", "iter_linear_fit_sharded",
    "LinearFitResult", "apply_affine",
    # cutouts
    "extract_cutouts", "insert_cutouts", "CutoutBatch",
    "Cutout", "NoOverlapError", "PartialOverlapError",
    "create_primary_cutouts", "create_input_image_cutouts",
    "create_cutouts", "drz_from_input_cutouts", "cutouts_to_batch",
    # blot / resample
    "blot_cutout", "blot_image", "compute_pixmap",
    "Resample", "Drizzle", "Exposure", "make_output_wcs",
    # catalogs
    "ImageCatalog", "ImageSourceCatalog", "SExCatalog", "SExImageCatalog",
    "Table", "find_sources",
    # wcs
    "TanWCS", "DistGrid", "apply_tangent_affine", "wcs_from_header",
    "wcs_to_header", "wcs_from_hdul",
    # align
    "align_images", "AlignConfig", "AlignResult", "ImageAlignInfo",
    # utils
    "parse_file_name",
    # the port's own
    "exposures_from_reference",
]
