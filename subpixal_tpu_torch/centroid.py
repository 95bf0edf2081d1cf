"""Peak centroiding module (the reference's ``subpixal.centroid`` name).

Re-exports the batched subpixel peak fit of
:mod:`subpixal_tpu_torch.ops.peaks`.
"""

from .ops.peaks import PeakFitResult, find_peak  # noqa: F401

__all__ = ["PeakFitResult", "find_peak"]
