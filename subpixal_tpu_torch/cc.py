"""Cross-correlation module (the reference's ``subpixal.cc`` name).

Re-exports the displacement measurement: ``find_displacement`` is the
package's (kernel B3 for ``usfac > 1`` under a small search box on CUDA
tensors), ``cross_correlate`` and ``Displacement`` the plain ones of
:mod:`subpixal_tpu_torch.ops.correlate`.
"""

from .kernels.measure import find_displacement  # noqa: F401
from .ops.correlate import Displacement, cross_correlate  # noqa: F401

__all__ = ["Displacement", "cross_correlate", "find_displacement"]
