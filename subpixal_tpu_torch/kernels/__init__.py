"""Hand-written CUDA kernels for Hopper (``sm_90a``) on the align path.

* :mod:`subpixal_tpu_torch.kernels.drizzle` — kernel B1, the drizzle
  deposit (replaces ``subpixal_tpu/kernels/drizzle.py ·
  drizzle_deposit_pallas``);
* :mod:`subpixal_tpu_torch.kernels.blot` — kernel B2, the blot gather
  (replaces ``subpixal_tpu/kernels/blot.py · sample_cutouts_pallas``);
* :mod:`subpixal_tpu_torch.kernels.measure` — kernel B3, the fused
  displacement measurement (replaces ``subpixal_tpu/kernels/measure.py ·
  measure_displacement_rank3``); its ``find_displacement`` (the one the
  package exports) runs it for ``usfac > 1`` with a window-confined
  coarse search.

Each wrapper takes the plain PyTorch version (in :mod:`..ops`) for
tensors on the CPU and launches its kernel for tensors on a CUDA device,
or raises: there is no fallback. Sources live in ``csrc/``; they are
built with nvcc on first CUDA use (:mod:`._build`). ``LAUNCHES`` counts
each wrapper's kernel launches, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "reset_launch_counts", "build"]

#: kernel name -> number of kernel launches since the last reset
LAUNCHES = {"drizzle_deposit": 0, "blot_gather": 0,
            "measure_displacement": 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


from ._build import build  # noqa: E402
