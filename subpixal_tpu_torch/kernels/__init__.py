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

Each wrapper and every entry point that reaches one takes the JAX
package's ``use_pallas`` (:func:`use_pallas` says which side it takes):
``False`` runs the plain versions on any device, the counterpart of the
JAX package's XLA path; ``True`` off CUDA raises.
"""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "use_pallas"]

#: kernel name -> number of kernel launches since the last reset
LAUNCHES = {"drizzle_deposit": 0, "blot_gather": 0,
            "measure_displacement": 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_pallas(requested: bool | str = "auto", device=None) -> bool:
    """Whether a call takes the hand-written kernels.

    ``True`` and ``False`` force the choice; ``'auto'`` takes the kernels
    on a CUDA ``device`` (with no device given: when CUDA is available).
    ``True`` with a ``device`` that is not CUDA raises ``ValueError``:
    the kernels run on CUDA only, as the JAX package's Pallas kernels run
    on TPU only, and no call quietly takes the plain versions instead.
    """
    if requested in (True, False) and not isinstance(requested, str):
        if requested and device is not None \
                and torch.device(device).type != "cuda":
            raise ValueError(f"use_pallas=True needs a CUDA device, got "
                             f"{device} (use_pallas=False runs the plain "
                             "versions there)")
        return bool(requested)
    if requested != "auto":
        raise ValueError(f"use_pallas must be True, False or 'auto', got "
                         f"{requested!r}")
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def _launches(requested, device, who: str) -> bool:
    """Whether a wrapper launches its kernel on tensors on ``device``:
    on CUDA unless ``use_pallas`` is False. CPU tensors and ``False`` take
    the plain version; ``True`` off CUDA raises, and so does ``'auto'``
    on a device that is neither CUDA nor the CPU."""
    dev = torch.device(device)
    if use_pallas(requested, dev):
        return True
    if isinstance(requested, str) and dev.type != "cpu":
        raise ValueError(f"{who}: unsupported device {dev}")
    return False


from ._build import build  # noqa: E402
