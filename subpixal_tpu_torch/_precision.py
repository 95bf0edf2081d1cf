"""Full float32 for the port's matrix products on CUDA.

The JAX reference pins its fits and DFT contractions to full f32
(``Precision.HIGHEST``: ``subpixal_tpu/align.py``, ``ops/fit.py``,
``ops/correlate.py``). On an NVIDIA card PyTorch may run float32
products in TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is on. :func:`full_f32` turns both
off for the duration of a call and restores the caller's settings after;
``align_images``, ``find_displacement``, ``cross_correlate`` and
``iter_linear_fit`` run under it; :func:`matmul_precision` keys the
programs ``aot.get_executable`` captures.
"""

from __future__ import annotations

import contextlib

import torch


def matmul_precision() -> tuple:
    """What decides the precision of float32 products here: TF32 on or
    off for matmuls and for cuDNN, and the float32 matmul precision."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@contextlib.contextmanager
def full_f32():
    """Context manager (and decorator) that disables TF32 inside it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
