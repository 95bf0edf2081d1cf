"""Fixed-shape cutout extraction — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/cutouts.py · cutout_blc`` and
``extract_cutouts``: every cutout of a batch shares one static (h, w)
shape, is centered on its catalog position (round-half-up), and carries a
validity mask of the pixels that landed inside the image; out-of-image
cutouts are not an error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CutoutBatch", "cutout_blc", "extract_cutouts",
           "OVERLAP_NONE", "OVERLAP_PARTIAL", "OVERLAP_FULL"]

OVERLAP_NONE = 0
OVERLAP_PARTIAL = 1
OVERLAP_FULL = 2


class CutoutBatch(NamedTuple):
    """data (B, h, w) (fill outside the image), mask (B, h, w) bool, blc
    (B, 2) int32 (y, x) corners, overlap (B,) NONE/PARTIAL/FULL."""

    data: torch.Tensor
    mask: torch.Tensor
    blc: torch.Tensor
    overlap: torch.Tensor


def cutout_blc(centers: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(y, x) bottom-left corners that center each cutout on ``centers``
    ((B, 2) float (x, y)); floor(c + 0.5) is the reference's round-half-up."""
    h, w = shape
    bx = torch.floor(centers[:, 0] + 0.5).to(torch.int32) - (w // 2)
    by = torch.floor(centers[:, 1] + 0.5).to(torch.int32) - (h // 2)
    return torch.stack([by, bx], dim=1)


def extract_cutouts(image: torch.Tensor, centers: torch.Tensor,
                    shape: tuple[int, int],
                    fill_value: float = 0.0) -> CutoutBatch:
    """Gather (B, h, w) cutouts of ``image`` (H, W) centered on
    ``centers`` (B, 2) (x, y)."""
    h, w = shape
    H, W = image.shape
    dev = image.device
    blc = cutout_blc(centers.to(torch.float32), shape)
    yy = blc[:, 0, None, None].long() + torch.arange(h, device=dev)[None, :, None]
    xx = blc[:, 1, None, None].long() + torch.arange(w, device=dev)[None, None, :]
    mask = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    flat = image.reshape(-1)[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))]
    data = torch.where(mask, flat, torch.full_like(flat, fill_value))
    nvalid = mask.sum(dim=(1, 2))
    overlap = torch.where(
        nvalid == 0, OVERLAP_NONE,
        torch.where(nvalid == h * w, OVERLAP_FULL, OVERLAP_PARTIAL)
    ).to(torch.int32)
    return CutoutBatch(data=data, mask=mask, blc=blc, overlap=overlap)
