"""Fixed-shape cutout extraction and insertion — plain PyTorch.

Counterpart of ``subpixal_tpu/ops/cutouts.py``: every cutout of a batch
shares one static (h, w) shape, is centered on its catalog position
(round-half-up), and carries a validity mask of the pixels that landed
inside the image; out-of-image cutouts are not an error.
:func:`insert_cutouts` scatters a batch back into an image plane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CutoutBatch", "cutout_blc", "extract_cutouts", "insert_cutouts",
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


def _pixel_coords(blc: torch.Tensor, shape, bounds):
    """Per-cutout absolute pixel grids (int64) and their in-image validity
    (shared by extract and insert so their bounds cannot diverge)."""
    h, w = shape
    H, W = bounds
    dev = blc.device
    yy = blc[:, 0, None, None].long() + torch.arange(h, device=dev)[None, :, None]
    xx = blc[:, 1, None, None].long() + torch.arange(w, device=dev)[None, None, :]
    return yy, xx, (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)


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
    blc = cutout_blc(centers.to(torch.float32), shape)
    yy, xx, mask = _pixel_coords(blc, shape, (H, W))
    flat = image.reshape(-1)[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))]
    data = torch.where(mask, flat, torch.full_like(flat, fill_value))
    nvalid = mask.sum(dim=(1, 2))
    overlap = torch.where(
        nvalid == 0, OVERLAP_NONE,
        torch.where(nvalid == h * w, OVERLAP_FULL, OVERLAP_PARTIAL)
    ).to(torch.int32)
    return CutoutBatch(data=data, mask=mask, blc=blc, overlap=overlap)


def insert_cutouts(image: torch.Tensor, data: torch.Tensor, blc: torch.Tensor,
                   mask: torch.Tensor | None = None,
                   mode: str = "set") -> torch.Tensor:
    """Insert (scatter) a batch of cutouts ``data`` (B, h, w) with (y, x)
    corners ``blc`` (B, 2) into a copy of ``image`` (H, W).

    ``mode='set'`` overwrites, the last cutout of the batch winning where
    cutouts overlap (serial insertion order); ``mode='add'`` accumulates.
    Out-of-image pixels, and pixels where ``mask`` is False, are dropped.
    """
    if mode not in ("set", "add"):
        raise ValueError(f"unknown mode: {mode!r} (expected 'set'|'add')")
    H, W = image.shape
    B, h, w = data.shape
    yy, xx, valid = _pixel_coords(blc, (h, w), (H, W))
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    # flat scatter with a trash slot for the dropped pixels
    flat_idx = torch.where(valid, yy * W + xx, H * W)
    vals = data.to(image.dtype)
    buf = torch.cat([image.reshape(-1),
                     torch.zeros(1, dtype=image.dtype, device=image.device)])
    if mode == "add":
        vals = torch.where(valid, vals, torch.zeros_like(vals))
        buf.index_add_(0, flat_idx.reshape(-1), vals.reshape(-1))
    else:
        # one scatter per cutout, in batch order: a single index_put_ with
        # duplicate indices has no defined order, so overlaps would not
        # keep the documented last-write-wins (within one cutout only the
        # trash slot repeats)
        for b in range(B):
            buf[flat_idx[b].reshape(-1)] = vals[b].reshape(-1)
    return buf[:-1].reshape(H, W)
