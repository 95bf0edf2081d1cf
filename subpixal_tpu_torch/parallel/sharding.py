"""A mesh of ``torch.distributed`` ranks and the sharded measurement/fit.

Counterpart of ``subpixal_tpu/parallel/sharding.py``. Where the JAX
package runs one SPMD program under ``shard_map`` over a device mesh, the
port runs one process per device: :class:`Mesh` holds the process group,
this process's rank and device, and every function here is called by
every rank with the same (whole) arguments. Each rank takes its
contiguous block of the batch, measures it on its own device (kernels B2
and B3 on CUDA, their plain versions on the CPU), and the fit's moment
sums are ``all_reduce``-d over the group, so every rank solves the same
global fit. Results that the JAX package returns sharded are gathered
back whole on every rank.

Only ``all_reduce`` and ``broadcast`` are used on device tensors: gloo
(the backend of several ranks sharing one card, and of CPU ranks) takes
CUDA tensors for those two, not for ``all_gather``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..blot import blot_measure
from ..kernels.measure import find_displacement
from ..ops.correlate import Displacement
from ..ops.fit import (LinearFitResult, iter_linear_fit_frames,
                       iter_linear_fit_sharded)
from .distributed import AXIS, stage_global

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_to_multiple",
    "sharded_find_displacement",
    "sharded_measure_and_fit",
    "make_sharded_align_step",
]


class Mesh:
    """A 1-D mesh: the ranks of a ``torch.distributed`` process group, one
    device each. ``rank`` and ``device`` are this process's. ``devices``
    (one entry per rank) and ``shape`` (axis name -> size) are the views
    of a ``jax.sharding.Mesh`` that the JAX code reads."""

    def __init__(self, group, rank: int, size: int, device,
                 axis_names=(AXIS,)):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.size}

    def __repr__(self):
        return (f"Mesh({self.axis_names[0]}={self.size}, rank={self.rank}, "
                f"device={self.device})")


def _default_device():
    """cuda:LOCAL_RANK (or the rank modulo the card count) when a CUDA
    device is present, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    idx = (int(local) if local is not None
           else dist.get_rank() % torch.cuda.device_count()
           if dist.is_initialized() else 0)
    return torch.device("cuda", idx)


def make_mesh(n_devices: int | None = None, axis_name: str = AXIS,
              device=None) -> Mesh:
    """The 1-D mesh over the default process group.

    Once :func:`~subpixal_tpu_torch.parallel.init_distributed` (or any
    ``init_process_group``) has run, that is every rank of the group, and
    ``n_devices``, when given, must equal its size. In a lone process,
    ``make_mesh()`` / ``make_mesh(1)`` first builds a one-rank group on an
    in-memory ``HashStore`` (no network): NCCL for a CUDA device, gloo
    for the CPU. ``device`` is this rank's device: cuda:LOCAL_RANK by
    default when a CUDA device is present, else the CPU; a CUDA device
    becomes the process's current device.
    """
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # NCCL's communicators and broadcast_object_list work on the
        # current device: make it this rank's
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) in a lone process: start one "
                "process per rank and call init_distributed first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    if dev.type != "cuda" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL group takes CUDA tensors only; pass a "
                         f"CUDA device, not {dev}")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, dev, (axis_name,))


def pad_to_multiple(arr, multiple: int, axis: int = 0,
                    fill=0) -> tuple[torch.Tensor, int]:
    """Pad ``axis`` up to a multiple of ``multiple`` with ``fill``
    (returns the padded tensor, the input itself when nothing is padded,
    and the pad count). Padded entries must be masked out by the caller
    (weight 0 / mask False)."""
    arr = torch.as_tensor(arr)
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, 0
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                      device=arr.device)], axis), pad


def _gather_blocks(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (k, ...) block in rank order, as one (k · size, ...)
    tensor on every rank: an ``all_reduce`` (SUM) of zero-filled copies,
    each rank's block in its own rows (x + 0 = x, so the sum is exact)."""
    if mesh.size == 1:
        return local
    k = local.shape[0]
    dt = torch.int32 if local.dtype == torch.bool else local.dtype
    full = torch.zeros((k * mesh.size,) + tuple(local.shape[1:]), dtype=dt,
                       device=local.device)
    full[mesh.rank * k:(mesh.rank + 1) * k] = local.to(dt)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
    return full.to(local.dtype)


def _shard(a, mesh: Mesh, fill=0):
    """This rank's block of ``a`` padded to a multiple of the mesh size."""
    return stage_global(pad_to_multiple(a, mesh.size, fill=fill)[0], mesh)


def sharded_find_displacement(ref, img, mesh: Mesh | None = None,
                              ref_mask=None, img_mask=None,
                              **kw) -> Displacement:
    """Batched displacement measurement split over the mesh's ranks.

    Every rank passes the whole (B, H, W) batch and gets the whole
    result: each measures its block of the batch (padded to the mesh
    size) with the routed
    :func:`~subpixal_tpu_torch.kernels.measure.find_displacement` (kernel
    B3 on CUDA for ``usfac > 1``), and the blocks are gathered back. A
    mask given as None is all ones, as in the JAX package.
    """
    if mesh is None:
        mesh = make_mesh()
    B = ref.shape[0]
    ref_l = _shard(ref, mesh)
    img_l = _shard(img, mesh)
    masks = [torch.ones(ref_l.shape, dtype=torch.float32, device=mesh.device)
             if m is None else _shard(torch.as_tensor(m).to(torch.float32),
                                      mesh)
             for m in (ref_mask, img_mask)]
    d = find_displacement(ref_l.contiguous(), img_l.contiguous(),
                          ref_mask=masks[0], img_mask=masks[1], **kw)
    return Displacement(*(_gather_blocks(v, mesh)[:B] for v in d))


def sharded_measure_and_fit(
    blotted, img, mask, xy, weights, mesh: Mesh | None = None, jac=None,
    cc_type: str = "NCC", usfac: int = 1, peak_fit_box: int = 5,
    fit_type: str = "quadratic", fitgeom: str = "general", nclip: int = 3,
    sigma: float = 3.0, peak_search_box="fitbox",
) -> tuple[Displacement, LinearFitResult]:
    """One sharded alignment measurement for one exposure (or jointly for
    a stack flattened over (exposure, source)).

    ``blotted``/``img``/``mask`` (B, h, w) cutout pairs, ``xy`` (B, 2)
    reference-frame positions, ``weights`` (B,) (0 = padded/invalid),
    ``jac`` optional (B, 2, 2) exposure->ref Jacobians applied to the
    measured displacements. Every rank passes the whole batch; each
    measures its block and the sigma-clipped fit of the measured
    positions against ``xy`` reduces its moments over the group, so every
    rank returns the same global fit (and the whole batch's displacements
    and final weights).
    """
    if mesh is None:
        mesh = make_mesh()
    B = img.shape[0]
    if jac is None:
        jac = torch.eye(2, dtype=torch.float32).expand(B, 2, 2)
    bl, im, mk, pos, wgt, J = (
        _shard(torch.as_tensor(a).to(torch.float32), mesh)
        for a in (blotted, img, mask, xy, weights, jac))
    d = find_displacement(
        bl.contiguous(), im.contiguous(), cc_type=cc_type, usfac=usfac,
        peak_fit_box=peak_fit_box, fit_type=fit_type, ref_mask=mk,
        img_mask=mk, peak_search_box=peak_search_box)
    dxy = torch.stack([d.dx, d.dy], dim=-1)
    uv = pos + torch.einsum("nik,nk->ni", J, dxy)
    w_eff = wgt * (d.fit_ok & (d.peak > 0)).to(torch.float32)
    fit = iter_linear_fit_sharded(uv, pos, w_eff, group=mesh.group,
                                  fitgeom=fitgeom, nclip=nclip, sigma=sigma)
    d = Displacement(*(_gather_blocks(v, mesh)[:B] for v in d))
    return d, LinearFitResult(*fit[:-1], _gather_blocks(fit.weights, mesh)[:B])


def make_sharded_align_step(
    mesh: Mesh, n_frames: int, cc_type: str = "NCC", usfac: int = 1,
    peak_fit_box: int = 5, fit_type: str = "quadratic",
    fitgeom: str = "general", nclip: int = 3, sigma: float = 3.0,
    peak_search_box="fitbox", interp: str = "poly5",
):
    """The multi-device align iteration over a flattened (frame, source)
    cutout batch.

    Returned callable::

        step(Ms, ts, drz, cut_px, cut_py, img, msk, xy0, jac, w, frame_id)
            -> (Ms', ts', LinearFitResult)

    Ms (E, 2, 2), ts (E, 2) and the reference plane ``drz`` (H, W) are
    whole on every rank; every (B, ...) input is the whole batch, of
    which each rank takes its block (B must divide by the mesh size: pad
    with :func:`pad_to_multiple` and zero weights). Each rank blots its
    block from ``drz`` (kernel B2 on CUDA, the plain ``sample_image`` on
    the CPU), measures it (kernel B3 on CUDA for ``usfac > 1``), and the
    per-frame fits reduce their moments over the group, so every rank
    composes the same affine update. The result's ``weights`` are
    gathered whole.
    """
    E = int(n_frames)

    def step(Ms, ts, drz, cut_px, cut_py, img, msk, xy0, jac, w, frame_id):
        B = cut_px.shape[0]
        if B % mesh.size:
            raise ValueError(f"{B} cutouts do not divide over {mesh.size} "
                             "ranks (pad them with zero weights)")
        px, py, im, mk, pos, J, wl, fid = (
            stage_global(a, mesh)
            for a in (cut_px, cut_py, img, msk, xy0, jac, w, frame_id))
        fid = fid.long()
        Mi = Ms[fid]
        d, _ = blot_measure(
            drz, Mi, ts[fid], px, py, im, mk.to(torch.bool), interp=interp,
            cc_type=cc_type, usfac=usfac, peak_fit_box=peak_fit_box,
            fit_type=fit_type, peak_search_box=peak_search_box)
        dxy = torch.stack([d.dx, d.dy], dim=-1)
        uv = pos + torch.einsum("nij,njk,nk->ni", Mi, J, dxy)
        w_eff = wl * (d.fit_ok & (d.peak > 0)).to(torch.float32)
        fit = iter_linear_fit_frames(uv, pos, fid, E, wxy=w_eff,
                                     fitgeom=fitgeom, nclip=nclip,
                                     sigma=sigma, group=mesh.group)
        newM = torch.einsum("eij,ejk->eik", fit.matrix, Ms)
        newt = torch.einsum("eij,ej->ei", fit.matrix, ts) + fit.shift
        return newM, newt, LinearFitResult(
            *fit[:-1], _gather_blocks(fit.weights, mesh))

    return step
