"""Multi-process plumbing on ``torch.distributed``.

Counterpart of ``subpixal_tpu/parallel/distributed.py``. The JAX package
starts jax's multi-process runtime, after which one SPMD program spans
every host's devices; here each process drives one device, and a
``torch.distributed`` process group joins them:

* :func:`init_distributed` — ``init_process_group`` from explicit
  arguments or the ``SUBPIXAL_TPU_*`` environment variables, a no-op for
  a single-process run;
* :func:`process_info` — this process's (rank, world size);
* :func:`make_global_mesh` — the mesh over every rank of the group;
* :func:`global_batch_from_local` — every rank's batch shard, gathered
  into the whole batch on every rank;
* :func:`stage_global` — this rank's contiguous block of a value that
  every rank holds whole.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "make_global_mesh",
           "global_batch_from_local", "process_info", "stage_global"]

AXIS = "cutouts"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, **kwargs) -> bool:
    """Join this process to the default ``torch.distributed`` group.

    Arguments are taken in this order: explicit arguments; the
    ``SUBPIXAL_TPU_COORDINATOR`` (``host:port`` of rank 0),
    ``SUBPIXAL_TPU_NUM_PROCESSES`` and ``SUBPIXAL_TPU_PROCESS_ID``
    environment variables; neither: a single-process run, which returns
    False and touches nothing. ``backend`` defaults to NCCL when a CUDA
    device is present and gloo otherwise (several ranks sharing one card
    must ask for gloo: NCCL refuses them). A failure to set the group up
    raises; there is no fallback to another backend or to one process.
    ``kwargs`` go to ``init_process_group`` (``timeout``, ...). Returns
    True when the group is (already) initialised.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("SUBPIXAL_TPU_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("SUBPIXAL_TPU_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("SUBPIXAL_TPU_PROCESS_ID")
        process_id = int(v) if v else None
    if coordinator_address is None and num_processes is None:
        return False  # single-process
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id (arguments or SUBPIXAL_TPU_* "
            f"variables); got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_global_mesh(n_devices: int | None = None, axis_name: str = AXIS,
                     device=None):
    """The mesh over every rank of the default group (one device each):
    :func:`~subpixal_tpu_torch.parallel.sharding.make_mesh`."""
    from .sharding import make_mesh

    return make_mesh(n_devices, axis_name=axis_name, device=device)


def global_batch_from_local(local_batch, mesh, axis_name: str = AXIS):
    """Every rank's LOCAL batch shard (``local_batch``, (B_local, ...),
    one shape on every rank), gathered in rank order into the whole
    (B_local · world size, ...) batch on every rank, on ``mesh.device``.

    Gloo's ``all_gather`` takes no CUDA tensors, so under gloo the gather
    runs on host copies."""
    t = torch.as_tensor(local_batch)
    if mesh.size == 1:
        return t.to(mesh.device)
    on = (torch.device("cpu") if dist.get_backend(mesh.group) == "gloo"
          else mesh.device)
    t = t.to(on).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def stage_global(value, mesh):
    """This rank's contiguous block of the leading axis of a value that
    every rank holds whole, on ``mesh.device`` (a view where the value is
    already there). The leading axis must divide by the mesh size (see
    :func:`~subpixal_tpu_torch.parallel.sharding.pad_to_multiple`)."""
    t = torch.as_tensor(value).to(mesh.device)
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"stage_global: {n} rows do not divide over "
                         f"{mesh.size} ranks (pad them first)")
    k = n // mesh.size
    return t[mesh.rank * k:(mesh.rank + 1) * k]
