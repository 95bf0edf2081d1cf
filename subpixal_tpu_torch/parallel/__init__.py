"""Multi-device alignment on ``torch.distributed``.

Counterpart of ``subpixal_tpu/parallel``: one process per device, a
process group where the JAX package has a device mesh, and
``all_reduce`` where it has ``lax.psum``. Two ways to shard:

* the frames and the cutout batch (:mod:`.sharding`):
  ``align_images(mesh=make_mesh(...))`` splits the re-drizzle's frames
  and the (frame, source) cutout batch over the ranks, and the global
  sigma-clipped fits sum their moments over the group;
* the mosaic's rows (:mod:`.spatial`): ``Drizzle(spatial_mesh=...)``
  keeps one row band of the reference plane a rank (``band_rows``,
  ``shard_rows``, ``gather_rows``, ``halo_exchange``), deposits into it
  (``drizzle_deposit_spatial``, ``drizzle_deposit_stack_spatial`` over a
  2-D ``make_mesh2d`` mesh, ``drizzle_deposit_sparse_spatial``) and blots
  from it (``sample_spatial``); ``align_images`` drives such a Drizzle
  with the measurement replicated on every rank.

:class:`~subpixal_tpu_torch.parallel.sharding.Mesh` (what ``make_mesh``
and ``make_mesh2d`` return) stands for ``jax.sharding.Mesh``, which the
JAX package does not export from here either.
"""

from .distributed import (
    global_batch_from_local,
    init_distributed,
    make_global_mesh,
    process_info,
    stage_global,
)
from .sharding import (
    Mesh,
    make_mesh,
    make_sharded_align_step,
    pad_to_multiple,
    sharded_find_displacement,
    sharded_measure_and_fit,
)
from .spatial import (
    band_rows,
    drizzle_deposit_sparse_spatial,
    drizzle_deposit_spatial,
    drizzle_deposit_stack_spatial,
    gather_rows,
    halo_exchange,
    make_mesh2d,
    sample_spatial,
    shard_rows,
)

__all__ = [
    "make_mesh",
    "make_sharded_align_step",
    "pad_to_multiple",
    "sharded_find_displacement",
    "sharded_measure_and_fit",
    "band_rows",
    "shard_rows",
    "gather_rows",
    "halo_exchange",
    "make_mesh2d",
    "drizzle_deposit_spatial",
    "drizzle_deposit_sparse_spatial",
    "drizzle_deposit_stack_spatial",
    "sample_spatial",
    "init_distributed",
    "make_global_mesh",
    "global_batch_from_local",
    "process_info",
    "stage_global",
]
