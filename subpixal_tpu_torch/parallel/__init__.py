"""Multi-device alignment on ``torch.distributed``.

Counterpart of ``subpixal_tpu/parallel`` without its spatial part: one
process per device, a process group where the JAX package has a device
mesh, and ``all_reduce`` where it has ``lax.psum``. The cutout batch is
split over the ranks, and the global sigma-clipped fits sum their
moments over the group. ``align_images(mesh=make_mesh(...))`` runs the
whole align iteration so. The spatial mosaics (``band_rows``,
``shard_rows``, ``gather_rows``, ``halo_exchange``, ``make_mesh2d``, the
``drizzle_deposit_*spatial`` deposits and ``sample_spatial``) are not
ported yet (ROADMAP A16).
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

__all__ = [
    "Mesh",
    "make_mesh",
    "make_sharded_align_step",
    "pad_to_multiple",
    "sharded_find_displacement",
    "sharded_measure_and_fit",
    "init_distributed",
    "make_global_mesh",
    "global_batch_from_local",
    "process_info",
    "stage_global",
]
