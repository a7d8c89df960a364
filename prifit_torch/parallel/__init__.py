"""Data and point-axis parallelism on ``torch.distributed`` (port of
``prifit_tpu/parallel``): meshes of ranks and batch sharding
(:mod:`.mesh`), collectives with stated transposes (:mod:`.collectives`)
and the point-sharded fit pipeline (:mod:`.point_sp`, imported on
demand as in the JAX package)."""

from prifit_torch.parallel.mesh import (
    batch_sharding,
    make_data_mesh,
    make_mesh,
    maybe_initialize_distributed,
    replicate,
    shard_batch,
)

__all__ = ["maybe_initialize_distributed", "make_mesh", "make_data_mesh",
           "shard_batch", "replicate", "batch_sharding"]
