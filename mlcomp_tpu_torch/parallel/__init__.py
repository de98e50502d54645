"""Parallelism of the port: the mesh, state sharding, the multi-process
runtime, ring and Ulysses sequence parallelism and the pipeline (the
counterpart of mlcomp_tpu/parallel/, on ``torch.distributed``)."""

from mlcomp_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
    batch_sharding,
    replicated,
)
from mlcomp_tpu_torch.parallel.distributed import (
    BoundaryChannel,
    ChannelClosed,
    init_distributed,
    make_hybrid_mesh,
    global_batch_from_host,
    sync_hosts,
)

__all__ = [
    "MeshSpec",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "BoundaryChannel",
    "ChannelClosed",
    "init_distributed",
    "make_hybrid_mesh",
    "global_batch_from_host",
    "sync_hosts",
]
