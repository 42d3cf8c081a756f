from quber_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    put_batch,
    put_batch_local_shard,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "initialize_multihost",
    "make_mesh",
    "make_mesh_2d",
    "put_batch",
    "put_batch_local_shard",
    "replicate",
    "shard_batch",
]
