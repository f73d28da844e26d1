from rfnet_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    maybe_initialize_distributed,
    shard_batch,
    torchrun_world,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "maybe_initialize_distributed",
    "shard_batch",
    "torchrun_world",
]
