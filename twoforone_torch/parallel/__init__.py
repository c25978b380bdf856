from twoforone_torch.parallel.mesh import (  # noqa: F401
    get_mesh,
    shard_batch,
    replicate,
)
