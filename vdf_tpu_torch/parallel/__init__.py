from .mesh import (
    LANES_AXIS,
    SHARD_AXIS,
    Mesh,
    lane_sharding,
    make_mesh,
    shard_state,
    sharded_check,
    sharded_eval,
    sharded_matvec,
    sharded_msm,
)

__all__ = [
    "LANES_AXIS",
    "SHARD_AXIS",
    "Mesh",
    "lane_sharding",
    "make_mesh",
    "shard_state",
    "sharded_check",
    "sharded_eval",
    "sharded_matvec",
    "sharded_msm",
]
