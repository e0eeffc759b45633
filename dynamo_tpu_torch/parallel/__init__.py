"""Meshes and sharded steps of the port: `MeshConfig(sp=N)` with the
`SpRing` of its ranks and `make_sp_prefill_step`, and `MeshConfig(tp=N)`
with the `TpGroup` of its ranks, the tp sharding rules and
`shard_state`."""

from dynamo_tpu_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    SpRing,
    TpGroup,
    default_rank_devices,
)
from dynamo_tpu_torch.parallel.sharding import (
    Capability,
    PlaneSpec,
    cache_pspecs,
    check_plane,
    make_sp_prefill_step,
    param_pspecs,
    plane_capability,
    shard_state,
    validate,
)

__all__ = [
    "AXES", "Capability", "MeshConfig", "PlaneSpec", "SpRing",
    "TpGroup", "cache_pspecs", "check_plane", "default_rank_devices",
    "make_sp_prefill_step", "param_pspecs", "plane_capability",
    "shard_state", "validate",
]
