"""Meshes and sharded steps of the port: `MeshConfig(sp=N)` with the
`SpRing` of its ranks and `make_sp_prefill_step`, `MeshConfig(dp=N,
ep=K, tp=M)` with the `DpGrid` of its ranks (tp alone: one dp row, whose
collectives are a `TpGroup`'s; an ep axis's an `EpGroup`'s),
`MeshConfig(pp=S)` with the `PpStages` of its stages (parallel/
pipeline.py), the sharding rules, `resolve_moe_mode` and
`shard_state`."""

from dynamo_tpu_torch.parallel.mesh import (
    AXES,
    DpGrid,
    EpGroup,
    MeshConfig,
    PpStages,
    SpRing,
    TpGroup,
    default_rank_devices,
)
from dynamo_tpu_torch.parallel.sharding import (
    Capability,
    PlaneSpec,
    cache_pspecs,
    check_plane,
    data_pspecs,
    make_sp_prefill_step,
    param_pspecs,
    plane_capability,
    resolve_moe_mode,
    shard_state,
    validate,
)

__all__ = [
    "AXES", "Capability", "DpGrid", "EpGroup", "MeshConfig", "PlaneSpec",
    "PpStages", "SpRing", "TpGroup", "cache_pspecs", "check_plane", "data_pspecs",
    "default_rank_devices",
    "make_sp_prefill_step", "param_pspecs", "plane_capability",
    "resolve_moe_mode", "shard_state", "validate",
]
