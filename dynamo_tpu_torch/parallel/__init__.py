"""Meshes and sharded steps of the port.  Only the sequence-parallel
axis is wired so far: `MeshConfig(sp=N)`, the `SpRing` of its ranks, and
`make_sp_prefill_step`."""

from dynamo_tpu_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    SpRing,
    default_sp_devices,
)
from dynamo_tpu_torch.parallel.sharding import (
    Capability,
    PlaneSpec,
    check_plane,
    make_sp_prefill_step,
    plane_capability,
)

__all__ = [
    "AXES", "Capability", "MeshConfig", "PlaneSpec", "SpRing", "check_plane",
    "default_sp_devices", "make_sp_prefill_step", "plane_capability",
]
