"""Slice topology: the part of `dynamo_tpu/fleet/topology.py` the KV
router reads.

One `SliceSpec` describes a worker's devices the way the router needs to
weigh it: the (dp, pp, sp, ep, tp) degrees, the role, the KV mode, the
serving features and the memory of each device in bytes, so "free
memory" is a byte quantity, not a percentage that reads the same on a
small card and a large one.  Workers publish it in their instance
records; `DefaultWorkerSelector` scales each candidate's decode load by
its slice's memory against the largest candidate's.

Not ported: the fabric reachability, free-memory estimate and donor
preference of the fleet-wide prefix reuse (they go with the KV transfer
plane), the `--slice` parser, and the planner's placement rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

AXES = ("dp", "pp", "sp", "ep", "tp")

ROLES = ("prefill", "decode", "both", "encode")


@dataclass(frozen=True)
class SliceSpec:
    """Declarative description of one worker's slice; the instance-record
    schema the router weighs."""

    mesh: Tuple[int, int, int, int, int] = (1, 1, 1, 1, 1)
    role: str = "both"
    kv_quant: str = "none"
    features: Tuple[str, ...] = ()
    hbm_per_chip_bytes: int = 0
    fabric: str = ""

    def __post_init__(self):
        if len(self.mesh) != len(AXES):
            raise ValueError(
                f"SliceSpec.mesh must carry {len(AXES)} degrees "
                f"{AXES}, got {self.mesh!r}")
        if self.role not in ROLES:
            raise ValueError(
                f"SliceSpec.role must be one of {ROLES}, got {self.role!r}")

    @property
    def chips(self) -> int:
        n = 1
        for d in self.mesh:
            n *= int(d)
        return n

    @property
    def total_hbm_bytes(self) -> int:
        return self.chips * int(self.hbm_per_chip_bytes)

    def describe(self) -> str:
        """Compact mesh descriptor: "sp2xtp2", "tp4", or "single"."""
        parts = [f"{a}{n}" for a, n in zip(AXES, self.mesh) if int(n) > 1]
        return "x".join(parts) or "single"

    def to_dict(self) -> dict:
        return {
            "mesh": [int(d) for d in self.mesh],
            "role": self.role,
            "kv_quant": self.kv_quant,
            "features": list(self.features),
            "hbm_per_chip_bytes": int(self.hbm_per_chip_bytes),
            "fabric": self.fabric,
        }

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> Optional["SliceSpec"]:
        """Tolerant decode: an instance record with no slice published, or
        a version-skewed one, yields None / defaults — the router must
        keep routing a mixed fleet, never fail it over topology
        metadata."""
        if not isinstance(d, Mapping):
            return None
        try:
            mesh = tuple(int(x) for x in d.get("mesh", (1,) * len(AXES)))
            if len(mesh) != len(AXES):
                return None
            role = str(d.get("role", "both"))
            return SliceSpec(
                mesh=mesh,
                role=role if role in ROLES else "both",
                kv_quant=str(d.get("kv_quant", "none")),
                features=tuple(str(f) for f in d.get("features", ())),
                hbm_per_chip_bytes=int(d.get("hbm_per_chip_bytes", 0)),
                fabric=str(d.get("fabric", "")),
            )
        except (TypeError, ValueError):
            return None

