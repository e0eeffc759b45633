"""Slice topology: the part of `dynamo_tpu/fleet/topology.py` the KV
router and the planner read.

One `SliceSpec` describes a worker's devices the way the router needs to
weigh it: the (dp, pp, sp, ep, tp) degrees, the role, the KV mode, the
serving features, the memory of each device in bytes (so "free memory"
is a byte quantity, not a percentage that reads the same on a small card
and a large one) and the device-transfer fabric the worker is reachable
on (`cuda_ipc:<host boot id>:<GPU UUID>`, `local:<pid>`, or empty).
Workers publish it in their instance records; `DefaultWorkerSelector`
scales each candidate's decode load by its slice's memory against the
largest candidate's, and `pick_donor` orders remote-prefix donors by
`donor_preference_key`: reachable over the device fabric first, then
coverage, then free memory, then the stable id.

The planner checks `validate_placement` before it spawns a worker.  A
`--tp N` / `--dp N` worker publishes its degrees in `mesh` ("tp2",
"dp2xtp2"), each rank's share of the cards' memory as
`hbm_per_chip_bytes`, and, under `--dp-attention`, the `dp_attention`
feature (with `dp_local` where page locality is on), JAX's feature
names.  Not ported: the `--slice` parser and `place_role` (`--slice`'s
`packed` and `windowN` features need worker knobs the port lacks).
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

    def reachable(self, other: "SliceSpec") -> bool:
        """Can THIS slice pull the OTHER slice's KV over a device fabric?
        Only over the same fabric: one card of one host for cuda_ipc, one
        process for local.  Anything else rides the host-staged wire —
        still correct, only not device-direct (a weaker donor, never an
        invalid one)."""
        return bool(self.fabric) and self.fabric == other.fabric

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


def free_hbm_bytes(spec: Optional[SliceSpec], metrics=None) -> int:
    """Per-slice free device memory in bytes: the slice's total scaled by
    the worker's last published cache occupancy
    (ForwardPassMetrics.kv_stats.gpu_cache_usage_perc).  A spec without a
    memory figure reports 0: "unknown" sorts below any slice that
    advertised headroom."""
    if spec is None or spec.total_hbm_bytes <= 0:
        return 0
    used = 0.0
    kv = getattr(metrics, "kv_stats", None)
    if kv is not None:
        used = min(1.0, max(0.0, float(
            getattr(kv, "gpu_cache_usage_perc", 0.0) or 0.0)))
    return int(spec.total_hbm_bytes * (1.0 - used))


def stable_id_key(worker_id) -> tuple:
    """Total order over mixed int/str worker ids: ints numerically among
    themselves, strings lexically, the type tag between them, so replica
    routers agree on ties."""
    if isinstance(worker_id, bool) or not isinstance(worker_id, int):
        return (1, 0, str(worker_id))
    return (0, int(worker_id), "")


def donor_preference_key(worker_id, overlap_blocks: int, *,
                         reachable: bool = False,
                         free_hbm: int = 0) -> tuple:
    """Sort key for donor candidates, higher is better: device-fabric
    reachability, then prefix coverage, then free memory (a donor about
    to evict is a worse bet), then the stable id ASCENDING."""
    neg_id = tuple(-x if isinstance(x, int) else _neg_str(x)
                   for x in stable_id_key(worker_id))
    return (1 if reachable else 0, int(overlap_blocks), int(free_hbm),
            neg_id)


def _neg_str(s: str) -> tuple:
    """Lexicographic negation: an ascending-id preference inside max()."""
    return tuple(-ord(c) for c in s)


def validate_placement(role: str, spec: Optional[SliceSpec]) -> Tuple[bool, str]:
    """Is deploying `role` work onto `spec` topology-sane?  The planner
    consults this before spawning/scaling.  A worker without a published spec is accepted — the
    mixed-fleet rule again — but a spec that names a different dedicated
    role is a refusal, not a warning."""
    if role not in ROLES:
        return False, f"unknown role {role!r} (want one of {ROLES})"
    if spec is None:
        return True, "no SliceSpec published; placement unconstrained"
    if role in ("prefill", "decode") and spec.role in ("prefill", "decode") \
            and spec.role != role:
        return False, (
            f"role {role!r} cannot be placed on a dedicated "
            f"{spec.role!r} slice ({spec.describe()}); spawn a "
            f"{role} cell with its own mesh instead")
    if role == "both" and spec.role in ("prefill", "decode"):
        return False, (
            f"aggregated (both) serving cannot ride a dedicated "
            f"{spec.role!r} slice ({spec.describe()})")
    return True, "ok"
