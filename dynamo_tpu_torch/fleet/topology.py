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
`--tp N` / `--dp N` / `--sp N` worker publishes its degrees in `mesh`
("tp2", "dp2xtp2", "sp2xtp2"), each rank's share of the cards' memory as
`hbm_per_chip_bytes`, and, under `--dp-attention`, the `dp_attention`
feature (with `dp_local` where page locality is on), JAX's feature
names.

`parse_slice` is JAX's grammar of the worker's declarative `--slice`
string, its `SliceSpec` equal to JAX's (`to_dict()`).  The port always
packs its prefill, so `packed` / `packed_prefill` names what it does
anyway, and its decode window is fixed at `DECODE_WINDOW` (8): `window8`
is accepted and any other `windowN` raises, naming ROADMAP.md A2, where
the worker's window knob comes with the captured windows.  Not ported:
`place_role`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

AXES = ("dp", "pp", "sp", "ep", "tp")

# The engine's fixed decode window (engine/engine.py DECODE_WINDOW),
# kept here so the fleet's modules import no engine.
PORT_WINDOW = 8

_MESH_TOKEN = re.compile(
    r"^(?:(?:dp|pp|sp|ep|tp)\d+)(?:x(?:dp|pp|sp|ep|tp)\d+)*$")
_AXIS_DEG = re.compile(r"(dp|pp|sp|ep|tp)(\d+)")

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

    def axis(self, name: str) -> int:
        return int(self.mesh[AXES.index(name)])

    def mesh_config(self):
        """The parallel/mesh.MeshConfig this spec names (imported here:
        the fleet's modules import no torch)."""
        from dynamo_tpu_torch.parallel.mesh import MeshConfig

        return MeshConfig(*(int(d) for d in self.mesh))

    def serves_role(self, role: str) -> bool:
        """Can a request phase `role` land on this slice?  "both" serves
        prefill and decode; dedicated slices serve only their phase."""
        if role == "both":
            return self.role == "both"
        return self.role == role or self.role == "both"

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


def parse_slice(spec: str) -> SliceSpec:
    """The worker's declarative `--slice` string (JAX's grammar).

    Comma-separated tokens, order-free:

      mesh descriptor   "tp2", "sp2xtp2", "single"  (axis-degree pairs)
      kv mode           "int8" | "bf16"
      role              "role=prefill" | "role=decode" | "role=both"
      features          "packed" (packed prefill), "spec" (spec decode),
                        "window8" (the port's decode window),
                        "dp_attention", "dp_local", "pallas"

    Example: `--slice "sp2xtp2,int8,packed,role=prefill"` stands for
    `--sp 2 --tp 2 --kv-quant int8 --role prefill`.  A window other than
    the port's raises (ROADMAP.md A2)."""
    mesh = [1] * len(AXES)
    role = "both"
    kv_quant = "none"
    features = []
    for raw in spec.split(","):
        tok = raw.strip().lower()
        if not tok or tok == "single":
            continue
        if _MESH_TOKEN.match(tok):
            for axis, deg in _AXIS_DEG.findall(tok):
                mesh[AXES.index(axis)] = int(deg)
            continue
        if tok in ("int8", "bf16", "none"):
            kv_quant = "int8" if tok == "int8" else "none"
            continue
        if tok.startswith("role="):
            role = tok.split("=", 1)[1]
            if role not in ROLES:
                raise ValueError(
                    f"--slice role must be one of {ROLES}, got {role!r}")
            continue
        if tok in ("packed", "packed_prefill"):
            features.append("packed_prefill")
            continue
        if tok in ("spec", "dp_attention", "dp_local", "pallas"):
            features.append(tok)
            continue
        m = re.match(r"^window(\d+)$", tok)
        if m:
            if int(m.group(1)) != PORT_WINDOW:
                raise ValueError(
                    f"--slice {tok!r}: the port's decode window is fixed at "
                    f"{PORT_WINDOW} (window{PORT_WINDOW}); a window knob "
                    "waits for ROADMAP.md A2")
            features.append(tok)
            continue
        raise ValueError(
            f"unrecognized --slice token {raw.strip()!r} "
            "(want a mesh descriptor like 'sp2xtp2', 'int8', "
            "'role=prefill', or a feature: packed/spec/windowN)")
    return SliceSpec(mesh=tuple(mesh), role=role, kv_quant=kv_quant,
                     features=tuple(dict.fromkeys(features)))


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
