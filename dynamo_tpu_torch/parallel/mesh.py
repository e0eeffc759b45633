"""The port's mesh: the five named axes, and the sequence-parallel ring.

`MeshConfig` keeps the JAX package's axis order (dp, pp, sp, ep, tp) and
its `describe()`.  Only `sp` is wired in the port so far; any other axis
above 1 raises, naming the roadmap item that queues it.

A JAX mesh is an array of devices, one program each, so it can be no
larger than the devices it is made of.  A CUDA card runs many streams, so
the port's ring is made of RANKS instead: `SpRing` takes a list of
`torch.device`s, one per rank, which may name one card several times.
Rank r owns a compute stream (its slice's token-wise ops and its folds)
and a copy stream (the block it sends to rank `(r + 1) % sp`), and two
receive slots per block geometry.  Copies between ranks on one card are
device-to-device copies that run beside the compute stream; between
cards the same `Tensor.copy_` is a peer copy.  The whole ring lives in
one process and is driven by one host thread: there is no
`torch.distributed` and no NCCL here, which would refuse two ranks on one
card.

Slot discipline, as the TPU kernel's double buffer: at hop h a rank
folds the block in its slot `h % 2` (its own, unstaged block at hop 0)
while its copy stream already sends that block into the right
neighbour's slot `(h + 1) % 2`.  The next hop's fold waits on that copy's
event; a copy into a slot waits on the events of the last fold and the
last send that read the slot (the TPU kernel's ack credit).  Nothing
waits on the host.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("dp", "pp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Degrees per axis.  Only `sp` may exceed 1 in the port so far."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis, n in zip(AXES, self.shape):
            if n < 1:
                raise ValueError(f"mesh axis {axis}={n} must be at least 1")
            if axis != "sp" and n > 1:
                raise ValueError(
                    f"mesh axis {axis}={n}: only sp is ported; tp/dp/ep/pp "
                    "wait for ROADMAP.md A7")

    @property
    def shape(self) -> tuple:
        return (self.dp, self.pp, self.sp, self.ep, self.tp)

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.ep * self.tp

    def describe(self) -> str:
        return "x".join(f"{a}{n}" for a, n in zip(AXES, self.shape)
                        if n > 1) or "single"


def default_sp_devices(sp: int, primary: torch.device) -> List[torch.device]:
    """One device per rank: every rank on the CPU for a CPU engine, else
    round-robin over the visible cards starting at the primary one, so
    rank 0 shares the card of the paged cache."""
    if primary.type != "cuda":
        return [primary] * sp
    n = torch.cuda.device_count()
    first = primary.index if primary.index is not None else (
        torch.cuda.current_device())
    return [torch.device("cuda", (first + r) % n) for r in range(sp)]


class _Slots:
    """Two receive slots of one block geometry on one rank, with the
    events that order their writers and readers."""

    def __init__(self, like: Sequence[torch.Tensor], device: torch.device):
        self.bufs = [tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                           for t in like) for _ in range(2)]
        self.recv: List[Optional[torch.cuda.Event]] = [None, None]
        self.readers: List[List[torch.cuda.Event]] = [[], []]


class SpRing:
    """The sequence-parallel ring: `sp` ranks on a list of devices."""

    def __init__(self, devices: Sequence[torch.device]):
        devices = [torch.device(d) for d in devices]
        if len(devices) < 1:
            raise ValueError("a ring needs at least one rank")
        kinds = {d.type for d in devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"ring ranks must all be cpu or all cuda: "
                             f"{[str(d) for d in devices]}")
        if devices[0].type == "cuda":
            devices = [torch.device("cuda", d.index if d.index is not None
                                    else torch.cuda.current_device())
                       for d in devices]
        self.devices: List[torch.device] = devices
        self.sp = len(devices)
        self.cuda = devices[0].type == "cuda"
        # Distinct cards, in rank order.
        self.cards: List[torch.device] = list(dict.fromkeys(devices))
        if self.cuda:
            self.compute_streams = [torch.cuda.Stream(d) for d in devices]
            self.copy_streams = [torch.cuda.Stream(d) for d in devices]
        else:
            self.compute_streams = self.copy_streams = [None] * self.sp
        self._slots: List[Dict[tuple, _Slots]] = [{} for _ in devices]
        # id(state) -> (state, one replica per rank); the state is held
        # so that its id stays its own.
        self._replicas: Dict[int, Tuple[dict, List[dict]]] = {}

    @classmethod
    def for_mesh(cls, mesh: MeshConfig, primary: torch.device,
                 devices: Optional[Sequence] = None) -> "SpRing":
        """The ring of a mesh's sp axis.  `devices` names each rank's
        device; the default spreads the ranks over the visible cards.
        Rank 0 must lie on `primary`, the card of the paged cache."""
        if devices is None:
            devices = default_sp_devices(mesh.sp, torch.device(primary))
        ring = cls(devices)
        if ring.sp != mesh.sp:
            raise ValueError(f"mesh {mesh.describe()} needs {mesh.sp} rank "
                             f"devices, have {ring.sp}")
        want = cls([primary]).devices[0]
        if ring.devices[0] != want:
            raise ValueError(f"rank 0 must lie on the engine's device "
                             f"{want}, not {ring.devices[0]}")
        return ring

    def describe(self) -> List[str]:
        """The rank -> device map, as strings."""
        return [str(d) for d in self.devices]

    # -- streams -----------------------------------------------------------

    def on(self, rank: int):
        """Context: rank's device and compute stream are current."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.compute_streams[rank])

    def on_pair(self, dst: int, src: int):
        """Context for a copy from rank src's tensors to rank dst's
        device: both ranks' compute streams are current on their cards,
        so a cross-card copy orders itself against both."""
        stack = contextlib.ExitStack()
        stack.enter_context(self.on(dst))
        if self.devices[src] != self.devices[dst]:
            stack.enter_context(self.on(src))
        return stack

    def fork(self) -> None:
        """Every rank's compute stream waits for the work queued so far on
        its card's current stream and on rank 0's card's."""
        if not self.cuda:
            return
        evs = {}
        for d in self.cards:
            evs[d] = torch.cuda.Event()
            evs[d].record(torch.cuda.current_stream(d))
        for r, s in enumerate(self.compute_streams):
            s.wait_event(evs[self.devices[r]])
            s.wait_event(evs[self.devices[0]])

    def join(self) -> None:
        """The current stream of every rank's card, and of rank 0's card,
        waits for every rank's compute stream.  Sends are covered: each is
        waited for by the fold that reads it."""
        if not self.cuda:
            return
        main = torch.cuda.current_stream(self.devices[0])
        for r, s in enumerate(self.compute_streams):
            ev = torch.cuda.Event()
            ev.record(s)
            main.wait_event(ev)
            if self.devices[r] != self.devices[0]:
                torch.cuda.current_stream(self.devices[r]).wait_event(ev)

    def mark(self, rank: int):
        """An event after the work queued so far on rank's compute stream
        (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.compute_streams[rank])
        return ev

    def to_rank(self, dst: int, src: int, t: torch.Tensor) -> torch.Tensor:
        """Tensor `t`, made on rank src's compute stream, for use on rank
        dst's: rank dst waits for it, and a tensor on another card is
        copied over."""
        if not self.cuda or dst == src:
            return t
        self.compute_streams[dst].wait_event(self.mark(src))
        if self.devices[src] == self.devices[dst]:
            t.record_stream(self.compute_streams[dst])
            return t
        with self.on_pair(dst, src):
            return t.to(self.devices[dst], non_blocking=True)

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """One tensor per rank, concatenated on rank 0's card and compute
        stream."""
        moved = [self.to_rank(0, r, t) for r, t in enumerate(parts)]
        with self.on(0):
            return torch.cat(moved, dim=dim)

    # -- parameters --------------------------------------------------------

    def replicas(self, state: dict) -> List[dict]:
        """The model state for each rank: one replica per distinct card,
        shared by the ranks on it.  The card that already holds `state`
        uses it as it is."""
        hit = self._replicas.get(id(state))
        if hit is not None:
            return hit[1]
        home = state["embed"].device
        per_card = {}
        for d in self.cards:
            per_card[d] = state if d == home else _to_device(state, d)
        out = [per_card[d] for d in self.devices]
        self._replicas[id(state)] = (state, out)
        return out

    # -- the rotation ------------------------------------------------------

    def slots(self, rank: int, like: Sequence[torch.Tensor]) -> _Slots:
        key = tuple((tuple(t.shape), t.dtype) for t in like)
        slots = self._slots[rank].get(key)
        if slots is None:
            slots = self._slots[rank][key] = _Slots(like, self.devices[rank])
        return slots

    def send(self, rank: int, hop: int, src: Sequence[torch.Tensor],
             ready, like: Sequence[torch.Tensor]) -> None:
        """Queue, on rank's copy stream, the copy of block `src` (the one
        rank folds at `hop`) into the right neighbour's slot
        `(hop + 1) % 2`.  `ready` is the event after which `src` may be
        read (None: at once)."""
        right = (rank + 1) % self.sp
        slot = (hop + 1) % 2
        dst = self.slots(right, like)
        if not self.cuda:
            for d, s in zip(dst.bufs[slot], src):
                d.copy_(s)
            return
        stream = self.copy_streams[rank]
        if ready is not None:
            stream.wait_event(ready)
        for ev in dst.readers[slot]:
            stream.wait_event(ev)
        with torch.cuda.stream(stream):
            for d, s in zip(dst.bufs[slot], src):
                d.copy_(s, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        dst.recv[slot] = done
        dst.readers[slot] = []
        if hop > 0:
            # `src` is rank's own slot hop % 2: the next copy into it must
            # wait for this send as well as for the fold.
            self.slots(rank, like).readers[hop % 2].append(done)

    def received(self, rank: int, hop: int, like: Sequence[torch.Tensor]):
        """(block, event) of the block rank folds at `hop` >= 1: its slot
        `hop % 2` and the event of the copy that filled it."""
        slots = self.slots(rank, like)
        return slots.bufs[hop % 2], slots.recv[hop % 2]

    def folded(self, rank: int, hop: int,
               like: Sequence[torch.Tensor]) -> None:
        """Note that rank's fold of its slot `hop % 2` is queued: a later
        copy into the slot waits for it."""
        if self.cuda and hop > 0:
            self.slots(rank, like).readers[hop % 2].append(self.mark(rank))


def _to_device(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_device(v, device) for v in x]
    return x.to(device)
