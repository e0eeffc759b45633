"""The port's mesh: the five named axes, the sequence-parallel ring, the
tensor-parallel group, the expert-parallel group, the rank grid and the
pipeline's stages.

`MeshConfig` keeps the JAX package's axis order (dp, pp, sp, ep, tp) and
its `describe()`.  Every axis is wired in the port; pp composes with no
other axis, in the words of JAX's `_validate_pp`.  What else cannot
compose is JAX's to say: `sharding.validate` refuses an ep axis on a
dense model, and the capability table (`sharding.plane_capability`)
refuses the ring prefill on an MoE model and under dp-attention.

A JAX mesh is an array of devices, one program each, so it can be no
larger than the devices it is made of.  A CUDA card runs many streams, so
the port's meshes are made of RANKS instead: a list of `torch.device`s,
one per rank, which may name one card several times.  Each mesh lives in
one process and is driven by one host thread: there is no
`torch.distributed` and no NCCL here, which would refuse two ranks on one
card.  Nothing below waits on the host.

`SpRing`: rank r owns a compute stream (its slice's token-wise ops and
its folds) and a copy stream (the block it sends to rank `(r + 1) % sp`),
and two receive slots per block geometry.  Copies between ranks on one
card are device-to-device copies that run beside the compute stream;
between cards the same `Tensor.copy_` is a peer copy.  Slot discipline,
as the TPU kernel's double buffer: at hop h a rank folds the block in its
slot `h % 2` (its own, unstaged block at hop 0) while its copy stream
already sends that block into the right neighbour's slot `(h + 1) % 2`.
The next hop's fold waits on that copy's event; a copy into a slot waits
on the events of the last fold and the last send that read the slot (the
TPU kernel's ack credit).  A ring of a rank grid (`SpRing.of_members`)
computes on the streams of the grid's ranks instead of streams of its
own, so the ring and the grid's collectives order one another.

`TpGroup`: the collectives of one dp row of tp ranks (Megatron's tensor
parallelism), each rank holding its slice of the weights and of the
paged cache's heads (parallel/sharding.py).  Rank 0 runs on the caller's
current stream of its card, so a step's inputs and outputs need no
hand-over; every other rank runs on a compute stream of its own.  The
replicated activations live on every rank; the collectives are
`all_reduce` (the row-parallel sum) and `all_gather` (the vocab-sharded
logits), each ordered by events.

`EpGroup`: the ep ranks of one (dp row, tp slice), each holding E/ep
experts; its collectives are `all_to_all` (the dispatch's exchange of
per-expert buffers, JAX's `jax.lax.all_to_all` over the ep axis),
`gather` and `all_gather`, each a device-to-device copy between the
ranks' streams on one card and a peer copy between cards, ordered by
events.

`DpGrid`: the (dp, sp, ep, tp) rank grid every sharded step runs on,
JAX's dp, dp-attention and dp-local modes, tensor parallelism alone as
the grid of one dp row (`dp=1`), expert parallelism as `ep` ranks a (dp
row, tp slice) and sequence parallelism as `sp` ranks a (dp row, tp
slice).  Ranks are numbered flat in JAX's axis order, `flat = ((d * sp +
s) * ep + e) * tp + t` (with sp 1, `(d * ep + e) * tp + t`); (d, s, e)
is a TpGroup of its tp ranks, (d, t) an EpGroup of its ep ranks and,
under sp, an SpRing of its sp ranks.  Rank 0 runs on the caller's stream
and every other rank on a stream of its own, so the rows run side by
side.  The batch splits over the dp rows in contiguous ranges (JAX's
`P("dp")`, or `P(("dp", "tp"))` under dp-attention), each row's outputs
come back to rank 0 (`home`), and inside a row the TpGroup's collectives
apply.  Attention, the embedding and the head run on the ranks of sp and
ep index 0 (`attention`, the grid the KV cache is laid out over: JAX's
cache specs name neither sp nor ep), an MoE layer's tokens split over
the row's ep ranks, and only the ring prefill (models/llama.py
`_grid_sp_forward`) runs the ranks of sp index s > 0, each on token
slice s of its row.  Ranks of one place (`places[f]`, by default the
card) and one piece share one copy of it: on one card the sp ranks add
streams and no weights.  A meshless step runs no grid.

A grid may also span worker processes (parallel/multihost.py, `fabric`):
its ranks split process-major, k = n / N a process, and a process
computes only on its own (`mine`); the others are placeholders.  Within
a process everything stays streams and events; a TpGroup or a grid whose
ranks live in several processes gathers through `torch.distributed`
(`Fabric.gather`), and sums the gathered partials in rank order exactly
as one process does, so the results are the same bits.  Every output a
host reads (`gather_rows`) lands whole on every process.

`PpStages`: the pipeline's S stage ranks (JAX's GPipe stage schedule,
parallel/pipeline.py).  Stage s owns layers `[s * L/S, (s + 1) * L/S)`
and those layers' paged KV.  Stage 0 runs on the caller's current
stream and every other stage on a stream of its own, on one card or
several.  An activation crosses from stage s to s + 1 through `send`:
on one card the receiving stream waits on an event after the sender's
work and the tensor is recorded on it (`record_stream`), so the caching
allocator does not hand its memory out while the next stage reads it;
across cards the same event orders a peer `copy_`.  `home` brings the
last stage's outputs back to the caller's stream on stage 0's card, as
`DpGrid.home` does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("dp", "pp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Degrees per axis: `pp` may exceed 1 only where every other axis
    is 1."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis, n in zip(AXES, self.shape):
            if n < 1:
                raise ValueError(f"mesh axis {axis}={n} must be at least 1")
        if self.pp > 1:
            for axis in ("dp", "sp", "ep", "tp"):
                n = getattr(self, axis)
                if n != 1:
                    raise ValueError(
                        f"pp v1 composes with no other axis in-mesh (got "
                        f"{axis}={n}); run dp via engine replicas")

    @property
    def shape(self) -> tuple:
        return (self.dp, self.pp, self.sp, self.ep, self.tp)

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.ep * self.tp

    def describe(self) -> str:
        return "x".join(f"{a}{n}" for a, n in zip(AXES, self.shape)
                        if n > 1) or "single"


def default_rank_devices(n: int, primary: torch.device) -> List[torch.device]:
    """One device per rank: every rank on the CPU for a CPU engine, else
    round-robin over the visible cards starting at the primary one (a
    card a rank where the machine has n cards), so rank 0 shares the
    card of the engine's device."""
    if primary.type != "cuda":
        return [primary] * n
    cards = torch.cuda.device_count()
    first = primary.index if primary.index is not None else (
        torch.cuda.current_device())
    return [torch.device("cuda", (first + r) % cards) for r in range(n)]


def _rank_devices(devices: Sequence, what: str) -> List[torch.device]:
    """The ranks' devices, all cpu or all cuda, each cuda one with its
    index."""
    devices = [torch.device(d) for d in devices]
    if len(devices) < 1:
        raise ValueError(f"a {what} needs at least one rank")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"{what} ranks must all be cpu or all cuda: "
                         f"{[str(d) for d in devices]}")
    if devices[0].type == "cuda":
        devices = [torch.device("cuda", d.index if d.index is not None
                                else torch.cuda.current_device())
                   for d in devices]
    return devices


class _Slots:
    """Two receive slots of one block geometry on one rank, with the
    events that order their writers and readers."""

    def __init__(self, like: Sequence[torch.Tensor], device: torch.device):
        self.bufs = [tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                           for t in like) for _ in range(2)]
        self.recv: List[Optional[torch.cuda.Event]] = [None, None]
        self.readers: List[List[torch.cuda.Event]] = [[], []]


class _Members:
    """Ranks that compute on the streams of TpGroups: rank i is member
    `t` of TpGroup `g`, `members[i] = (g, t)`."""

    members: List[Tuple["TpGroup", int]]

    def on(self, i: int):
        """Context: rank i's device and stream are current."""
        g, t = self.members[i]
        return g.on(t)

    def stream(self, i: int) -> "torch.cuda.Stream":
        """Rank i's compute stream (cuda only)."""
        g, t = self.members[i]
        return g._stream(t)


class SpRing(_Members):
    """The sequence-parallel ring: `sp` ranks on a list of devices."""

    def __init__(self, devices: Sequence[torch.device],
                 members: Optional[Sequence[Tuple["TpGroup", int]]] = None):
        """`members` ((TpGroup, index) a rank, `of_members`): the ranks
        compute on those groups' streams; without them, on streams of the
        ring's own."""
        devices = _rank_devices(devices, "ring")
        self.devices: List[torch.device] = devices
        self.sp = len(devices)
        self.cuda = devices[0].type == "cuda"
        if members is None:
            own = TpGroup(devices, own_first=True)
            members = [(own, r) for r in range(self.sp)]
        self.members = list(members)
        # Distinct cards, in rank order.
        self.cards: List[torch.device] = list(dict.fromkeys(devices))
        self.copy_streams = ([torch.cuda.Stream(d) for d in devices]
                             if self.cuda else [None] * self.sp)
        self._slots: List[Dict[tuple, _Slots]] = [{} for _ in devices]
        # id(state) -> (state, one replica per rank); the state is held
        # so that its id stays its own.
        self._replicas: Dict[int, Tuple[dict, List[dict]]] = {}

    @classmethod
    def of_members(cls, members: Sequence[Tuple["TpGroup", int]]) -> "SpRing":
        """The ring of a rank grid's (dp row, tp slice): rank s is member
        `t` of the grid's TpGroup (d, s) and computes on that rank's
        stream (the caller's own for rank (0, 0, 0))."""
        return cls([g.devices[t] for g, t in members], members)

    @classmethod
    def for_mesh(cls, mesh: MeshConfig, primary: torch.device,
                 devices: Optional[Sequence] = None) -> "SpRing":
        """The ring of a mesh's sp axis.  `devices` names each rank's
        device; the default spreads the ranks over the visible cards.
        Rank 0 must lie on `primary`, the card of the paged cache."""
        if devices is None:
            devices = default_rank_devices(mesh.sp, torch.device(primary))
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
        for r in range(self.sp):
            s = self.stream(r)
            s.wait_event(evs[self.devices[r]])
            s.wait_event(evs[self.devices[0]])

    def join(self) -> None:
        """The current stream of every rank's card, and of rank 0's card,
        waits for every rank's compute stream.  Sends are covered: each is
        waited for by the fold that reads it."""
        if not self.cuda:
            return
        main = torch.cuda.current_stream(self.devices[0])
        for r in range(self.sp):
            ev = self.mark(r)
            main.wait_event(ev)
            if self.devices[r] != self.devices[0]:
                torch.cuda.current_stream(self.devices[r]).wait_event(ev)

    def mark(self, rank: int):
        """An event after the work queued so far on rank's compute stream
        (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream(rank))
        return ev

    def to_rank(self, dst: int, src: int, t: torch.Tensor) -> torch.Tensor:
        """Tensor `t`, made on rank src's compute stream, for use on rank
        dst's: rank dst waits for it, and a tensor on another card is
        copied over."""
        if not self.cuda or dst == src:
            return t
        self.stream(dst).wait_event(self.mark(src))
        if self.devices[src] == self.devices[dst]:
            t.record_stream(self.stream(dst))
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


class TpGroup:
    """The tensor-parallel group: tp ranks on a list of devices.

    Rank 0 runs on its card's current stream; ranks 1.. on compute
    streams of their own.  A step brackets its ranks' work with `fork()`
    and `join()` and hands tensors between ranks only through
    `replicate`, `all_reduce` and `all_gather`, which order themselves by
    events and keep the caching allocator from reusing a buffer another
    rank's stream still reads (`record_stream`)."""

    def __init__(self, devices: Sequence, home=None,
                 own_first: bool = False, mine: Optional[Sequence] = None,
                 fabric=None, procs: Tuple[int, ...] = ()):
        """`home` is the device of the caller's stream (default rank 0's);
        `own_first` gives rank 0 a stream of its own too (the later rows
        of a DpGrid).  `mine` (a process-spanning grid's): which ranks
        this process computes; `procs` the processes that own the
        group's ranks, whose collectives go through `fabric`."""
        self.devices: List[torch.device] = _rank_devices(devices, "tp group")
        self.tp = len(self.devices)
        self.home_device = (self.devices[0] if home is None
                            else _rank_devices([home], "tp group")[0])
        self.cuda = self.devices[0].type == "cuda" and (
            self.tp > 1 or own_first)
        self.mine = [True] * self.tp if mine is None else list(mine)
        self.local = [r for r in range(self.tp) if self.mine[r]]
        self.fabric, self.procs = fabric, tuple(procs)
        self.spans = len(self.procs) > 1
        # Distinct cards, in rank order.
        self.cards: List[torch.device] = list(dict.fromkeys(self.devices))
        self.streams: List[Optional[torch.cuda.Stream]] = [None] * self.tp
        if self.cuda:
            first = 0 if own_first else 1
            self.streams[first:] = [
                torch.cuda.Stream(d) if self.mine[r] else None
                for r, d in enumerate(self.devices[first:], first)]

    def describe(self) -> List[str]:
        """The rank -> device map, as strings."""
        return [str(d) for d in self.devices]

    def on(self, rank: int):
        """Context: rank's device and stream are current (rank 0: the
        caller's own)."""
        if self.streams[rank] is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[rank])

    def _stream(self, rank: int) -> "torch.cuda.Stream":
        return self.streams[rank] or torch.cuda.current_stream(
            self.devices[rank])

    def _mark(self, rank: int) -> "torch.cuda.Event":
        ev = torch.cuda.Event()
        ev.record(self._stream(rank))
        return ev

    def fork(self) -> None:
        """Every rank's stream waits for the work queued so far on its
        card's current stream and on rank 0's card's (the step's inputs,
        an injected block)."""
        if not self.cuda:
            return
        evs = {}
        for d in dict.fromkeys(self.cards + [self.home_device]):
            evs[d] = torch.cuda.Event()
            evs[d].record(torch.cuda.current_stream(d))
        for r, s in enumerate(self.streams):
            if s is not None:
                s.wait_event(evs[self.devices[r]])
                s.wait_event(evs[self.home_device])

    def join(self) -> None:
        """The current stream of every rank's card waits for every rank on
        that card and the home card's waits for all of them, so the step's
        outputs and the ranks' cache writes are ordered before what the
        caller queues next."""
        if not self.cuda:
            return
        main = torch.cuda.current_stream(self.home_device)
        for r, s in enumerate(self.streams):
            if s is None:
                continue
            ev = self._mark(r)
            main.wait_event(ev)
            if self.devices[r] != self.home_device:
                torch.cuda.current_stream(self.devices[r]).wait_event(ev)

    def _move(self, dst: int, src: int, t: torch.Tensor) -> torch.Tensor:
        """Tensor `t`, made on rank src's stream, for use on rank dst's:
        dst's stream waits for it; a tensor on another card is copied
        over (a peer copy ordered against both ranks' streams)."""
        if not self.cuda or dst == src:
            return t
        self._stream(dst).wait_event(self._mark(src))
        if self.devices[dst] == self.devices[src]:
            t.record_stream(self._stream(dst))
            return t
        with self.on(dst), self.on(src):
            return t.to(self.devices[dst], non_blocking=True)

    def _spread(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t`, on rank 0, for every rank: one copy for each other card,
        made by its first rank and shared by the rest on it."""
        holder = {self.devices[0]: (0, t)}
        out = [t]
        for r in range(1, self.tp):
            d = self.devices[r]
            if d not in holder:
                holder[d] = (r, self._move(r, 0, t))
                out.append(holder[d][1])
                continue
            src, held = holder[d]
            out.append(self._move(r, src, held))
        return out

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A tensor of the caller's (rank 0's card, current stream), for
        every rank, after `fork()` (a process-spanning group: for its
        local ranks, None for the others)."""
        if len(self.local) < self.tp:
            out: List[Optional[torch.Tensor]] = [None] * self.tp
            for r in self.local:
                if self.cuda and self.streams[r] is not None:
                    t.record_stream(self.streams[r])
                out[r] = t
            return out
        if not self.cuda:
            return [t] * self.tp
        if self.streams[0] is not None:
            t.record_stream(self.streams[0])
            if t.device != self.devices[0]:
                # A later row whose rank 0 lies on another card: its copy
                # comes over on rank 0's stream, which the fork ordered
                # after the caller's.
                with self.on(0):
                    t = t.to(self.devices[0], non_blocking=True)
        return self._spread(t)

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The row-parallel sum: rank r's partial `parts[r]` summed on rank
        0 (the other cards' partials peer-copied there first), rounded to
        the partials' dtype once, and the sum on every rank."""
        if self.tp == 1:
            return list(parts)
        lead, moved = self._collect(parts)
        with self.on(lead):
            if len(moved) == 2:
                total = moved[0] + moved[1]
            else:
                total = torch.stack(moved).sum(0, dtype=torch.float32).to(
                    moved[0].dtype)
        return self._share(lead, total)

    @property
    def lead(self) -> int:
        """The rank a collective's result is made on: rank 0, or this
        process's first rank of a process-spanning group."""
        return self.local[0] if self.spans else 0

    def _collect(self, parts: Sequence[Optional[torch.Tensor]]):
        """(lead, every rank's part in rank order, usable on the lead's
        stream): moved there within a process, gathered through the
        fabric from the other processes' ranks."""
        lead = self.lead
        if not self.spans:
            return lead, [self._move(0, r, p) for r, p in enumerate(parts)]
        own = [self._move(lead, r, parts[r]) for r in self.local]
        with self.on(lead):
            got = self.fabric.gather(torch.stack(own), self.procs)
        return lead, [x for g in got for x in g.unbind(0)]

    def _share(self, lead: int, x: torch.Tensor) -> List[torch.Tensor]:
        """`x`, made on the lead's stream, for every rank (a
        process-spanning group: its local ranks; None for the others)."""
        if self.spans:
            return [self._move(r, lead, x) if self.mine[r] else None
                    for r in range(self.tp)]
        if not self.cuda:
            return [x] * self.tp
        return self._spread(x)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> torch.Tensor:
        """Rank r's `parts[r]` concatenated along `dim` on rank 0 (a
        process-spanning group: on each process's lead rank)."""
        if self.tp == 1:
            return parts[0]
        lead, moved = self._collect(parts)
        with self.on(lead):
            return torch.cat(moved, dim=dim)

    def all_gather_all(self, parts: Sequence[torch.Tensor],
                       dim: int) -> List[torch.Tensor]:
        """Rank r's `parts[r]` concatenated along `dim`, on every rank
        (dp-attention's rows, gathered for the tp-sharded MLP)."""
        if self.tp == 1:
            return list(parts)
        return self._share(self.lead, self.all_gather(parts, dim))


class EpGroup(_Members):
    """The expert-parallel group of one (dp row, tp slice): its ep ranks,
    rank e being member `t` of the grid's TpGroup (d, e), on that group's
    stream.  Every tensor handed between ranks goes through `_move`: the
    receiving stream waits on an event after the sender's work, and a
    tensor on another card is peer-copied (ordered against both ranks'
    streams)."""

    def __init__(self, members: Sequence[Tuple["TpGroup", int]]):
        self.members = list(members)
        self.ep = len(self.members)
        self.devices = [g.devices[t] for g, t in self.members]
        self.cuda = self.devices[0].type == "cuda"

    def _move(self, dst: int, src: int, x: torch.Tensor) -> torch.Tensor:
        """Tensor `x`, made on rank src's stream, for use on rank dst's."""
        if not self.cuda or dst == src:
            return x
        ev = torch.cuda.Event()
        ev.record(self.stream(src))
        self.stream(dst).wait_event(ev)
        if self.devices[dst] == self.devices[src]:
            x.record_stream(self.stream(dst))
            return x
        with self.on(dst), self.on(src):
            return x.to(self.devices[dst], non_blocking=True)

    def scatter(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """`x`, on rank 0, cut into ep contiguous ranges along `dim`,
        range e on rank e (JAX's `P("ep")` of a replicated array)."""
        n = x.shape[dim] // self.ep
        return [self._move(e, 0, x.narrow(dim, e * n, n))
                for e in range(self.ep)]

    def all_to_all(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """JAX's `all_to_all(split_axis=0, concat_axis=0, tiled=False)`:
        rank s's `parts[s]` is [ep, ...], its slice e bound for rank e;
        rank e gets [ep, ...] whose slice s came from rank s.  One stack
        a rank on its own stream, after every sender's event."""
        if self.ep == 1:
            return list(parts)
        out = []
        for e in range(self.ep):
            got = [self._move(e, s, parts[s][e]) for s in range(self.ep)]
            with self.on(e):
                out.append(torch.stack(got))
        return out

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """Rank e's `parts[e]` concatenated along `dim` on rank 0 (the ep
        ranges of a row joined)."""
        if self.ep == 1:
            return parts[0]
        moved = [self._move(0, e, p) for e, p in enumerate(parts)]
        with self.on(0):
            return torch.cat(moved, dim=dim)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """Rank e's `parts[e]` concatenated along `dim`, on every rank."""
        whole = self.gather(parts, dim)
        return [self._move(e, 0, whole) for e in range(self.ep)]

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' partials summed on rank 0, in f32, rounded to their
        dtype once."""
        if self.ep == 1:
            return parts[0]
        moved = [self._move(0, e, p) for e, p in enumerate(parts)]
        with self.on(0):
            return torch.stack(moved).sum(0, dtype=torch.float32).to(
                moved[0].dtype)


class DpGrid:
    """The (dp, sp, ep, tp) rank grid: dp rows of sp x ep x tp ranks each,
    ranks numbered flat (`((d * sp + s) * ep + e) * tp + t`), and the mode
    the grid runs.

    - plain dp: a dp row runs its share of the batch tensor-parallel,
      its tp slices of the weights and of a head-sharded cache
      replicated over dp;
    - `dp_attention`: a row's share splits again over its tp ranks for
      attention, with replicated attention weights and a cache whose
      SLOT axis shards over tp (replicated over dp); the MLP stays
      tp-sharded over the row's whole share;
    - `dp_local` (implies dp_attention): the cache's slots shard over
      the flat (dp, tp) grid and each rank attends only its own shard.

    `ep` ranks a (row, tp slice) hold E/ep experts each.  Everything but
    an MoE layer runs on the ranks of ep index 0 (`attention`: the grid
    of those ranks, over which the KV cache is laid out and replicated
    over ep); an MoE layer's tokens split over the row's ep ranks
    (`eps[d][t]`), whose partial outputs join on ep index 0.

    `sp` ranks a (row, tp slice) form its ring (`rings[d][t]`), which
    only the ring prefill runs: rank (d, s, t) takes token slice s of
    row d with tp slice t's weights, each (d, s) a TpGroup
    (`sp_tps[d][s]`; `sp_tps[d][0]` is `rows[d]`).  Decode, the packed
    prefill and the cache stay on the ranks of sp index 0, today's grid.
    What sp does not compose with (ep, dp-attention) is refused by the
    step's builders (JAX's capability table and `validate`).

    `places` names where each rank's copies live (default: its device):
    ranks of one place and one piece share one copy, so a card holds
    each slice once."""

    def __init__(self, devices: Sequence, dp: int,
                 dp_attention: bool = False, dp_local: bool = False,
                 places: Optional[Sequence] = None, ep: int = 1,
                 sp: int = 1, fabric=None):
        """`fabric` (parallel/multihost.Fabric): the grid spans its
        processes, process-major; a process computes only on its own
        ranks (`mine`), every one of them on `devices[f]`."""
        self.devices: List[torch.device] = _rank_devices(devices, "dp grid")
        self.n = len(self.devices)
        if dp < 1 or ep < 1 or sp < 1 or self.n % (dp * sp * ep):
            what = ("dp" if ep == sp == 1 else "dp*ep" if sp == 1
                    else "dp*sp" if ep == 1 else "dp*sp*ep")
            raise ValueError(f"{what}={dp * sp * ep} must divide the "
                             f"grid's {self.n} ranks")
        if dp_local and not dp_attention:
            raise ValueError("dp_local implies dp_attention")
        self.dp, self.sp, self.ep = dp, sp, ep
        self.tp = self.n // (dp * sp * ep)
        self.dp_attention, self.dp_local = dp_attention, dp_local
        self.fabric = fabric if fabric is not None and fabric.spans else None
        self.spans = self.fabric is not None
        self.owner = [0] * self.n
        if self.spans:
            _check_spanning(self, self.fabric)
            self.owner = [self.fabric.owner(f, self.n) for f in range(self.n)]
        me = self.fabric.process_id if self.spans else 0
        self.mine = [o == me for o in self.owner]
        self.cuda = self.devices[0].type == "cuda"
        self.cards: List[torch.device] = list(dict.fromkeys(self.devices))
        tp, home = self.tp, self.devices[0]

        def procs(ranks):
            return tuple(sorted({self.owner[f] for f in ranks}))

        # tps[d][e]: the TpGroup of ranks (d, 0, e, *); rows[d] = tps[d][0].
        self.tps = [[TpGroup([self.devices[self.flat(d, e, t)]
                              for t in range(tp)], home=home,
                             own_first=(d, e) != (0, 0),
                             mine=[self.mine[self.flat(d, e, t)]
                                   for t in range(tp)],
                             fabric=self.fabric,
                             procs=procs([self.flat(d, e, t)
                                          for t in range(tp)]))
                     for e in range(ep)] for d in range(dp)]
        self.rows = [g[0] for g in self.tps]
        self.eps = [[EpGroup([(self.tps[d][e], t) for e in range(ep)])
                     for t in range(tp)] for d in range(dp)]
        # sp_tps[d][s]: the TpGroup of ranks (d, s, 0, *); rings[d][t]: the
        # ring of ranks (d, *, 0, t).
        self.sp_tps = [[self.rows[d]] + [
            TpGroup([self.devices[self.flat(d, 0, t, s)] for t in range(tp)],
                    home=home, own_first=True) for s in range(1, sp)]
            for d in range(dp)]
        self.rings = ([[SpRing.of_members([(self.sp_tps[d][s], t)
                                           for s in range(sp)])
                        for t in range(tp)] for d in range(dp)]
                      if sp > 1 else None)
        self.places = list(places) if places is not None else list(
            self.devices)
        if len(self.places) != self.n:
            raise ValueError(f"{len(self.places)} places for {self.n} ranks")
        # Another process's rank holds its own copies.
        self.places = [p if self.mine[f] else ("process", self.owner[f])
                       for f, p in enumerate(self.places)]
        self.attention = (self if ep == sp == 1 else _AttentionGrid(self))
        # K1 / K2 launches each rank made (the wrappers' counts, split by
        # the rank that called them; sp and ep index 0 attend).
        self.launches = [0] * self.n
        # Cache writes whose copies live in other processes, queued by
        # the step and exchanged at its end (models/llama._exchange_writes).
        self.pending_writes: List[tuple] = []
        if self.spans:
            # Every process group a collective of this grid names, made
            # in the same order on every process.
            sets = [g.procs for row in self.tps for g in row]
            self.fabric.prepare(sets + [self.fabric.world])

    @classmethod
    def for_mesh(cls, mesh: MeshConfig, primary: torch.device,
                 dp_attention: bool = False,
                 dp_local: bool = False, fabric=None) -> "DpGrid":
        """The grid of a mesh's dp, sp, ep and tp axes (tp alone: dp 1):
        rank 0 on `primary`, the engine's device, the ranks spread over
        the visible cards, shared round-robin where there are fewer.
        Spanning `fabric`'s processes, every rank of this process lies on
        `primary`."""
        n = mesh.dp * mesh.sp * mesh.ep * mesh.tp
        devices = (default_rank_devices(n, torch.device(primary))
                   if fabric is None or not fabric.spans
                   else [torch.device(primary)] * n)
        return cls(devices, mesh.dp, dp_attention, dp_local, ep=mesh.ep,
                   sp=mesh.sp, fabric=fabric)

    def flat(self, d: int, e: int, t: int, s: int = 0) -> int:
        """The flat rank of (dp row d, sp index s, ep index e, tp slice
        t)."""
        return ((d * self.sp + s) * self.ep + e) * self.tp + t

    def coords(self, f: int) -> Tuple[int, int, int, int]:
        """(d, s, e, t) of flat rank f."""
        rest, t = divmod(f, self.tp)
        rest, e = divmod(rest, self.ep)
        d, s = divmod(rest, self.sp)
        return d, s, e, t

    @property
    def mode(self) -> str:
        return ("dp_local" if self.dp_local else
                "dp_attention" if self.dp_attention else "dp")

    def describe(self) -> List[str]:
        """The rank -> device map, as strings."""
        return [str(d) for d in self.devices]

    def holders(self, t: int) -> List[int]:
        """One flat rank per distinct copy of tp slice t among the ranks
        that attend (sp and ep index 0), dp row 0's first."""
        seen: Dict[object, int] = {}
        for d in range(self.dp):
            f = self.flat(d, 0, t)
            seen.setdefault(self.places[f], d * self.tp + t)
        return list(seen.values())

    def _group_of(self, f: int) -> Tuple[TpGroup, int]:
        """(the TpGroup holding flat rank f, f's index in it)."""
        d, s, e, t = self.coords(f)
        return (self.sp_tps[d][s] if s else self.tps[d][e]), t

    def on(self, f: int):
        """Context: flat rank f's device and stream are current."""
        g, t = self._group_of(f)
        return g.on(t)

    def row_states(self, states: Sequence, d: int, s: int = 0) -> List:
        """Row d's per-rank items of sp index s and ep index 0, in tp
        order."""
        return [states[self.flat(d, 0, t, s)] for t in range(self.tp)]

    def _groups(self, sp: bool = False):
        groups = [g for row in self.tps for g in row]
        if sp:
            groups += [g for row in self.sp_tps for g in row[1:]]
        return groups

    def fork(self, sp: bool = False) -> None:
        """Every rank's stream waits for the caller's work (`sp`: the
        ranks of sp index s > 0 too, which only the ring prefill runs)."""
        for g in self._groups(sp):
            g.fork()

    def join(self, sp: bool = False) -> None:
        for g in self._groups(sp):
            g.join()

    def home(self, f: int, x: torch.Tensor) -> torch.Tensor:
        """Tensor `x`, made on flat rank f's stream, for the caller's
        stream on rank 0's card."""
        g, t = self._group_of(f)
        s = g.streams[t]
        if not self.cuda or s is None:
            return x
        main = torch.cuda.current_stream(self.devices[0])
        if g.devices[t] == self.devices[0]:
            main.wait_event(g._mark(t))
            x.record_stream(main)
            return x
        with torch.cuda.stream(s):
            return x.to(self.devices[0], non_blocking=True)

    def gather_rows(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Row d's `parts[d]` (on its rank 0) concatenated along dim 0 on
        the caller's stream.  Spanning processes: `parts[d]` lies on row
        d's lead rank (None where this process has no rank of row d);
        each row crosses from the first process that holds it, and every
        process gets the whole."""
        if not self.spans:
            moved = [self.home(self.flat(d, 0, 0), p)
                     for d, p in enumerate(parts)]
            return moved[0] if len(moved) == 1 else torch.cat(moved, dim=0)
        moved = [None if p is None else self.home(
                     self.flat(d, 0, self.rows[d].lead), p)
                 for d, p in enumerate(parts)]
        held = [min(g.procs) for g in self.rows]
        if any(p is None for p in moved):
            me = self.fabric.process_id
            like = next(p for p in moved if p is not None)
            per = [[d for d in range(self.dp) if held[d] == q]
                   for q in self.fabric.world]
            top = max(len(r) for r in per)
            mine = [moved[d] for d in per[me]]
            mine += [torch.zeros_like(like)] * (top - len(mine))
            got = self.fabric.gather(torch.stack(mine), self.fabric.world)
            moved = [got[held[d]][per[held[d]].index(d)]
                     for d in range(self.dp)]
        return moved[0] if len(moved) == 1 else torch.cat(moved, dim=0)

    def sum_world(self, x: torch.Tensor) -> torch.Tensor:
        """This process's `x` (on the caller's stream) summed with every
        other process's, in process order (integer counts: exact in any
        order)."""
        if not self.spans:
            return x
        return torch.stack(self.fabric.gather(x, self.fabric.world)).sum(0)

    def write_targets(self, f: int) -> List[int]:
        """The attention ranks holding a copy that rank f's cache writes
        land in: its tp slice's copies (plain dp), every copy of every
        slot shard (dp-attention), its own shard (dp-local)."""
        grid = self.attention
        if grid.dp_local:
            return [f]
        if grid.dp_attention:
            return [h for t in range(grid.tp) for h in grid.holders(t)]
        return grid.holders(f % grid.tp)

    def writes_cross(self, f: int) -> bool:
        """True when some copy rank f writes lives in another process."""
        return self.spans and any(not self.mine[h]
                                  for h in self.write_targets(f))


def _check_spanning(grid: "DpGrid", fabric) -> None:
    """What a process-spanning grid runs: its ranks split evenly over the
    processes, each tp group within one process or over whole processes'
    shares, and neither an ep nor an sp axis (the all-to-all and the
    ring hop between processes wait for ROADMAP.md A7.6).  Non-local
    dp-attention reads a row's pages from every slot shard of its row,
    so a row must lie in one process."""
    N = fabric.num_processes
    if grid.n % N:
        raise ValueError(f"the grid's {grid.n} ranks must split evenly over "
                         f"{N} processes")
    k = grid.n // N
    if grid.ep > 1:
        raise ValueError(
            f"ep={grid.ep} across {N} processes (the all-to-all between "
            "processes) waits for ROADMAP.md A7.6; run ep within one "
            "process")
    if grid.sp > 1:
        raise ValueError(
            f"sp={grid.sp} across {N} processes (the ring hop between "
            "processes) waits for ROADMAP.md A7.6; run sp within one "
            "process")
    if fabric.rig is not None and k != fabric.rig:
        raise ValueError(f"the grid's {grid.n} ranks give each of {N} "
                         f"processes {k}, not the CPU rig's {fabric.rig}")
    if k % grid.tp and grid.tp % k:
        raise ValueError(f"tp={grid.tp} must divide or be a multiple of the "
                         f"{k} ranks a process")
    if grid.dp_attention and not grid.dp_local and grid.tp > k:
        raise ValueError(
            f"dp_attention over a tp={grid.tp} row wider than a process's "
            f"{k} ranks reads pages across processes on the gather path; "
            "set dp_attention_local or keep each dp row in one process")


class _AttentionGrid:
    """The (dp, tp) grid of a DpGrid's ranks of sp and ep index 0: what
    the KV cache is laid out over (kv_cache.init_grid_caches and its
    routes take it), flat index `d * tp + t`."""

    def __init__(self, grid: DpGrid):
        ranks = [grid.flat(d, 0, t) for d in range(grid.dp)
                 for t in range(grid.tp)]
        self.devices = [grid.devices[f] for f in ranks]
        self.places = [grid.places[f] for f in ranks]
        self.n, self.dp, self.tp = len(ranks), grid.dp, grid.tp
        self.dp_attention, self.dp_local = grid.dp_attention, grid.dp_local
        self.mode, self.holders = grid.mode, grid.holders
        self.attention = self


class PpStages(TpGroup):
    """The pipeline's S stage ranks on a list of devices (the module
    docstring), and the GPipe microbatch count M of the steps built on
    them.  The streams and the ordered hand-over are a TpGroup's: stage
    0 on the caller's current stream, stages 1.. on their own.

    `places` names where each stage's copies live (default: its device):
    stages of one place share one copy of a piece two stages hold (the
    embedding table of a tied-embedding model, read by stage 0's lookup
    and the last stage's head).  `launches[s]` counts the K1 / K2
    launches stage s made."""

    def __init__(self, devices: Sequence, microbatches: int = 2,
                 places: Optional[Sequence] = None):
        super().__init__(devices)
        self.pp = self.tp
        if microbatches < 1:
            raise ValueError(f"pp microbatches={microbatches} must be at "
                             "least 1")
        self.microbatches = microbatches
        self.places = list(places) if places is not None else list(
            self.devices)
        if len(self.places) != self.pp:
            raise ValueError(f"{len(self.places)} places for {self.pp} "
                             "stages")
        self.launches = [0] * self.pp

    @classmethod
    def for_mesh(cls, mesh: MeshConfig, primary: torch.device,
                 microbatches: int = 2) -> "PpStages":
        """The stages of a mesh's pp axis: stage 0 on `primary`, the
        engine's device, the stages spread over the visible cards,
        shared round-robin where there are fewer."""
        return cls(default_rank_devices(mesh.pp, torch.device(primary)),
                   microbatches)

    def send(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Stage s's activation `x`, for stage s + 1's stream: an event
        wait and `record_stream` on one card, a peer copy after the
        event across cards."""
        return self._move(s + 1, s, x)

    def home(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Stage s's output `x`, for the caller's stream on stage 0's
        card."""
        return self._move(0, s, x)


def _to_device(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_device(v, device) for v in x]
    return x.to(device)
