"""Multi-process lockstep: one engine over N worker processes (port of
`dynamo_tpu/parallel/multihost.py`).

JAX's design, kept: every process builds an IDENTICAL `EngineCore` (same
config, same seed, same weights) over one rank grid that spans all of
them.  Process 0 leads: it runs the serving stack (control plane, RPC,
scheduler) and, before it runs an engine-thread mutation itself,
broadcasts it over a TCP lockstep channel (`LockstepLeader`): add,
cancel, step, import, export, clear, stop.  The followers replay the
same calls in the same order (`run_follower`).  The scheduler and the
allocator are deterministic host state machines, so every process derives
the same sequence of steps; every host read comes off an output each
process holds whole, so nothing flows back from a follower.

What the port does in place of JAX's global mesh:

- **The grid.**  The engine's (dp, tp) rank grid (parallel/mesh.DpGrid)
  spans the processes process-major: process p owns flat ranks
  `[p * k, (p + 1) * k)`, k = grid size / N (JAX's global device order).
  A process computes only on its own ranks; the others are placeholders
  on the `meta` device (their shapes, no storage).  Within a process the
  ranks order one another by streams and events, as in one process; a
  collective that has a rank in another process goes through
  `torch.distributed` (`Fabric`), which every process that holds a rank
  of it joins in the same order.  The sums keep the one-process grid's
  order (gathered partials, summed in rank order), so a process-spanning
  grid computes bit for bit what the one-process grid computes.
- **The backend.**  `initialize` picks it once: `nccl` when every
  process's ranks sit on a card no other process uses, `gloo` when
  processes share a card or on the CPU (NCCL refuses two ranks of one
  communicator on one card).  Gloo moves a CUDA tensor through the host:
  each gloo collective syncs the stream.  Nothing switches backend after
  a failure, and every collective carries the process group's timeout
  (`COLLECTIVE_TIMEOUT_S`), so a process that misses one raises instead
  of hanging.
- **Host reads.**  `fetch` reads a tensor every process holds whole and
  checks, by one small collective, that every process read the same
  bytes: a follower that diverged fails loudly.
- **Frames.**  JAX's `>I` length frame, its body in the port's own
  `struct` codec (runtime/rpc.packb) in place of msgpack, which the card
  machine lacks; the decoded objects are msgpack's.  Blocks ride as
  `{hash: [bytes, dtype, shape]}`, the transfer plane's wire encoding
  (llm/block_manager/transfer.encode_block), which carries bf16.

CPU test rig: `setup_cpu_rig(n)` gives this process n CPU ranks, and the
processes' collectives run over gloo (tests/test_torch_multihost.py).
"""

from __future__ import annotations

import datetime
import logging
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.runtime import contracts
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.rpc import packb, unpackb

logger = logging.getLogger(__name__)

# Every collective's deadline: a process that does not join within it
# raises (the peer's own error, or gloo's timeout) rather than hanging.
COLLECTIVE_TIMEOUT_S = 120.0
# How long `initialize` waits for every process to reach the store.
JOIN_TIMEOUT_S = 300.0

_CPU_RIG: Optional[int] = None


class LockstepDiverged(RuntimeError):
    """The processes of a lockstep engine read different values."""


# ---------------------------------------------------------------------------
# process bootstrap


def setup_cpu_rig(ranks_per_process: int) -> None:
    """This process owns `ranks_per_process` CPU ranks of the grid and
    its collectives run over gloo (JAX's virtual CPU devices): the next
    `initialize` takes the CPU, and a grid it spans must give each
    process exactly that many ranks."""
    global _CPU_RIG
    if ranks_per_process < 1:
        raise ValueError("a CPU rig needs at least one rank a process")
    _CPU_RIG = ranks_per_process


def _card_id(device: torch.device) -> str:
    """What names this process's card among the processes: the card's
    UUID (two processes on one card read the same), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    props = torch.cuda.get_device_properties(idx)
    return str(getattr(props, "uuid", f"{socket.gethostname()}:{idx}"))


def pick_backend(cards: Sequence[str]) -> str:
    """THE backend rule: nccl when every process's ranks sit on a card no
    other process uses, gloo when processes share a card or any runs on
    the CPU."""
    if any(c == "cpu" for c in cards) or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


@dataclass
class Fabric:
    """This process's place among the N processes of one engine, and the
    collectives between them (`torch.distributed`, one process group per
    set of processes that share a rank group)."""

    process_id: int
    num_processes: int
    backend: str
    device: torch.device
    # The CPU rig's ranks a process (`setup_cpu_rig`), or None.
    rig: Optional[int] = None

    def __post_init__(self):
        self._groups: Dict[Tuple[int, ...], object] = {}
        # Cross-process collectives issued, bytes this process sent and
        # host seconds spent inside them, waits for the peers included
        # (the lockstep block of /debug/stats).
        self.collectives = 0
        self.bytes_sent = 0
        self.seconds = 0.0

    @property
    def spans(self) -> bool:
        return self.num_processes > 1

    @property
    def world(self) -> Tuple[int, ...]:
        return tuple(range(self.num_processes))

    def owner(self, f: int, n: int) -> int:
        """The process owning flat rank f of an n-rank grid
        (process-major)."""
        return f // (n // self.num_processes)

    def prepare(self, sets: Sequence[Tuple[int, ...]]) -> None:
        """Make the process groups of `sets` (each a sorted tuple of
        process ids).  Every process must call this with the same list:
        `new_group` is a collective of the whole world."""
        import torch.distributed as dist

        for s in sets:
            s = tuple(s)
            if len(s) < 2 or s in self._groups:
                continue
            self._groups[s] = (None if s == self.world else dist.new_group(
                list(s), backend=self.backend, timeout=datetime.timedelta(
                    seconds=COLLECTIVE_TIMEOUT_S)))

    def _group(self, procs: Tuple[int, ...]):
        if procs not in self._groups:
            raise RuntimeError(f"no process group for {procs}: "
                               "Fabric.prepare was not called for it")
        return self._groups[procs]

    def gather(self, t: torch.Tensor, procs: Tuple[int, ...]
               ) -> List[torch.Tensor]:
        """Every member of `procs`'s `t` (one shape and dtype on all of
        them), in process order, on `t`'s device and the current stream.
        Gloo stages a CUDA tensor through the host (a stream sync)."""
        import torch.distributed as dist

        if len(procs) == 1:
            return [t]
        g = self._group(procs)
        t0 = time.perf_counter()
        self.collectives += 1
        self.bytes_sent += t.numel() * t.element_size()
        t = t.detach().contiguous()
        if self.backend == "nccl":
            out = torch.empty((len(procs),) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=g)
            got = list(out.unbind(0))
        else:
            raw = t.cpu().reshape(-1).view(torch.uint8)
            outs = [torch.empty_like(raw) for _ in procs]
            dist.all_gather(outs, raw, group=g)
            me = procs.index(self.process_id)
            got = [t if i == me else o.view(t.dtype).reshape(t.shape).to(
                       t.device) for i, o in enumerate(outs)]
        self.seconds += time.perf_counter() - t0
        return got

    def gather_bytes(self, raw: torch.Tensor, procs: Tuple[int, ...]
                     ) -> List[torch.Tensor]:
        """`gather` of a 1-D uint8 tensor whose length differs between the
        members: the lengths first, then the bytes padded to the
        longest."""
        if len(procs) == 1:
            return [raw]
        n = torch.tensor([raw.numel()], dtype=torch.int64, device=raw.device)
        sizes = [int(s) for s in torch.cat(self.gather(n, procs)).tolist()]
        top = max(sizes)
        pad = torch.zeros((top,), dtype=torch.uint8, device=raw.device)
        pad[:raw.numel()] = raw
        return [o[:s] for o, s in zip(self.gather(pad, procs), sizes)]

    def describe(self) -> dict:
        return {"backend": self.backend, "process_id": self.process_id,
                "num_processes": self.num_processes,
                "collectives": self.collectives,
                "bytes_sent": self.bytes_sent,
                "collective_s": self.seconds}


def initialize(coordinator: str, num_processes: int, process_id: int,
               device) -> Fabric:
    """Join the processes of one engine: a TCP store at `coordinator`
    (HOST:PORT; process 0 serves it), the backend decided once by
    `pick_backend` from every process's card, then
    `torch.distributed.init_process_group` on that store.  Returns this
    process's Fabric; the backend is logged."""
    import torch.distributed as dist

    device = torch.device(_CPU_RIG and "cpu" or device)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside "
                         f"[0, {num_processes})")
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
                          wait_for_workers=False)
    store.set(f"card/{process_id}", _card_id(device))
    cards = [store.get(f"card/{p}").decode() for p in range(num_processes)]
    backend = pick_backend(cards)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=store, rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    fabric = Fabric(process_id, num_processes, backend, device,
                    rig=_CPU_RIG)
    shared = "one card shared" if backend == "gloo" and cards[0] != "cpu" \
        else "a card each" if backend == "nccl" else "cpu"
    logger.info("multihost: process %d/%d joined via %s, backend %s (%s)",
                process_id, num_processes, coordinator, backend, shared)
    return fabric


def shutdown() -> None:
    """Leave the process group (at exit; idempotent)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def grid_spans_processes(grid) -> bool:
    """True when the grid's ranks live in more than one process: the
    signal for every multihost-aware path (JAX's
    `mesh_spans_processes`)."""
    fabric = getattr(grid, "fabric", None)
    return fabric is not None and fabric.spans


def fetch(t: torch.Tensor, fabric: Optional[Fabric] = None) -> np.ndarray:
    """Device -> host read under any topology: the tensor is whole on
    every process, so each reads its own copy; under a process-spanning
    grid every process then joins one check that all read the same bytes
    (`LockstepDiverged` otherwise)."""
    return agree(t.detach().cpu().numpy(), fabric)


def agree(host: np.ndarray, fabric: Optional[Fabric]) -> np.ndarray:
    """`host`, after every process of `fabric` checked that it read the
    same bytes (one small collective; `LockstepDiverged` otherwise)."""
    if fabric is None or not fabric.spans:
        return host
    digest = zlib.crc32(np.ascontiguousarray(host).view(np.uint8).tobytes())
    mine = torch.tensor([digest, host.size], dtype=torch.int64,
                        device=fabric.device if fabric.backend == "nccl"
                        else "cpu")
    seen = [tuple(x.tolist()) for x in fabric.gather(mine, fabric.world)]
    if len(set(seen)) > 1:
        raise LockstepDiverged(
            f"lockstep: the processes read different values "
            f"(crc32, size by process: {seen}); a follower diverged")
    return host


# ---------------------------------------------------------------------------
# lockstep command channel (leader -> followers)

_FRAME = struct.Struct(">I")


class LockstepLeader:
    """TCP fan-out of engine commands to the follower processes.  A
    command is a dict in the port's codec; order per connection is the
    protocol's one guarantee, and the one lockstep needs.  Sends happen on
    the engine thread: a frame is small (ids and token lists) next to a
    device step."""

    def __init__(self, port: int = 0, num_followers: int = 0,
                 host: str = "0.0.0.0"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self.num_followers = num_followers
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        # Broadcasts sent, by op (the lockstep block of /debug/stats).
        self.sent: Dict[str, int] = {}

    @never_engine_thread
    def wait_for_followers(self, timeout: float = 120.0) -> None:
        """Accept every follower (a start-up thread's job: the engine
        thread must never park here)."""
        self._srv.settimeout(timeout)
        while len(self._conns) < self.num_followers:
            conn, addr = self._srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            logger.info("lockstep: follower %d/%d connected from %s",
                        len(self._conns), self.num_followers, addr)

    def broadcast(self, cmd: dict) -> None:
        blob = packb(cmd)
        frame = _FRAME.pack(len(blob)) + blob
        with self._lock:
            for c in self._conns:
                c.sendall(frame)
            self.sent[cmd["op"]] = self.sent.get(cmd["op"], 0) + 1

    @property
    def broadcasts(self) -> int:
        return sum(self.sent.values())

    def close(self) -> None:
        try:
            self.broadcast({"op": "stop"})
        except OSError as e:
            # Followers that never hear "stop" exit on the socket's close.
            logger.warning("lockstep stop broadcast failed (followers "
                           "exit on the socket's close): %s", e)
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()


class LockstepFollower:
    """A follower's end of the channel: connects, retrying until the
    leader listens or `timeout` passes (ranks start in any order)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=5.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._buf = b""
        # Ops replayed, by op (the follower's lockstep stats).
        self.replayed: Dict[str, int] = {}

    def recv(self) -> dict:
        while len(self._buf) < _FRAME.size:
            self._more()
        (n,) = _FRAME.unpack(self._buf[:_FRAME.size])
        while len(self._buf) < _FRAME.size + n:
            self._more()
        blob = self._buf[_FRAME.size:_FRAME.size + n]
        self._buf = self._buf[_FRAME.size + n:]
        return unpackb(blob)

    def _more(self) -> None:
        chunk = self._sock.recv(1 << 16)
        if not chunk:
            raise ConnectionError("lockstep leader closed the channel")
        self._buf += chunk

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# follower replay loop


def encode_sampling(s) -> dict:
    return {"temperature": s.temperature, "top_k": s.top_k,
            "top_p": s.top_p, "max_tokens": s.max_tokens,
            "stop_token_ids": list(s.stop_token_ids), "seed": s.seed,
            "logprobs": s.logprobs,
            "seed_offset": getattr(s, "seed_offset", 0)}


def _decode_sampling(d: dict):
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    return SamplingParams(
        temperature=d["temperature"], top_k=d["top_k"], top_p=d["top_p"],
        max_tokens=d["max_tokens"],
        stop_token_ids=tuple(d["stop_token_ids"]),
        seed=d["seed"], logprobs=d["logprobs"],
        seed_offset=d.get("seed_offset", 0))


def encode_blocks(blocks: dict) -> dict:
    """{hash: tensor} -> {str(hash): [bytes, dtype, shape]}, the transfer
    plane's wire encoding (bf16 included)."""
    from dynamo_tpu_torch.llm.block_manager.transfer import encode_block

    out = {}
    for h, a in blocks.items():
        e = encode_block(int(h), torch.as_tensor(a))
        out[str(h)] = [e["data"], e["dtype"], e["shape"]]
    return out


def decode_blocks(wire: dict) -> Dict[int, torch.Tensor]:
    from dynamo_tpu_torch.llm.block_manager.transfer import decode_block

    return {int(h): decode_block({"hash": int(h), "data": raw, "dtype": dt,
                                  "shape": shape})[1]
            for h, (raw, dt, shape) in wire.items()}


def run_follower(core, chan: LockstepFollower,
                 stop_event: Optional[threading.Event] = None) -> None:
    """Replay the leader's command stream on a shadow EngineCore until the
    leader stops.  The replay thread registers as this process's engine
    thread: it drives step() and add_request, as the leader's loop does."""
    contracts.register_engine_thread()
    try:
        _follower_loop(core, chan, stop_event)
    finally:
        contracts.unregister_engine_thread()


def _follower_loop(core, chan: LockstepFollower,
                   stop_event: Optional[threading.Event]) -> None:
    while stop_event is None or not stop_event.is_set():
        cmd = chan.recv()
        op = cmd["op"]
        chan.replayed[op] = chan.replayed.get(op, 0) + 1
        if op == "stop":
            logger.info("lockstep: leader closed; follower exiting")
            return
        elif op == "step":
            core.step()
        elif op == "add":
            try:
                core.add_request(cmd["rid"], cmd["prompt"],
                                 _decode_sampling(cmd["sampling"]),
                                 priority=cmd.get("priority", 1))
            except ValueError:
                logger.warning("follower: rejected add %s (mirrors the "
                               "leader's rejection)", cmd["rid"])
        elif op == "cancel":
            core.cancel(cmd["rid"])
        elif op == "import":
            core.import_blocks(decode_blocks(cmd["blocks"]))
        elif op == "export":
            # Join the leader's extract (its gathers across processes);
            # the host copy lands leader-side.
            core.export_blocks([int(h) for h in cmd["hashes"]])
        elif op == "clear":
            core.clear_prefix_cache()
        else:
            raise ValueError(f"unknown lockstep op {op!r}")
