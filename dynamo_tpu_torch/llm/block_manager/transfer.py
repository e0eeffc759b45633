"""Cross-worker KV-block transfer over the RPC plane, host-staged (port of
`dynamo_tpu/llm/block_manager/transfer.py`).

A worker serves the `kv_blocks` endpoint; peers pull blocks by chained
hash.  The worker's instance record (its RPC address) is the transfer
descriptor: hash-addressed blocks need no per-block metadata.

Wire format (one RPC delta per block), field for field JAX's:
    request:  {"hashes": [int, ...], "batch": int}
    delta:    {"hash": int, "data": bytes, "dtype": str, "shape": [int]}

A block is a torch tensor here (bf16 is a dtype numpy cannot hold): its
bytes are the C-order bytes JAX's numpy block carries, and `dtype` is
`"bfloat16"`, `"int8"` (the packed block of an int8 cache, scales in its
trailing bytes) or another torch dtype's name.  dtype and shape make a
kv-quant mismatch between peers visible at the destination, whose
inject refuses the block (`EngineCore._validate_block`).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Tuple

import torch

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.tokens import compute_block_hashes

logger = logging.getLogger(__name__)

KV_BLOCKS_ENDPOINT = "kv_blocks"

# Blocks in one batch, on both planes: a host-staged export batch or a
# device offer/pull round.  Each batch is ONE engine-thread command and
# one burst of wire frames, so a long prefix neither holds the engine
# thread in one export nor materialises every block before the first
# frame streams out.
BATCH_BLOCKS = 8
# Pull batches in flight per pull: double-buffered, batch N+1 pulls
# while batch N injects.
PULL_INFLIGHT = 2

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "int8": torch.int8,
           "uint8": torch.uint8}


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's name, as JAX sends it)."""
    return str(dtype).removeprefix("torch.")


def wire_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported KV block dtype {name!r}")
    return _DTYPES[name]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def encode_block(block_hash: int, data: torch.Tensor) -> dict:
    data = data.detach().cpu().contiguous()
    return {
        "hash": block_hash,
        "data": data.view(torch.uint8).numpy().tobytes(),
        "dtype": dtype_name(data.dtype),
        "shape": list(data.shape),
    }


def decode_block(msg: dict) -> Tuple[int, torch.Tensor]:
    raw = bytearray(msg["data"])
    dtype = wire_dtype(msg["dtype"])
    if not raw:
        return msg["hash"], torch.empty(msg["shape"], dtype=dtype)
    arr = torch.frombuffer(raw, dtype=dtype)
    return msg["hash"], arr.reshape(msg["shape"])


def make_kv_blocks_handler(engine):
    """RPC handler streaming resident blocks by hash; register it on the
    worker's RpcServer under KV_BLOCKS_ENDPOINT.  `engine` is an
    InferenceEngine (async export on the engine thread).

    Blocks stream in bounded batches, in request order, and the stream
    STOPS at the first missing hash: a gap breaks the hash chain, so
    nothing past it is injectable as a contiguous prefix."""

    async def handler(payload: dict):
        hashes = payload.get("hashes", [])
        batch = max(1, int(payload.get("batch", BATCH_BLOCKS)))
        for i in range(0, len(hashes), batch):
            chunk = hashes[i:i + batch]
            blocks = await engine.export_blocks(chunk)
            for h in chunk:          # request order, for streaming
                data = blocks.get(h)
                if data is None:
                    return           # hash-chain gap: stop the stream
                yield encode_block(h, data)

    return handler


async def fetch_blocks(rpc_client, hashes: Iterable[int], *,
                       batch: int = BATCH_BLOCKS,
                       ) -> Dict[int, torch.Tensor]:
    """Pull blocks from a peer, in request order; hashes from the first
    gap on are absent from the result (the caller prefills them).  An
    out-of-order delivery aborts the call."""
    hashes = list(hashes)
    if not hashes:
        return {}
    out: Dict[int, torch.Tensor] = {}
    idx = 0
    async for msg in rpc_client.call(KV_BLOCKS_ENDPOINT,
                                     {"hashes": hashes, "batch": batch}):
        h, arr = decode_block(msg)
        if idx >= len(hashes) or h != hashes[idx]:
            break  # closing the generator sends the RPC cancel frame
        out[h] = arr
        idx += 1
    return out


def sealed_hashes(prompt_tokens: List[int], block_size: int) -> List[int]:
    """Chained hashes of the prompt's sealed (full) blocks — the shared
    addressing step of both transfer planes."""
    n_sealed = len(prompt_tokens) // block_size
    if n_sealed == 0:
        return []
    return list(compute_block_hashes(
        prompt_tokens[: n_sealed * block_size], block_size))


async def resident_blocks(engine, hashes) -> int:
    """Contiguous locally resident prefix of `hashes`; 0 when the engine
    cannot say (the conservative answer for coverage accounting)."""
    fn = getattr(engine, "resident_prefix_blocks", None)
    if fn is None:
        return 0
    try:
        return int(await fn(hashes))
    except Exception:
        logger.exception("resident_prefix_blocks failed; counting 0")
        return 0


async def inject_run(engine, hashes: List[int], run: Dict[int, object],
                     frontier: int, end: int) -> Tuple[int, bool]:
    """Inject the contiguous run [frontier, end) and return the new
    honest frontier as (frontier, stalled): when the pool refuses part of
    the run (pinned full, or a concurrent request raced the same blocks
    in), the frontier advances only to what is actually resident — the
    one short-inject discipline every pull pipeline shares."""
    if not run:
        return frontier, False
    injected = await engine.import_blocks(run)
    if injected == len(run):
        return end, False
    resident = await resident_blocks(engine, hashes)
    new_frontier = max(frontier, min(end, resident))
    return new_frontier, new_frontier < end


def contiguous_prefix(hashes: List[int], blocks: Dict[int, torch.Tensor]
                      ) -> Dict[int, torch.Tensor]:
    """The longest fetched prefix with no gaps: injecting past a gap
    would register unreachable blocks."""
    out: Dict[int, torch.Tensor] = {}
    for h in hashes:
        if h not in blocks:
            break
        out[h] = blocks[h]
    return out


async def pull_prefix(engine, rpc_client, prompt_tokens: List[int],
                      block_size: int, covered_tokens: int = 0) -> int:
    """Fetch and inject every sealed prompt block a peer holds; returns
    the tokens now covered locally (the decode-side onboard of
    disaggregated P/D).  `covered_tokens`: a block-aligned prefix already
    resident here, not fetched again."""
    hashes = sealed_hashes(prompt_tokens, block_size)
    want = hashes[covered_tokens // block_size:]
    if not want:
        return covered_tokens
    # `with` makes the span task-current: the rpc.client spans of the
    # fetch nest under the pull, not beside it.
    with tracing.get_tracer().start_span(
            "kv.pull_prefix",
            attrs={"blocks_wanted": len(want),
                   "block_size": block_size}) as span:
        blocks = await fetch_blocks(rpc_client, want)
        contiguous = contiguous_prefix(want, blocks)
        span.set_attr(
            blocks_fetched=len(blocks), blocks_injected=len(contiguous),
            bytes=sum(nbytes(a) for a in contiguous.values()))
        if not contiguous:
            return covered_tokens
        await engine.import_blocks(contiguous)
    return covered_tokens + len(contiguous) * block_size
