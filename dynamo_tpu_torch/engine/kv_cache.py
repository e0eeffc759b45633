"""Paged KV cache as preallocated tensors (port of
`dynamo_tpu/engine/kv_cache.py`), with the whole-block extract and inject
of the KV data plane.

Same layout as the JAX package:

- storage is per-layer K and V buffers `[S = num_blocks * block_size,
  F = num_kv_heads * head_dim]` — a flat slot axis by a flat, head-major
  feature axis, which is exactly the view the CUDA attention kernels
  read (one page of one kv head is `block_size` rows of a `D`-wide
  column band);
- block 0 is the null block: unallocated block-table entries and pad
  positions resolve into it, and its contents are never read unmasked.

Unlike JAX, the port updates the buffers in place (`index_copy_`): the
cache is the largest allocation of the process and a functional update
would double it.

Quantized mode (`kv_quant="int8"`): K/V buffers hold int8 with
per-token, per-head f32 scales in sibling `[S, Hkv]` buffers (`k_scale` /
`v_scale` in the cache dict; their presence is the mode bit).  Scales are
per token so a decode write stays a row scatter.  The bytes one decode
step reads per context token drop from `2 * F * 2` to `2 * (F + 4 * Hkv)`.
Quantization gives the same bytes as the JAX package's: `scale =
max(amax, 1e-8) / 127` and `q = clip(round(x / scale), -127, 127)` in
f32, a true division and round-half-to-even.

The wire block — the unit every block transfer moves — is JAX's
`make_block_ops` block byte for byte: `[2, L, bs, F]` at the cache dtype
(K stacked on V), or, for an int8 cache, the packed `[2, L, bs, F +
4 * Hkv]` int8 block whose trailing bytes are the page's `[bs, Hkv]` f32
scales bitcast (little-endian) so pages and scales move as one array.
`extract_blocks` / `inject_blocks` move a batch of pages with one
`index_select` / `index_copy_` per layer and per K/V (the reference does
this job with its `block_copy.cu` kernel; in JAX it is XLA slicing, not
a Pallas kernel).

A sharded engine's cache (parallel/mesh.DpGrid) is a list of per-rank
caches (`init_grid_caches`), laid out as JAX's `cache_pspecs`.  Under
tp, and plain dp, it is `P(None, "tp")`: rank r holds the head-major
column band `[S, F/tp]` of every layer of tp slice r % tp (and an int8
cache's scales `[S, Hkv/tp]` ride their heads), one copy per (card, tp
slice) shared by the dp ranks there; block tables and slots are shared.
dp-attention shards the SLOT axis over tp (shard t holds slots `[t *
S/tp, (t + 1) * S/tp)` at full width, one copy per card); dp-local
shards the slots over the flat grid.  A slot shard is backed by one junk
row past its end: a write's route (`write_routes`) sends the rows whose
slot lies outside the shard there (JAX drops them), so a pad write never
lands on a shard's first page, which unlike shard 0's is a real one.  A
read's route (`read_routes`, `gather_routed`) takes each slot from the
shard that holds it, one masked gather per shard.  A route is computed
once a step and serves every layer.  `extract_blocks` / `inject_blocks`
join and split a row's column bands, and `extract_grid_blocks` /
`inject_grid_blocks` route each page to its shard (and each write to
every copy), so the wire block stays the unsharded cache's: a tp 2, a
dp 2 and a tp 1 worker exchange the same bytes.

A pipeline's cache (parallel/mesh.PpStages, parallel/pipeline.py) is
stage-owned: a list of per-stage caches (`init_stage_caches`), stage s
holding the `init_cache` of its own L/S layers on its own device, JAX's
`pp_cache_pspecs` (the stacked layer axis over pp) as a list.
`extract_stage_blocks` gathers each stage's layers onto the caller's
card and joins them on the layer axis, `inject_stage_blocks` splits a
block's layers back over the stages, so a pp worker moves JAX's wire
block `[2, L, bs, F]` (or the packed int8 one) byte for byte with
meshless, tp and dp peers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import torch

from dynamo_tpu_torch.models.config import ModelConfig

# Block-table entries for never-allocated pages point at the null block.
NULL_BLOCK = 0


@dataclass(frozen=True)
class KvCacheConfig:
    """Geometry of the paged cache."""

    num_blocks: int          # includes the reserved null block 0
    block_size: int          # tokens per block
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16
    # "none" = store K/V at `dtype`; "int8" = int8 pages + per-token
    # per-head f32 scales (see module docstring).
    kv_quant: str = "none"

    def __post_init__(self):
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', "
                             f"got {self.kv_quant!r}")

    @property
    def quantized(self) -> bool:
        return self.kv_quant == "int8"

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def feature_dim(self) -> int:
        """Flat per-token K (or V) width: num_kv_heads * head_dim."""
        return self.num_kv_heads * self.head_dim

    @property
    def store_dtype(self) -> torch.dtype:
        """Dtype of the K/V page buffers as stored on the device."""
        return torch.int8 if self.quantized else self.dtype

    @property
    def bytes_per_context_token(self) -> int:
        """K+V bytes one decode step reads per context token, across all
        layers, scales included."""
        if self.quantized:
            per = self.feature_dim + 4 * self.num_kv_heads
        else:
            per = self.feature_dim * self.dtype.itemsize
        return 2 * self.num_layers * per

    @property
    def block_wire_shape(self) -> Tuple[int, int, int, int]:
        """Shape of one wire block: [2, L, bs, F], or the packed int8
        [2, L, bs, F + 4 * Hkv] (module docstring)."""
        feat = self.feature_dim
        if self.quantized:
            feat += 4 * self.num_kv_heads
        return (2, self.num_layers, self.block_size, feat)

    @property
    def block_wire_dtype(self) -> torch.dtype:
        return torch.int8 if self.quantized else self.dtype

    @property
    def bytes_per_block(self) -> int:
        """K+V bytes of one block across all layers, scales included."""
        return self.block_size * self.bytes_per_context_token

    @property
    def ring_payload_bytes_per_token(self) -> int:
        """Bytes one token's K+V add to each hop of the sequence-parallel
        ring, summed over the layers (every layer's attention rotates its
        own chunk): the chunk at the compute dtype, or its int8 rows and
        their f32 scales."""
        if self.quantized:
            per = self.feature_dim + 4 * self.num_kv_heads
        else:
            per = self.feature_dim * self.dtype.itemsize
        return 2 * self.num_layers * per

    def for_rank(self, tp: int) -> "KvCacheConfig":
        """The cache one of tp ranks holds: its Hkv / tp heads (tp divides
        Hkv: `parallel.sharding.validate` holds that rule)."""
        return dataclasses.replace(self, num_kv_heads=self.num_kv_heads // tp)

    @staticmethod
    def for_model(config: ModelConfig, num_blocks: int,
                  block_size: int = 64,
                  kv_quant: str = "none") -> "KvCacheConfig":
        return KvCacheConfig(
            num_blocks=num_blocks,
            block_size=block_size,
            num_layers=config.num_layers,
            num_kv_heads=config.num_kv_heads,
            head_dim=config.head_dim,
            dtype=config.dtype,
            kv_quant=kv_quant,
        )


def init_cache(cfg: KvCacheConfig, device: Union[str, torch.device]) -> dict:
    """Allocate {'k': [L x [S, F]], 'v': [L x [S, F]]} zeroed on `device`;
    quantized mode adds {'k_scale': [L x [S, Hkv]], 'v_scale': ...} f32."""
    shape = (cfg.num_slots, cfg.feature_dim)
    cache = {
        "k": [torch.zeros(shape, dtype=cfg.store_dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=cfg.store_dtype, device=device)
              for _ in range(cfg.num_layers)],
    }
    if cfg.quantized:
        sshape = (cfg.num_slots, cfg.num_kv_heads)
        cache["k_scale"] = [torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
                            for _ in range(cfg.num_layers)]
        cache["v_scale"] = [torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
                            for _ in range(cfg.num_layers)]
    return cache


def init_grid_caches(cfg: KvCacheConfig, grid) -> List[dict]:
    """A DpGrid's cache, one dict per rank (shared where ranks share a
    copy): one `init_cache` of `cfg.for_rank(tp)`, a tp column band, on
    each (place, tp slice) for tp and plain dp; slot shards with their
    junk row under dp-attention and dp-local.  The cache is laid out over
    the grid's attention ranks (ep index 0; JAX's cache specs never name
    ep), one dict each."""
    grid = grid.attention
    mine = getattr(grid, "mine", None) or [True] * grid.n
    # Another process's rank: its shapes alone (meta tensors).
    devices = [d if m else torch.device("meta")
               for d, m in zip(grid.devices, mine)]
    if not grid.dp_attention:
        rank = cfg.for_rank(grid.tp)
        per_slice = {}
        out = []
        for f, dev in enumerate(devices):
            key = (grid.places[f], f % grid.tp)
            if key not in per_slice:
                per_slice[key] = init_cache(rank, dev)
            out.append(per_slice[key])
        return out
    shards = grid.n if grid.dp_local else grid.tp
    if cfg.num_blocks % shards:
        raise ValueError(f"num_blocks={cfg.num_blocks} must divide by the "
                         f"{shards} slot shards")
    local = dataclasses.replace(cfg, num_blocks=cfg.num_blocks // shards)
    shared = {}

    def alloc(shape, dtype, device):
        return torch.zeros((shape[0] + 1,) + shape[1:], dtype=dtype,
                           device=device)[:shape[0]]

    out = []
    for f, dev in enumerate(devices):
        s = f if grid.dp_local else f % grid.tp
        key = (grid.places[f], s)
        if key not in shared:
            shape = (local.num_slots, cfg.feature_dim)
            c = {k: [alloc(shape, cfg.store_dtype, dev)
                     for _ in range(cfg.num_layers)] for k in ("k", "v")}
            if cfg.quantized:
                for k in ("k_scale", "v_scale"):
                    c[k] = [alloc((local.num_slots, cfg.num_kv_heads),
                                  torch.float32, dev)
                            for _ in range(cfg.num_layers)]
            shared[key] = c
        out.append(shared[key])
    return out


def init_stage_caches(cfg: KvCacheConfig, stages) -> List[dict]:
    """A pipeline's cache, one dict per stage: the `init_cache` of the
    stage's L/S layers on its device (`stages`: a PpStages)."""
    S = len(stages.devices)
    if cfg.num_layers % S:
        raise ValueError(f"pp={S} must divide num_layers={cfg.num_layers}")
    stage = dataclasses.replace(cfg, num_layers=cfg.num_layers // S)
    return [init_cache(stage, dev) for dev in stages.devices]


def extract_stage_blocks(caches: List[dict], pages: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """`extract_blocks` of a pipeline's cache: each stage's layers read on
    its card, brought to `pages`' device and joined in layer order, the
    whole cache's wire block."""
    parts = [extract_blocks(c, pages.to(c["k"][0].device),
                            block_size).to(pages.device) for c in caches]
    return torch.cat(parts, dim=2)


def inject_stage_blocks(caches: List[dict], pages: torch.Tensor,
                        data: torch.Tensor, block_size: int) -> None:
    """`inject_blocks` into a pipeline's cache: the wire block's layers
    split over the stages that own them, each copied to its card."""
    first = 0
    for c in caches:
        n, dev = len(c["k"]), c["k"][0].device
        inject_blocks(c, pages.to(dev), data[:, :, first:first + n].to(dev),
                      block_size)
        first += n


def held(cache: dict) -> bool:
    """True for a rank's cache this process holds (not another
    process's meta placeholder)."""
    return not cache["k"][0].is_meta


def _junk_view(t: torch.Tensor) -> torch.Tensor:
    """[S + 1, ...]: a slot shard with its junk row (raises where the
    shard was allocated without one)."""
    return t.as_strided((t.shape[0] + 1,) + tuple(t.shape[1:]), t.stride(),
                        t.storage_offset())


def shard_slots(slots: torch.Tensor, base: int, S: int):
    """(local slots, in-shard mask) of global `slots` on the shard that
    holds `[base, base + S)`."""
    local = slots.long() - base
    return local, (local >= 0) & (local < S)


def write_routes(shards: Sequence[Tuple[dict, int]], slots: torch.Tensor):
    """Where rows of global `slots` [N] land in each slot shard, `shards`
    a list of (cache, base) (the shard holding global slots `[base, base
    + S)`): (cache, destination rows on its device), the local slot
    inside the shard and its junk row outside it, as JAX drops those
    writes.  One route serves every layer of a step."""
    out = []
    for cache, base in shards:
        if not held(cache):
            continue
        S = cache["k"][0].shape[0]
        local, inside = shard_slots(slots.to(cache["k"][0].device), base, S)
        out.append((cache, torch.where(inside, local,
                                       torch.full_like(local, S))))
    return out


def _write_raw(routes, layer: int, rows: dict) -> None:
    for cache, dst in routes:
        for name, r in rows.items():
            buf = cache[name][layer]
            _junk_view(buf).index_copy_(0, dst, r.to(buf.device, buf.dtype))


def write_routed(routes, layer: int, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write [N, F] K/V rows into one layer of every routed shard, in
    place, quantized once with their scales for an int8 cache."""
    cache = routes[0][0]
    if "k_scale" in cache:
        H = cache["k_scale"][layer].shape[1]
        kq, ks = quantize_kv_rows(k, H)
        vq, vs = quantize_kv_rows(v, H)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    _write_raw(routes, layer, rows)


def read_routes(shards: Sequence[Tuple[dict, int]], slots: torch.Tensor):
    """Where global `slots` (any shape) are read in each slot shard:
    (cache, the clamped local index [N] on its device, the in-shard mask
    [N, 1] on `slots`' device).  One route serves every layer."""
    out = []
    for cache, base in shards:
        S = cache["k"][0].shape[0]
        local, inside = shard_slots(slots.to(cache["k"][0].device), base, S)
        out.append((cache, local.clamp(0, S - 1).reshape(-1),
                    inside.reshape(-1, 1).to(slots.device)))
    return out


def _gather_raw(routes, layer: int, names, device) -> List[torch.Tensor]:
    """One masked gather a shard of each named buffer, combined by
    `torch.where` (no host sync sizes anything); zeros where no shard
    holds the slot."""
    acc = None
    for cache, idx, m in routes:
        got = [cache[name][layer].index_select(0, idx).to(device)
               for name in names]
        if acc is None:
            acc = [torch.zeros_like(g) for g in got]
        acc = [torch.where(m, g, a) for g, a in zip(got, acc)]
    return acc


def gather_routed(routes, layer: int, shape: Tuple[int, int],
                  num_kv_heads: int, out_dtype: torch.dtype,
                  device: torch.device):
    """Context K/V of [B, C] slots (`shape`) read along `routes`:
    [B, C, Hkv, D] pairs on `device`, dequantized as `gather_kv_quant`
    from an int8 cache."""
    B, C = shape
    quant = "k_scale" in routes[0][0]
    acc = _gather_raw(routes, layer, ("k", "v", "k_scale", "v_scale")
                      if quant else ("k", "v"), device)
    D = acc[0].shape[1] // num_kv_heads
    k = acc[0].reshape(B, C, num_kv_heads, D)
    v = acc[1].reshape(B, C, num_kv_heads, D)
    if not quant:
        return k, v
    return (dequantize_rows(k, acc[2].reshape(B, C, num_kv_heads), out_dtype),
            dequantize_rows(v, acc[3].reshape(B, C, num_kv_heads), out_dtype))


def slot_shards(cache: List[dict], grid, row: int = 0
                ) -> List[Tuple[dict, int]]:
    """(cache, base) of each slot shard as dp row `row` reads them: its
    ranks' tp shards under dp-attention, the flat grid's under
    dp-local."""
    grid = grid.attention
    S = cache[0]["k"][0].shape[0]
    if grid.dp_local:
        return [(cache[f], f * S) for f in range(grid.n)]
    return [(cache[row * grid.tp + t], t * S) for t in range(grid.tp)]


def slot_copies(cache: List[dict], grid) -> List[Tuple[dict, int]]:
    """(cache, base) of every distinct copy of every slot shard: where a
    write must land."""
    grid = grid.attention
    S = cache[0]["k"][0].shape[0]
    if grid.dp_local:
        return [(cache[f], f * S) for f in range(grid.n)]
    return [(cache[f], t * S) for t in range(grid.tp)
            for f in grid.holders(t)]


def extract_grid_blocks(cache: List[dict], grid, pages: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """`extract_blocks` of a DpGrid's cache: plain dp reads dp row 0's
    column bands; slot shards read each page from the shard holding
    it."""
    from dynamo_tpu_torch.parallel.multihost import grid_spans_processes

    if grid_spans_processes(grid):
        return _extract_spanning(cache, grid, pages, block_size)
    grid = grid.attention
    if not grid.dp_attention:
        return extract_blocks(cache[:grid.tp], pages, block_size)
    routes = read_routes(slot_shards(cache, grid),
                         _page_slots(pages, block_size))
    n = pages.shape[0]
    quant = cache_is_quantized(cache)

    def rows(kind, layer):
        if quant:
            # Raw int8 rows and their scales, packed as the wire block.
            q, sc = _gather_raw(routes, layer, (kind, f"{kind}_scale"),
                                pages.device)
            q = torch.cat([q, sc.view(torch.int8)], dim=1)
        else:
            q, = _gather_raw(routes, layer, (kind,), pages.device)
        return q.view(n, block_size, -1)

    L = len(cache[0]["k"])
    return torch.stack([torch.stack([rows(kind, layer) for layer in range(L)],
                                    dim=1)
                        for kind in ("k", "v")], dim=1)


def _extract_spanning(cache: List[dict], grid, pages: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """`extract_grid_blocks` of a process-spanning grid, which every
    process joins: each piece (a tp slice's column band, or a slot
    shard) is read by the process of its first copy, the pieces cross
    through the fabric, and every process assembles the wire block."""
    fabric, me = grid.fabric, grid.fabric.process_id
    n = pages.shape[0]
    L = len(cache[0]["k"])
    if not grid.dp_attention:
        firsts = [grid.holders(t)[0] for t in range(grid.tp)]
        mine = [extract_blocks([cache[h]], pages, block_size)
                for h in firsts if grid.mine[h]]
        raw = (torch.cat([b.reshape(-1).view(torch.uint8) for b in mine])
               if mine else torch.zeros((0,), dtype=torch.uint8,
                                        device=pages.device))
        got = fabric.gather_bytes(raw, fabric.world)
        ranks, offs = [], [0] * fabric.num_processes
        for h in firsts:
            q, c = grid.owner[h], cache[h]
            quant = "k_scale" in c
            f = c["k"][0].shape[1] + (4 * c["k_scale"][0].shape[1]
                                     if quant else 0)
            dtype = torch.int8 if quant else c["k"][0].dtype
            size = n * 2 * L * block_size * f * dtype.itemsize
            ranks.append(got[q][offs[q]:offs[q] + size].view(dtype).reshape(
                n, 2, L, block_size, f))
            offs[q] += size
        if len(ranks) == 1:
            return ranks[0]
        if "k_scale" not in cache[0]:
            return torch.cat(ranks, dim=-1)
        f = cache[0]["k"][0].shape[1]
        return torch.cat([r[..., :f] for r in ranks]
                         + [r[..., f:] for r in ranks], dim=-1)
    # Slot shards: each page lives in one shard; each shard is read by
    # the process of its first copy, zeros elsewhere, and the pieces join
    # by their row masks.
    S = cache[0]["k"][0].shape[0]
    shards = (list(range(grid.n)) if grid.dp_local
              else [grid.holders(t)[0] for t in range(grid.tp)])
    bases = ([f * S for f in shards] if grid.dp_local
             else [t * S for t in range(grid.tp)])
    own = [(cache[g], b) for g, b in zip(shards, bases) if grid.mine[g]]
    slots = _page_slots(pages, block_size)
    quant = cache_is_quantized(cache)
    names = lambda kind: ((kind, f"{kind}_scale") if quant else (kind,))
    if own:
        routes = read_routes(own, slots)
        mask = torch.zeros((n * block_size, 1), dtype=torch.bool,
                           device=pages.device)
        for _, _, m in routes:
            mask |= m
        parts = []
        for kind in ("k", "v"):
            for layer in range(L):
                got = _gather_raw(routes, layer, names(kind), pages.device)
                q = got[0] if not quant else torch.cat(
                    [got[0], got[1].view(torch.int8)], dim=1)
                parts.append(q)
        block = torch.stack(parts).reshape(2, L, n * block_size, -1)
    else:
        c = next(c for c in cache if held(c))
        f = c["k"][0].shape[1] + (4 * c["k_scale"][0].shape[1]
                                 if quant else 0)
        block = torch.zeros((2, L, n * block_size, f),
                            dtype=torch.int8 if quant else c["k"][0].dtype,
                            device=pages.device)
        mask = torch.zeros((n * block_size, 1), dtype=torch.bool,
                           device=pages.device)
    blocks = fabric.gather(block, fabric.world)
    masks = fabric.gather(mask, fabric.world)
    out = blocks[0]
    for b, m in zip(blocks[1:], masks[1:]):
        out = torch.where(m, b, out)
    return out.reshape(2, L, n, block_size, -1).permute(2, 0, 1, 3, 4) \
        .contiguous()


def inject_grid_blocks(cache: List[dict], grid, pages: torch.Tensor,
                       data: torch.Tensor, block_size: int) -> None:
    """`inject_blocks` into a DpGrid's cache: every copy of the pages'
    columns (plain dp) or of the slot shard holding each page."""
    grid = grid.attention
    if not grid.dp_attention:
        tp = grid.tp
        rows = {tuple(grid.places[d * tp:(d + 1) * tp]): d
                for d in reversed(range(grid.dp))}
        for d in sorted(rows.values()):
            inject_blocks(cache[d * tp:(d + 1) * tp], pages, data, block_size)
        return
    routes = write_routes(slot_copies(cache, grid),
                          _page_slots(pages, block_size))
    n = pages.shape[0]
    quant = cache_is_quantized(cache)
    F = cache[0]["k"][0].shape[1]
    for i, kind in enumerate(("k", "v")):
        for layer in range(len(cache[0][kind])):
            d = data[:, i, layer].reshape(n * block_size, -1)
            if quant:
                d = d.to(torch.int8)
                rows = {kind: d[:, :F].contiguous(),
                        f"{kind}_scale": d[:, F:].contiguous().view(
                            torch.float32)}
            else:
                rows = {kind: d}
            _write_raw(routes, layer, rows)


def _ranks(cache) -> List[dict]:
    return cache if isinstance(cache, list) else [cache]


def cache_is_quantized(cache) -> bool:
    """The cache dict's keys are the mode bit (a tp cache: its ranks')."""
    return "k_scale" in _ranks(cache)[0]


def _page_slots(pages: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat slot ids of whole pages: [n * bs], page-major."""
    offs = torch.arange(block_size, device=pages.device)
    return (pages.long()[:, None] * block_size + offs).reshape(-1)


def extract_blocks(cache, pages: torch.Tensor,
                   block_size: int) -> torch.Tensor:
    """The wire blocks of `pages` ([n] page ids on the cache's device,
    rank 0's for a tp cache) as one new tensor [n, 2, L, bs, F'] that
    shares no storage with the cache: F' = F at the cache dtype, or F +
    4 * Hkv packed int8."""
    slots = _page_slots(pages, block_size)
    n = pages.shape[0]
    ranks = _ranks(cache)
    quant = cache_is_quantized(cache)
    rank_slots = [slots.to(c["k"][0].device) for c in ranks]

    def cols(kind: str, layer: int) -> torch.Tensor:
        parts = [c[kind][layer].index_select(0, s).to(slots.device)
                 for c, s in zip(ranks, rank_slots)]
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def rows(kind: str, layer: int) -> torch.Tensor:
        q = cols(kind, layer)                              # [n * bs, F]
        if quant:
            s = cols(f"{kind}_scale", layer)               # [n * bs, Hkv]
            q = torch.cat([q, s.view(torch.int8)], dim=1)  # [n*bs, F+4H]
        return q.view(n, block_size, -1)

    L = len(ranks[0]["k"])
    return torch.stack([torch.stack([rows(kind, layer) for layer in range(L)],
                                    dim=1)
                        for kind in ("k", "v")], dim=1)


def inject_blocks(cache, pages: torch.Tensor, data: torch.Tensor,
                  block_size: int) -> None:
    """Write wire blocks `data` [n, 2, L, bs, F'] into `pages` ([n] page
    ids) in place, unpacking the int8 scales and splitting a tp cache's
    columns over its ranks.  The caller has checked the format
    (`EngineCore._validate_block`)."""
    slots = _page_slots(pages, block_size)
    n = pages.shape[0]
    ranks = _ranks(cache)
    quant = cache_is_quantized(cache)
    f = ranks[0]["k"][0].shape[1]                  # one rank's columns
    h = ranks[0]["k_scale"][0].shape[1] if quant else 0
    F = f * len(ranks)
    for i, kind in enumerate(("k", "v")):
        for layer in range(len(ranks[0][kind])):
            d = data[:, i, layer].reshape(n * block_size, -1)
            d = d.to(torch.int8 if quant else ranks[0][kind][0].dtype)
            for r, c in enumerate(ranks):
                if not held(c):
                    continue        # another process's rank injects it
                dev = c[kind][layer].device
                s = slots.to(dev)
                c[kind][layer].index_copy_(0, s, d[:, r * f:(r + 1) * f].to(dev))
                if quant:
                    scale = d[:, F + 4 * r * h: F + 4 * (r + 1) * h]
                    c[f"{kind}_scale"][layer].index_copy_(
                        0, s, scale.contiguous().view(torch.float32).to(dev))


def slots_for_positions(block_tables: torch.Tensor,  # [B, P] int
                        positions: torch.Tensor,     # [B, T] int
                        block_size: int) -> torch.Tensor:
    """Flat slot of each (sequence, position): `bt[pos//bs]*bs + pos%bs`.

    Positions whose page index falls past the table width resolve to the
    null block explicitly (not clip-to-last-column, which would alias a
    real page); within-table entries never allocated are NULL_BLOCK by
    construction and must stay masked by the caller."""
    positions = positions.long()
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offset = positions % block_size
    P = block_tables.shape[1]
    in_range = block_idx < P
    block_ids = torch.gather(block_tables.long(), 1,
                             torch.clamp(block_idx, max=P - 1))
    block_ids = torch.where(in_range, block_ids,
                            torch.zeros_like(block_ids) + NULL_BLOCK)
    return block_ids * block_size + offset


def write_kv(cache_layer_k: torch.Tensor,  # [S, F], updated in place
             cache_layer_v: torch.Tensor,
             slots: torch.Tensor,          # [N] flat slot ids
             k: torch.Tensor,              # [N, F]
             v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into one layer's slot axis, in place.

    Pad tokens carry null-block slots, so their writes land in the junk
    block.  Slots outside [0, S), which JAX drops (`mode="drop"`), are
    sent to slot 0 — the null block — instead: dropping them would need
    a host sync to size the kept set, and the null block is junk by
    contract either way."""
    slots = _in_range(slots, cache_layer_k.shape[0])
    cache_layer_k.index_copy_(0, slots, k.to(cache_layer_k.dtype))
    cache_layer_v.index_copy_(0, slots, v.to(cache_layer_v.dtype))
    return cache_layer_k, cache_layer_v


def _in_range(slots: torch.Tensor, S: int) -> torch.Tensor:
    """Slots outside [0, S) sent to slot 0, the null block."""
    slots = slots.long()
    return torch.where((slots >= 0) & (slots < S), slots,
                       torch.zeros_like(slots))


def gather_kv(cache_layer_k: torch.Tensor,  # [S, F]
              cache_layer_v: torch.Tensor,
              slots: torch.Tensor,          # [B, C] flat slot ids
              num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather per-sequence context K/V: returns [B, C, Hkv, D] pairs
    (out-of-range slots clip, as JAX's `mode="clip"`)."""
    B, C = slots.shape
    S, F = cache_layer_k.shape
    D = F // num_kv_heads
    idx = torch.clamp(slots.long(), 0, S - 1).reshape(-1)
    k = cache_layer_k.index_select(0, idx)
    v = cache_layer_v.index_select(0, idx)
    return (k.reshape(B, C, num_kv_heads, D),
            v.reshape(B, C, num_kv_heads, D))


# ---------------------------------------------------------------------------
# int8 quantization (kv_quant="int8")

# Smallest per-head scale: all-zero rows (padding, the null block)
# quantize to 0 with a nonzero scale instead of dividing by 0.
_QUANT_EPS = 1e-8


def quantize_kv_rows(x: torch.Tensor,      # [N, F] rows in compute dtype
                     num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token, per-head int8 quantization: (int8 [N, F],
    f32 scales [N, Hkv]) with x ~ q * scale[..., head]."""
    N, F = x.shape
    xf = x.float().reshape(N, num_kv_heads, F // num_kv_heads)
    amax = xf.abs().amax(dim=-1)                               # [N, Hkv]
    scale = torch.clamp_min(amax, _QUANT_EPS) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(N, F), scale


def dequantize_rows(q: torch.Tensor,       # [..., Hkv, D] int8
                    scale: torch.Tensor,   # [..., Hkv] f32
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_kv_rows on head-split rows: an f32 product,
    then a round-to-nearest-even cast to `out_dtype` — what the CUDA
    kernels' int8 page loader computes, so both paths see the same
    dequantized operands."""
    return (q.float() * scale[..., None]).to(out_dtype)


def scatter_kv_quant(cache_layer_k: torch.Tensor,  # [S, F] int8, in place
                     cache_layer_v: torch.Tensor,
                     scale_layer_k: torch.Tensor,  # [S, Hkv] f32, in place
                     scale_layer_v: torch.Tensor,
                     slots: torch.Tensor,          # [N] flat slot ids
                     kq: torch.Tensor,             # [N, F] int8
                     vq: torch.Tensor,
                     ks: torch.Tensor,             # [N, Hkv] f32
                     vs: torch.Tensor):
    """Scatter already-quantized rows and their scales into one layer, in
    place (out-of-range slots to the null block, as write_kv)."""
    slots = _in_range(slots, cache_layer_k.shape[0])
    cache_layer_k.index_copy_(0, slots, kq)
    cache_layer_v.index_copy_(0, slots, vq)
    scale_layer_k.index_copy_(0, slots, ks)
    scale_layer_v.index_copy_(0, slots, vs)
    return cache_layer_k, cache_layer_v, scale_layer_k, scale_layer_v


def write_kv_quant(cache_layer_k: torch.Tensor,   # [S, F] int8, in place
                   cache_layer_v: torch.Tensor,
                   scale_layer_k: torch.Tensor,   # [S, Hkv] f32, in place
                   scale_layer_v: torch.Tensor,
                   slots: torch.Tensor,           # [N] flat slot ids
                   k: torch.Tensor,               # [N, F] unquantized rows
                   v: torch.Tensor):
    """Quantize new K/V rows and scatter them with their scales."""
    H = scale_layer_k.shape[-1]
    kq, ks = quantize_kv_rows(k, H)
    vq, vs = quantize_kv_rows(v, H)
    return scatter_kv_quant(cache_layer_k, cache_layer_v, scale_layer_k,
                            scale_layer_v, slots, kq, vq, ks, vs)


def gather_kv_quant(cache_layer_k: torch.Tensor,  # [S, F] int8
                    cache_layer_v: torch.Tensor,
                    scale_layer_k: torch.Tensor,  # [S, Hkv] f32
                    scale_layer_v: torch.Tensor,
                    slots: torch.Tensor,          # [B, C]
                    num_kv_heads: int,
                    out_dtype: torch.dtype = torch.bfloat16):
    """Gather and dequantize context K/V: [B, C, Hkv, D] pairs in
    `out_dtype` (out-of-range slots clip, as gather_kv)."""
    B, C = slots.shape
    S, F = cache_layer_k.shape
    D = F // num_kv_heads
    idx = torch.clamp(slots.long(), 0, S - 1).reshape(-1)
    kq = cache_layer_k.index_select(0, idx).reshape(B, C, num_kv_heads, D)
    vq = cache_layer_v.index_select(0, idx).reshape(B, C, num_kv_heads, D)
    ks = scale_layer_k.index_select(0, idx).reshape(B, C, num_kv_heads)
    vs = scale_layer_v.index_select(0, idx).reshape(B, C, num_kv_heads)
    return (dequantize_rows(kq, ks, out_dtype),
            dequantize_rows(vq, vs, out_dtype))
