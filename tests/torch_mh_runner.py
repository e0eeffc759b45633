"""One process of a two-process port engine on the CPU rig (gloo), for
tests/test_torch_multihost.py; never collected by pytest.  It imports
nothing of JAX.

    python tests/torch_mh_runner.py engine <leader|follower> COORD LOCK \\
        MODE STATE DP TP
        One EngineCore over the dp x tp grid split over two processes;
        the leader drives the requests of JAX's tests/test_multihost.py
        and prints LEADER_TOKENS, the follower replays and prints
        FOLLOWER_DONE (its requests left) and FOLLOWER_OPS (ops
        replayed).  MODE: plain, prefix, dp_attention, fused_int8 or
        cancel.
    python tests/torch_mh_runner.py logits <leader|follower> COORD DTYPE \\
        STATE DP TP [DEVICE]
        A packed prefill, two unified decode steps and a greedy window on
        the process-spanning grid; the leader runs the same on a
        one-process grid of the same mesh and prints LOGITS_EQUAL.
        DTYPE "moe": tiny-moe drawn from seed 3 in f32 ("dense" MoE on the
        grid), each step's expert load compared too (STATE unread).
        DEVICE "cuda": process P on card P (nccl), the reference grid on
        the cards of the leader's process, the model tiny-test at head_dim
        32 (the kernels' smallest) drawn from seed 3 on the host (STATE
        "-"); default the CPU rig.
    python tests/torch_mh_runner.py blocks <leader|follower> COORD MODE \\
        DP TP
        The wire blocks of a random cache (bf16 and int8) extracted from
        the process-spanning grid's copies and from the one-process
        grid's, and a random block injected into both and extracted
        again; the leader prints BLOCKS_EQUAL.  MODE: plain, attn
        (dp-attention) or local (dp-local).
"""

import json
import sys

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel import multihost
from dynamo_tpu_torch.parallel.mesh import DpGrid, MeshConfig
from dynamo_tpu_torch.parallel.sharding import param_pspecs, shard_state

PROMPTS = {
    "req-a": [1, 2, 3, 4, 5, 6, 7, 8],
    "req-b": [9, 8, 7, 6, 5],
    "req-c": [42, 43],
}


def _join(role: str, coord: str, dp: int, tp: int, device: str = "cpu"):
    pid = 0 if role == "leader" else 1
    if device == "cpu":
        multihost.setup_cpu_rig(dp * tp // 2)
    else:
        device = f"cuda:{pid}"
    return multihost.initialize(f"127.0.0.1:{coord}", 2, pid, device)


def run_engine(role, coord, lock, mode, state_path, dp, tp) -> None:
    fabric = _join(role, coord, dp, tp)
    state = torch.load(state_path)
    core = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        dp=dp, tp=tp, dp_attention=mode == "dp_attention",
        enable_prefix_cache=mode == "prefix",
        kv_quant="int8" if mode == "fused_int8" else "none",
        scheduler=SchedulerConfig(block_size=16), fabric=fabric),
        params=state)
    del state
    if mode == "fused_int8":
        # JAX's decode_window=1: every decode step is the fused greedy one.
        core._window_eligible = lambda plan: False
    if role == "follower":
        chan = multihost.LockstepFollower("127.0.0.1", int(lock))
        multihost.run_follower(core, chan)
        print("FOLLOWER_DONE " + json.dumps(sorted(core._requests)),
              flush=True)
        print("FOLLOWER_OPS " + json.dumps(chan.replayed), flush=True)
        print("FOLLOWER_STATS " + json.dumps(core.lockstep_stats()),
              flush=True)
        return
    leader = multihost.LockstepLeader(port=int(lock), num_followers=1)
    leader.wait_for_followers()
    core._lockstep = leader
    sampled = ({} if mode == "fused_int8"
               else {"req-c": SamplingParams(temperature=0.8, top_k=20,
                                             seed=1234, max_tokens=12)})
    for rid, toks in PROMPTS.items():
        core.add_request(rid, toks,
                         sampled.get(rid, SamplingParams(max_tokens=12)))
    if mode == "cancel":
        core.add_request("req-x", [7, 7, 7], SamplingParams(max_tokens=40))
    out = {rid: [] for rid in core._requests}
    steps = 0
    while core.has_work and steps < 200:
        for d in core.step():
            out[d.request_id].extend(d.token_ids)
        steps += 1
        if mode == "cancel" and steps == 3:
            core.cancel("req-x")
    stats = core.lockstep_stats()
    leader.close()
    print("LEADER_STATS " + json.dumps(stats), flush=True)
    print("LEADER_OPS " + json.dumps(leader.sent), flush=True)
    print("LEADER_TOKENS " + json.dumps(out), flush=True)


def _steps(cfg, grid, state, dtype, quant, dev):
    """The logits of a grid-shaped packed prefill of four prompts, two
    unified decode steps and a greedy window's tokens, on `dev`; an MoE
    model's ("dense" on the grid) each step's [E+1] expert load after
    them."""
    block = 8
    moe = "dense" if cfg.is_moe else None
    ranks = shard_state(state, param_pspecs(cfg, moe or "dense"), grid)
    ccfg = kvc.KvCacheConfig.for_model(cfg, num_blocks=32, block_size=block,
                                       kv_quant=quant)
    cache = kvc.init_grid_caches(ccfg, grid)
    prompts = [[5, 6, 7, 8, 9], list(range(20, 31)), [3, 1, 4, 1, 5, 9, 2],
               [2, 7, 1, 8]]
    R, split = len(prompts), grid.dp
    per = R // split
    Tg = max(sum(-(-len(prompts[i]) // 8) * 8
                 for i in range(g * per, (g + 1) * per))
             for g in range(split))
    T, pad = Tg * split, 16 * block
    tok = torch.zeros(T, dtype=torch.int32)
    pos = torch.full((T,), pad, dtype=torch.int32)
    seg = torch.zeros(T, dtype=torch.int32)
    qs = torch.zeros(R, dtype=torch.int32)
    smp = torch.zeros(R, dtype=torch.int32)
    for g in range(split):
        off = g * Tg
        for i in range(g * per, (g + 1) * per):
            n = len(prompts[i])
            tok[off:off + n] = torch.tensor(prompts[i])
            pos[off:off + n] = torch.arange(n)
            seg[off:off + n], qs[i], smp[i] = i, off, off + n - 1
            off += -(-n // 8) * 8
    tables = torch.tensor([[1, 2, 3], [4, 5, 6], [8, 9, 10], [12, 13, 14]],
                          dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    tok, pos, seg, qs, smp, tables, lens = (
        t.to(dev) for t in (tok, pos, seg, qs, smp, tables, lens))
    out, loads = [], []
    res = llama.make_packed_prefill_step(
        cfg, block, moe_mode=moe or "dense", tp=grid)(
        ranks, cache, tok, pos, seg, tables, qs, lens, lens, smp)
    (logits, cache), loads = res[:2], loads + list(res[2:])
    out.append(logits)
    step = llama.make_forward_step(cfg, block, use_decode_kernel=True,
                                   moe_mode=moe or "dense",
                                   with_expert_load=bool(moe), tp=grid)
    nxt = logits.argmax(-1).to(torch.int32)
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    for _ in range(2):
        lens = lens + 1
        res = step(ranks, cache, nxt[:, None], (lens - 1)[:, None], lens,
                   tables, zero)
        (logits, cache), loads = res[:2], loads + list(res[2:])
        out.append(logits)
        nxt = logits.argmax(-1).to(torch.int32)
    run = llama.make_decode_window(cfg, block, 3, use_decode_kernel=True,
                                   greedy_only=True, moe_mode=moe or "dense",
                                   with_expert_load=bool(moe), tp=grid)
    res = run(ranks, cache, nxt, lens, lens + 1, tables,
              torch.zeros(R, device=dev),
              torch.zeros(R, dtype=torch.int32, device=dev),
              torch.ones(R, device=dev), [None] * R, [0] * R)
    out.append(res[1])
    return [t.cpu() for t in out + loads + list(res[5:])]


def run_logits(role, coord, dtype, state_path, dp, tp, device) -> None:
    fabric = _join(role, coord, dp, tp, device)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "moe": torch.float32}[dtype]
    cfg = tcfg.get_config("tiny-moe" if dtype == "moe" else "tiny-test"
                          ).replace(dtype=dt)
    if dtype == "moe":
        from dynamo_tpu_torch.models.weights import init_params

        state = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    elif state_path == "-":
        from dynamo_tpu_torch.models.weights import init_params

        cfg = cfg.replace(head_dim=32)
        state = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    else:
        state = _cast(torch.load(state_path), dt)
    quant = "int8" if dtype == "bf16" else "none"
    mesh = MeshConfig(dp=dp, tp=tp)
    dev = fabric.device
    grid = DpGrid.for_mesh(mesh, dev, fabric=fabric)
    got = _steps(cfg, grid, state, dt, quant, dev)
    if role == "follower":
        print("FOLLOWER_DONE []", flush=True)
        return
    want = _steps(cfg, DpGrid.for_mesh(mesh, dev), state, dt, quant, dev)
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    print("LOGITS_EQUAL " + json.dumps(same), flush=True)
    print("LEADER_STATS " + json.dumps({
        "owned_ranks": [f for f, m in enumerate(grid.mine) if m],
        "launches": grid.launches, **fabric.describe()}), flush=True)


def run_blocks(role, coord, mode, dp, tp) -> None:
    from dynamo_tpu_torch.parallel.sharding import cache_pspecs

    fabric = _join(role, coord, dp, tp)
    cfg = tcfg.get_config("tiny-test").replace(dtype=torch.bfloat16)
    da, dl = mode in ("attn", "local"), mode == "local"
    block, n_blocks = 8, 16
    pages = torch.tensor([1, 5, 6, 11, 14], dtype=torch.int32)
    equal = []
    for quant in ("none", "int8"):
        ccfg = kvc.KvCacheConfig.for_model(cfg, num_blocks=n_blocks,
                                           block_size=block, kv_quant=quant)
        gen = torch.Generator().manual_seed(11)
        whole = {k: [(torch.randn(t.shape, generator=gen) * 4).to(t.dtype)
                     for t in v] for k, v in kvc.init_cache(ccfg, "cpu").items()}
        specs = cache_pspecs(cfg.num_layers, da, dl, quant == "int8")
        grids = [DpGrid(["cpu"] * (dp * tp), dp, da, dl, fabric=f)
                 for f in (fabric, None)]
        caches = [shard_state(whole, specs, g, junk_rows=da) for g in grids]
        got = [kvc.extract_grid_blocks(c, g, pages, block)
               for c, g in zip(caches, grids)]
        wire = (torch.randn(got[0].shape, generator=gen) * 4).to(
            got[0].dtype)
        fresh = [kvc.init_grid_caches(ccfg, g) for g in grids]
        for c, g in zip(fresh, grids):
            kvc.inject_grid_blocks(c, g, pages + 1, wire, block)
        back = [kvc.extract_grid_blocks(c, g, pages + 1, block)
                for c, g in zip(fresh, grids)]
        equal += [bool(torch.equal(*got)), bool(torch.equal(*back)),
                  bool(torch.equal(back[0], wire))]
    if role == "leader":
        print("BLOCKS_EQUAL " + json.dumps(equal), flush=True)
    else:
        print("FOLLOWER_DONE []", flush=True)


def _cast(tree, dt):
    if isinstance(tree, dict):
        return {k: _cast(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dt) for v in tree]
    return tree.to(dt) if tree.is_floating_point() else tree


def main() -> None:
    kind, role = sys.argv[1:3]
    rest = sys.argv[3:]
    try:
        if kind == "engine":
            coord, lock, mode, path, dp, tp = rest
            run_engine(role, coord, lock, mode, path, int(dp), int(tp))
        elif kind == "blocks":
            coord, mode, dp, tp = rest
            run_blocks(role, coord, mode, int(dp), int(tp))
        else:
            coord, dtype, path, dp, tp, *device = rest
            run_logits(role, coord, dtype, path, int(dp), int(tp),
                       device[0] if device else "cpu")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
