"""Pre-deployment mini-profiler: sweep the port's engine, emit the SLA
profile (port of `dynamo_tpu/planner/profiler.py`).

Role of the reference's `benchmarks/profiler/profile_sla.py` (genai-perf
sweeps of TTFT/ITL over load feeding `perf_interpolation.py`): run the
real EngineCore across an ISL grid (prefill) and a context x kv-load grid
(decode), measure TTFT/ITL/throughput per card, and write the profile
`planner/interpolation.py` consumes (JAX's schema, whose per-device key
is `tok_s_per_chip`).

Card-granular and engine-native: no HTTP in the loop; the engine is
driven synchronously, so the profile measures the serving step itself
(packed prefill through the paged-prefill kernel, decode windows through
the paged-decode kernel).  Runs on the card unless `--device cpu` is
given:

    python -m dynamo_tpu_torch.planner.profiler --model llama-3-1b \\
        --isl 128 512 --context 256 1024 --kv 0.2 0.6 --out p.json
    python -m dynamo_tpu_torch.planner.profiler --model tiny-test \\
        --device cpu --isl 8 16 --context 16 --kv 0.2 0.6 --num-blocks 64

The weights are built once (random, seed 0) and every cell gets a fresh
core over them.  The model comes from the port's presets (checkpoint
loaders are not ported); there is no tp mesh, and the decode window and
packed prefill are the engine's fixed plane.
"""

from __future__ import annotations

import gc
import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.weights import init_params

logger = logging.getLogger(__name__)


def profile_engine(
    make_core,
    isl_grid: Sequence[int] = (128, 256, 512),
    context_grid: Sequence[int] = (256, 512, 1024),
    kv_grid: Sequence[float] = (0.2, 0.5, 0.8),
    decode_tokens: int = 32,
) -> Dict:
    """Sweep a fresh EngineCore per cell; returns the profile dict.

    `make_core() -> EngineCore` builds one engine per cell (with DISTINCT
    prompts per attempt so measurements never prefix-hit each other).
    Every cell runs its workload twice on the SAME core and keeps the
    SECOND measurement: the first run pays the cell's first-use costs
    (kernel loads, allocator growth), which would poison every
    interpolation built on it.
    """
    prefill = {"isl": [], "ttft_s": [], "tok_s_per_chip": []}
    for isl in isl_grid:
        core = make_core()
        vocab = core.config.model.vocab_size
        ttft = 0.0
        for attempt in range(2):  # warm, then measure
            rng = np.random.default_rng(isl * 7 + attempt)
            prompt = rng.integers(1, vocab, size=isl).tolist()
            core.add_request(f"p{attempt}", prompt,
                             SamplingParams(max_tokens=1))
            t0 = time.perf_counter()
            done = False
            while not done:
                for d in core.step():
                    if d.token_ids or d.finished:
                        done = True
            ttft = time.perf_counter() - t0
            while core.has_work:
                core.step()  # drain the terminal delta
        prefill["isl"].append(int(isl))
        prefill["ttft_s"].append(ttft)
        prefill["tok_s_per_chip"].append(isl / ttft if ttft > 0 else 0.0)
        logger.info("profile prefill isl=%d ttft=%.3fs", isl, ttft)

    decode = {"kv_usage": list(map(float, kv_grid)),
              "context": [int(c) for c in context_grid],
              "itl_s": [], "tok_s_per_chip": []}
    for ctx in context_grid:
        itl_row, thpt_row = [], []
        for kv in kv_grid:
            core = make_core()
            cfg = core.config
            bs = core.block_size
            vocab = cfg.model.vocab_size
            pages_per_seq = (ctx + bs - 1) // bs + 1
            usable = cfg.num_blocks - 1
            batch = max(1, int(kv * usable / pages_per_seq))
            batch = min(batch, cfg.scheduler.max_seqs)
            itl = wall = produced = 0
            for attempt in range(2):  # warm, then measure
                rng = np.random.default_rng(
                    int(ctx * 1000 + kv * 100 + attempt))
                for i in range(batch):
                    core.add_request(
                        f"d{attempt}-{i}",
                        rng.integers(1, vocab, size=ctx).tolist(),
                        SamplingParams(max_tokens=decode_tokens))
                # Prefill everything first (excluded from the ITL window).
                while core.has_pending_prefill:
                    core.step()
                produced = 0
                t0 = time.perf_counter()
                while core.has_work:
                    produced += sum(len(d.token_ids) for d in core.step())
                wall = time.perf_counter() - t0
                itl = wall / max(produced / batch, 1.0)
            itl_row.append(itl)
            thpt_row.append(produced / wall if wall > 0 else 0.0)
            logger.info("profile decode ctx=%d kv=%.2f itl=%.4fs "
                        "thpt=%.1f", ctx, kv, itl, thpt_row[-1])
        decode["itl_s"].append(itl_row)
        decode["tok_s_per_chip"].append(thpt_row)
    return {"prefill": prefill, "decode": decode}


def default_core_factory(model: str = "llama-3-1b",
                         num_blocks: int = 2048,
                         block_size: int = 64,
                         max_seqs: int = 64,
                         device: str = "cuda"):
    """EngineCore factory matching the serving geometry: the weights are
    drawn once, on `device`, and shared by every core it makes.  The
    prefix cache is off, so no cell hits another's blocks.  (JAX's
    `cell_core_factory` adds the axes of its configuration sweep,
    `benchmarks/sla_profiler.py`, which the port does not have.)"""
    cfg = get_config(model)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev)

    def make():
        gc.collect()   # the previous cell's cache goes before this one's
        return EngineCore(EngineConfig(
            model=cfg, num_blocks=num_blocks, device=device,
            enable_prefix_cache=False,
            scheduler=SchedulerConfig(
                max_seqs=max_seqs, block_size=block_size)),
            params=params)

    return make


def main(argv: Optional[list] = None) -> None:
    import argparse

    from dynamo_tpu_torch.planner.interpolation import save_profile

    p = argparse.ArgumentParser("dynamo_tpu_torch.planner.profiler")
    p.add_argument("--model", default="llama-3-1b")
    p.add_argument("--out", default="sla_profile.json")
    p.add_argument("--isl", type=int, nargs="+", default=[128, 256, 512])
    p.add_argument("--context", type=int, nargs="+",
                   default=[256, 512, 1024])
    p.add_argument("--kv", type=float, nargs="+", default=[0.2, 0.5, 0.8])
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    profile = profile_engine(
        default_core_factory(args.model, num_blocks=args.num_blocks,
                             device=args.device),
        isl_grid=args.isl, context_grid=args.context, kv_grid=args.kv)
    save_profile(profile, args.out)
    print(f"profile written to {args.out}")


if __name__ == "__main__":
    main()
