"""`python -m dynamo_tpu_torch.frontend` — OpenAI ingress + engine in one
process (port of `dynamo_tpu/frontend/main.py`, single-process engine
mode).

    python -m dynamo_tpu_torch.frontend --model llama-3-1b --model-name m \\
        --http-port 8080 [--device cpu] [--num-blocks N --block-size 64]
    python -m dynamo_tpu_torch.frontend --model mixtral-8x7b --num-layers 16 \\
        [--moe-mode auto|dense|grouped]

Runs on the card unless `--device cpu` is given; random weights from
seed 0 (`EngineConfig.seed`); the byte tokenizer.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    EngineCounters,
    InferenceEngine,
)
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.service import LocalEngineClient, ModelHandle, ModelManager
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import cuda as kernels

logger = logging.getLogger("dynamo_tpu_torch.frontend")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--http-host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--model", default="llama-3-1b",
                   help="model preset (e.g. llama-3-1b, tiny-test)")
    p.add_argument("--model-name", default="dynamo-tpu",
                   help="name the model is served under")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=None,
                   help="keep the first N decoder layers of the preset "
                        "(default: all).  For a model that one card cannot "
                        "hold whole, e.g. mixtral-8x7b (94 GB of bf16 "
                        "weights at 32 layers); a checkpoint's "
                        "num_hidden_layers plays this part for the JAX "
                        "worker")
    p.add_argument("--moe-mode", default="auto",
                   choices=("auto", "dense", "grouped"),
                   help="MoE expert compute: grouped = the CUDA grouped-"
                        "expert kernel, dense = every expert over every "
                        "token (the exact oracle); auto = grouped on a "
                        "card when the expert geometry allows it")
    return p.parse_args(argv)


def model_config(args):
    """The preset, cut to `--num-layers` when given."""
    cfg = get_config(args.model)
    n = args.num_layers
    if n is None:
        return cfg
    if not 1 <= n <= cfg.num_layers:
        raise ValueError(f"--num-layers {n} outside 1..{cfg.num_layers} "
                         f"for {cfg.name}")
    return cfg.replace(num_layers=n)


async def build_model_handle(args):
    """Returns (handle, engine core, shutdown coroutine)."""
    cfg = model_config(args)
    sched = SchedulerConfig(block_size=args.block_size)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=args.num_blocks, scheduler=sched,
        device=args.device, moe_mode=args.moe_mode))
    engine = InferenceEngine(core)
    await engine.start()
    tokenizer = ByteTokenizer()
    handle = ModelHandle(
        name=args.model_name, tokenizer=tokenizer,
        preprocessor=OpenAIPreprocessor(tokenizer),
        client=LocalEngineClient(engine),
        max_context=min(cfg.max_context,
                        sched.max_pages_per_seq * sched.block_size))
    return handle, core, engine.stop


def stats_hooks(core: EngineCore):
    """The `/debug/stats` reply and the `/debug/stats/reset` action over
    one engine."""

    def stats() -> dict:
        load = core.snapshot_expert_load()
        return {"device": str(core.device),
                "kernels": kernels.launch_counts(),
                "counters": core.counters.as_dict(),
                "moe_mode": core.moe_mode,
                # [E+1]: per-expert assignments, then the dropped ones.
                "expert_load": (None if load is None else
                                [int(x) for x in load]
                                + [core.moe_dropped_tokens])}

    def reset_stats() -> None:
        # Launch counts, engine counters and the expert load start one
        # window together, so launches per dispatch can be read off one
        # /debug/stats reply.
        kernels.reset_launch_counts()
        core.reset_expert_load()
        core.counters = EngineCounters()

    return stats, reset_stats


async def run(args) -> None:
    handle, core, shutdown = await build_model_handle(args)
    models = ModelManager()
    models.register(handle)
    stats, reset_stats = stats_hooks(core)
    svc = HttpService(models, stats=stats, reset_stats=reset_stats)
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    try:
        port = await svc.start(args.http_host, args.http_port)
        cfg = core.config.model
        print(f"dynamo_tpu_torch frontend serving {handle.name!r} "
              f"({args.model}, {cfg.num_layers} layers, moe_mode "
              f"{core.moe_mode}, on {core.device}) on "
              f"http://{args.http_host}:{port}", flush=True)
        await stop_ev.wait()
    finally:
        await svc.stop()
        await shutdown()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
