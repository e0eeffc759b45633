"""`python -m dynamo_tpu_torch.frontend` — OpenAI ingress + engine in one
process (port of `dynamo_tpu/frontend/main.py`, single-process engine
mode).

    python -m dynamo_tpu_torch.frontend --model llama-3-1b --model-name m \\
        --http-port 8080 [--device cpu] [--num-blocks N --block-size 64]

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
    return p.parse_args(argv)


async def build_model_handle(args):
    """Returns (handle, engine core, shutdown coroutine)."""
    cfg = get_config(args.model)
    sched = SchedulerConfig(block_size=args.block_size)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=args.num_blocks, scheduler=sched,
        device=args.device))
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


async def run(args) -> None:
    handle, core, shutdown = await build_model_handle(args)
    models = ModelManager()
    models.register(handle)

    def stats() -> dict:
        return {"device": str(core.device),
                "kernels": kernels.launch_counts(),
                "counters": core.counters.as_dict()}

    def reset_stats() -> None:
        # Launch counts and engine counters start one window together, so
        # launches per dispatch can be read off one /debug/stats reply.
        kernels.reset_launch_counts()
        core.counters = EngineCounters()

    svc = HttpService(models, stats=stats, reset_stats=reset_stats)
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    try:
        port = await svc.start(args.http_host, args.http_port)
        print(f"dynamo_tpu_torch frontend serving {handle.name!r} "
              f"({args.model} on {core.device}) on "
              f"http://{args.http_host}:{port}", flush=True)
        await stop_ev.wait()
    finally:
        await svc.stop()
        await shutdown()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
