"""`python -m dynamo_tpu_torch.frontend` — OpenAI ingress, with the engine
in the same process or on workers found through the control plane (port
of `dynamo_tpu/frontend/main.py`: single-process engine mode and the
distributed mode).

    python -m dynamo_tpu_torch.frontend --model llama-3-1b --model-name m \\
        --http-port 8080 [--device cpu] [--num-blocks N --block-size 64]
    python -m dynamo_tpu_torch.frontend --model mixtral-8x7b --num-layers 16 \\
        [--moe-mode auto|dense|grouped]
    python -m dynamo_tpu_torch.frontend --model llama-3-1b --kv-quant int8
    python -m dynamo_tpu_torch.frontend --model llama-3-1b --sp 4 \
        [--max-prefill-chunk 512]
    python -m dynamo_tpu_torch.frontend --model /path/to/hf_checkpoint_dir
    python -m dynamo_tpu_torch.frontend --model model.gguf
    python -m dynamo_tpu_torch.frontend --model meta-llama/Llama-3.2-1B

Runs on the card unless `--device cpu` is given, with the prefix cache
on, as the JAX worker runs it.  `--model` takes a preset (random weights
from seed 0, `EngineConfig.seed`, and the byte tokenizer), an HF-layout
checkpoint directory (safetensors weights; its tokenizer.json, chat
template and eos from tokenizer_config.json), a `.gguf` file (the byte
tokenizer) or an `org/repo` of the local hub cache (`HF_HUB_CACHE` /
`HF_HOME`; nothing is downloaded); models/loader.py.  `--tokenizer
PATH` serves a tokenizer.json in place of the model's.  `image_url`
chat parts encode in process (the stub vision tower,
llm/multimodal.py).  `--sp N` prefills whole prompts of 256
tokens or more over a ring of N ranks, spread over the visible cards
(several ranks share a card when there are fewer cards than ranks); the
rank -> card map is logged at start and shown by `/debug/stats`.

Distributed mode (`--control-plane HOST:PORT`, or `--serve-control-plane`
to host the control plane in this process too) builds no engine: a
ModelWatcher registers each model as `dynamo_tpu_torch.worker` processes
announce it (with the tokenizer and template their cards carry), behind
migration (`--migration-limit`) and a router (`--router-mode random |
round_robin | kv`; kv routes by the prefix overlap the workers' KV
events report and their load).  `image_url` parts go to `--role encode`
workers; their embeddings come over the device plane when this
process's `--device` shares the encode worker's fabric (a card here),
else inline on the RPC:

    python -m dynamo_tpu_torch.frontend --serve-control-plane \\
        --router-mode kv --http-port 8080
    python -m dynamo_tpu_torch.worker --control-plane 127.0.0.1:4222 \\
        --model llama-3-1b --model-name m

Its `/debug/stats` reports the frontend-side per-request timings; each
worker's `--health-port` serves its engine's stats.

Backends, with JAX's out= matrix (`--out`): `auto` / `engine` build the
engine above; `echo` streams the prompt back (`llm/echo.py`); `mocker`
(or `--mocker`) serves the simulated engine, time compressed by
`--speedup-ratio`; `dyn://namespace/component/endpoint` attaches a
remote endpoint statically through `--control-plane`, without model
discovery (`--router-mode kv` then routes with `--kv-cache-block-size`,
the workers' block size).  `--max-tokens-default` caps a request that
names no max_tokens.  Ingress (`--input`): `http` (the server), `text`
(a chat REPL on stdin) or `batch` (`--batch-file` JSONL of {"prompt",
"max_tokens"?, "temperature"?} to `--batch-output`, default the input
path + `.out`, then a throughput summary line):

    python -m dynamo_tpu_torch.frontend --out echo --input batch \\
        --batch-file prompts.jsonl

Observability, with JAX's flags: `--trace [--trace-sample R
--trace-slow-ms MS --trace-ring N --trace-slow-log PATH]` (spans in
`/debug/traces`), `--slo-ttft-p99 S` / `--slo-tpot-p99 S` /
`--slo-error-rate F` (burn rates in `/debug/slo` and `dynamo_slo_*`),
`--flight-recorder on|off --flight-ring N --flight-dump-dir DIR` (the
ring in `/debug/flightrecorder`, JSONL dumps on SLO PAGE, slow requests,
SIGUSR2 and exit) and `--request-ledger on|off` (`/debug/requests`,
`dynamo_request_phase_seconds`, the goodput pair); `/metrics` serves
them all.  The single-process frontend's engine keeps its device
profiler off (workers take `--device-profiler`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import signal
import time
from typing import Optional, Tuple

from dynamo_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    InferenceEngine,
)
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.backend import StreamDetokenizer
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.kv_router.protocols import SpecDecodeStats
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    ChatMessage,
    CompletionRequest,
    request_id,
)
from dynamo_tpu_torch.llm.service import LocalEngineClient, ModelHandle, ModelManager
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.multimodal import MultimodalAttach, StubVisionEncoder
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, HFTokenizer
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.loader import resolve_config, resolve_model
from dynamo_tpu_torch.ops import cuda as kernels
from dynamo_tpu_torch.runtime import flight_recorder, ledger, slo, tracing
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

logger = logging.getLogger("dynamo_tpu_torch.frontend")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--http-host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--control-plane", default=None,
                   help="control plane HOST:PORT: discover models from "
                        "registered workers instead of building an engine")
    p.add_argument("--serve-control-plane", action="store_true",
                   help="host the control plane in this process (and "
                        "discover models through it)")
    p.add_argument("--control-plane-port", type=int, default=4222)
    p.add_argument("--control-plane-store", default=None,
                   help="control-plane persistence for unleased keys: "
                        "memory (default) or file:PATH")
    p.add_argument("--router-mode", default="round_robin",
                   choices=("random", "round_robin", "kv"))
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--out", default="auto",
                   help="backend: auto|engine = the in-process engine, "
                        "echo streams the prompt back, mocker simulates "
                        "an engine, dyn://ns/component/endpoint attaches "
                        "a remote endpoint statically (no model "
                        "discovery; needs --control-plane)")
    p.add_argument("--mocker", action="store_true",
                   help="serve the mock engine (no device); overrides "
                        "--out")
    p.add_argument("--speedup-ratio", type=float, default=10.0,
                   help="mocker: simulated time compression")
    p.add_argument("--max-tokens-default", type=int, default=512,
                   help="max_tokens of a request that names none")
    p.add_argument("--kv-cache-block-size", type=int, default=None,
                   help="the workers' KV block size for --router-mode kv "
                        "over a dyn:// attachment (discovery reads it "
                        "from the model card; a mismatch zeroes every "
                        "prefix-overlap score)")
    p.add_argument("--input", default="http",
                   choices=("http", "text", "batch"),
                   help="ingress: the HTTP server, a chat REPL on stdin, "
                        "or an offline JSONL batch")
    p.add_argument("--batch-file", default=None,
                   help="batch: JSONL input ({\"prompt\": ...} a line)")
    p.add_argument("--batch-output", default=None,
                   help="batch: JSONL output (default: input + .out)")
    p.add_argument("--model", default="llama-3-1b",
                   help="model preset (e.g. llama-3-1b, tiny-test), "
                        "HF-layout checkpoint directory, .gguf file, or "
                        "org/repo in the local hub cache")
    p.add_argument("--tokenizer", default=None,
                   help="path to a tokenizer.json (default: the model's, "
                        "else the byte tokenizer)")
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
    p.add_argument("--kv-quant", default="none", choices=("none", "int8"),
                   help="KV cache storage: int8 pages with per-token, "
                        "per-head f32 scales (about half the bytes a "
                        "decode step reads), or the model dtype")
    p.add_argument("--max-prefill-chunk", type=int, default=512,
                   help="chunked-prefill step ceiling (tokens); a longer "
                        "prompt prefills in several steps")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: whole-prompt prefills "
                        "past the engine's threshold run ring attention "
                        "over N ranks (the long-context prefill path); "
                        "decode stays on the first card")
    tracing.add_trace_args(p)
    slo.add_slo_args(p)
    flight_recorder.add_flight_args(p)
    ledger.add_ledger_args(p)
    args = p.parse_args(argv)
    # choices= cannot express the dyn:// prefix; a typo'd backend must
    # not be ignored silently.
    if (args.out not in ("auto", "engine", "mocker", "echo")
            and not args.out.startswith("dyn://")):
        p.error(f"--out {args.out!r}: expected auto|engine|mocker|echo|"
                "dyn://namespace/component/endpoint")
    return args


def model_config(args):
    """The config `--model` names (a preset's or a checkpoint's, no
    weight loaded), cut to `--num-layers` when given."""
    return resolve_config(args.model, args.num_layers)


def model_tokenizer(args, spec: dict, template):
    """(tokenizer, chat template) to serve: `--tokenizer` first, then the
    model's own (a checkpoint's tokenizer.json), else the byte one."""
    if args.tokenizer:
        return HFTokenizer(args.tokenizer), None
    if spec.get("kind", "byte") != "byte":
        card = ModelDeploymentCard(name=args.model_name, tokenizer_spec=spec,
                                   chat_template=template)
        return card.build_tokenizer(), template
    return ByteTokenizer(), None


async def build_model_handle(args):
    """Returns (handle, engine core or None, shutdown coroutine), the
    backend chosen by `--out` (or `--mocker`)."""
    out = "mocker" if args.mocker else args.out
    tokenizer, _ = model_tokenizer(args, {"kind": "byte"}, None)
    pre = OpenAIPreprocessor(tokenizer,
                             default_max_tokens=args.max_tokens_default)
    if out == "mocker":
        from dynamo_tpu_torch.llm.mocker import MockEngine, MockEngineArgs

        engine = MockEngine(MockEngineArgs(block_size=args.block_size,
                                           speedup_ratio=args.speedup_ratio))
        await engine.start()
        return (ModelHandle(name=args.model_name, tokenizer=tokenizer,
                            preprocessor=pre, client=engine),
                None, engine.stop)
    if out == "echo":
        from dynamo_tpu_torch.llm.echo import EchoEngine

        async def noop():
            return None

        return (ModelHandle(name=args.model_name, tokenizer=tokenizer,
                            preprocessor=pre, client=EchoEngine()),
                None, noop)
    if out.startswith("dyn://"):
        handle, shutdown = await attach_static_remote(args, tokenizer, pre)
        return handle, None, shutdown
    t0 = time.monotonic()
    cfg, params, spec, template = resolve_model(
        args.model, device=args.device, num_layers=args.num_layers)
    if params is not None:
        logger.info("loaded %s in %.2f s", args.model, time.monotonic() - t0)
    tokenizer, template = model_tokenizer(args, spec, template)
    pre = OpenAIPreprocessor(tokenizer, chat_template=template,
                             default_max_tokens=args.max_tokens_default)
    sched = SchedulerConfig(block_size=args.block_size,
                            max_prefill_chunk=args.max_prefill_chunk)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=args.num_blocks, scheduler=sched,
        device=args.device, moe_mode=args.moe_mode, kv_quant=args.kv_quant,
        sp=args.sp), params=params)
    engine = InferenceEngine(core)
    await engine.start()
    handle = ModelHandle(
        name=args.model_name, tokenizer=tokenizer, preprocessor=pre,
        client=LocalEngineClient(engine),
        max_context=min(cfg.max_context,
                        sched.max_pages_per_seq * sched.block_size),
        # image_url parts encode in process (the stub vision tower).
        multimodal=MultimodalAttach(
            local_encoder=StubVisionEncoder(cfg.hidden_size)))
    return handle, core, engine.stop


async def attach_static_remote(args, tokenizer, pre):
    """`--out dyn://ns/component/endpoint`: route to a known endpoint with
    no model discovery (the card, and so the tokenizer, stay local), under
    the same operator graph as discovery mode.  Returns (handle, shutdown
    coroutine)."""
    if not args.control_plane:
        raise SystemExit("--out dyn://... needs --control-plane")
    parts = args.out[len("dyn://"):].split("/")
    if len(parts) != 3 or not all(parts):
        raise SystemExit(f"--out {args.out!r}: expected "
                         "dyn://namespace/component/endpoint")
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.pipeline import (
        KvRouterOp, MigrationOp, Pipeline, RemoteOp)

    host, _, port = args.control_plane.rpartition(":")
    cp = ControlPlaneClient(host or "127.0.0.1", int(port))
    await cp.start()
    runtime = DistributedRuntime(cp)
    endpoint = (runtime.namespace(parts[0]).component(parts[1])
                .endpoint(parts[2]))
    client = await endpoint.client(
        "round_robin" if args.router_mode == "kv" else args.router_mode)
    # The block size must be the workers' (discovery mode reads the card;
    # a static attachment cannot, so it is a flag).
    if args.router_mode == "kv" and args.kv_cache_block_size is None:
        logger.warning("dyn:// with --router-mode kv: assuming workers use "
                       "--block-size %d; pass --kv-cache-block-size if not "
                       "(a mismatch zeroes every prefix-overlap score)",
                       args.block_size)
    router_op = (KvRouterOp(runtime, block_size=(args.kv_cache_block_size
                                                 or args.block_size))
                 if args.router_mode == "kv" else RemoteOp())
    pipeline = Pipeline([MigrationOp(limit=args.migration_limit), router_op])
    engine_client = await pipeline.attach(client)

    async def shutdown():
        await pipeline.stop()
        await client.stop()
        await runtime.shutdown()
        await cp.close()

    return (ModelHandle(name=args.model_name, tokenizer=tokenizer,
                        preprocessor=pre, client=engine_client), shutdown)


async def _wait_for_model(models: ModelManager, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        names = models.names()
        if names:
            return models.get(names[0])
        await asyncio.sleep(0.1)
    raise TimeoutError("no model became available")


async def _completion_text(handle, pre, on_text=None) -> Tuple[str, object]:
    """Stream one preprocessed request, each piece of text to `on_text`
    as it arrives; (its text, the detokenizer)."""
    det = StreamDetokenizer(handle.tokenizer, pre.stop_sequences)
    parts = []
    async for delta in handle.client.generate(pre):
        if delta.token_ids:
            out = det.push_tokens(delta.token_ids)
            if out.text:
                parts.append(out.text)
                if on_text is not None:
                    on_text(out.text)
            if out.finished:
                break
        if delta.finished:
            break
    return "".join(parts), det


def _read_prompt():
    try:
        return input("> ")
    except EOFError:
        return None


async def run_text_repl(models: ModelManager) -> None:
    """Interactive chat REPL on stdin/stdout: one exchange a line; Ctrl-D
    or /quit exits, /clear resets the conversation."""
    handle = await _wait_for_model(models)
    print(f"chat with {handle.name!r} — /quit exits, /clear resets",
          flush=True)
    history = []
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, _read_prompt)
        if line is None or line.strip() == "/quit":
            return
        if line.strip() == "/clear":
            history = []
            print("(history cleared)", flush=True)
            continue
        if not line.strip():
            continue
        history.append(ChatMessage(role="user", content=line))
        pre = handle.preprocessor.preprocess_chat(
            ChatCompletionRequest(model=handle.name, messages=history),
            request_id("repl"))
        text, _ = await _completion_text(
            handle, pre, lambda t: print(t, end="", flush=True))
        print(flush=True)
        history.append(ChatMessage(role="assistant", content=text))


async def run_batch(models: ModelManager, batch_file: str,
                    batch_output: str, concurrency: int = 32) -> dict:
    """Offline batch inference: JSONL in ({"prompt", "max_tokens"?,
    "temperature"?}), JSONL out (each row plus "completion" and its token
    counts, or "error"), and a throughput summary printed and returned.
    One bad row never aborts the others."""
    handle = await _wait_for_model(models)
    with open(batch_file) as f:
        jobs = [json.loads(line) for line in f if line.strip()]
    sem = asyncio.Semaphore(concurrency)
    results = [None] * len(jobs)
    t0 = time.monotonic()

    async def one(i, job):
        async with sem:
            try:
                pre = handle.preprocessor.preprocess_completion(
                    CompletionRequest(
                        model=handle.name, prompt=job["prompt"],
                        max_tokens=job.get("max_tokens", 128),
                        temperature=job.get("temperature", 0.0)),
                    request_id(f"batch{i}"))
                text, det = await _completion_text(handle, pre)
                results[i] = {**job, "completion": text,
                              "prompt_tokens": len(pre.token_ids),
                              "completion_tokens": det.completion_tokens}
            except Exception as e:
                results[i] = {**job, "error": f"{type(e).__name__}: {e}",
                              "completion_tokens": 0}

    await asyncio.gather(*(one(i, j) for i, j in enumerate(jobs)))
    elapsed = time.monotonic() - t0
    out_tokens = sum(r["completion_tokens"] for r in results)
    with open(batch_output, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    summary = {"requests": len(jobs), "output_tokens": out_tokens,
               "elapsed_s": round(elapsed, 3),
               "tok_s": round(out_tokens / elapsed, 2) if elapsed else 0.0}
    print(json.dumps(summary), flush=True)
    return summary


def spec_decode_stats(core: EngineCore) -> Optional[dict]:
    """Speculative decode's draft counts and acceptance rate (accepted
    over drafted tokens), or None when it is off."""
    st = core.metrics.spec_decode_stats
    if st is None:
        return None
    out = dataclasses.asdict(st)
    out["k"] = core.config.speculative_tokens
    out["acceptance_rate"] = (st.num_accepted_tokens / st.num_drafts
                              if st.num_drafts else 0.0)
    return out


def stats_hooks(core: EngineCore):
    """The `/debug/stats` reply and the `/debug/stats/reset` action over
    one engine."""

    def stats() -> dict:
        load = core.snapshot_expert_load()
        return {"device": str(core.device),
                "kernels": kernels.launch_counts(),
                "counters": core.counters.as_dict(),
                "kv_quant": core.cache_cfg.kv_quant,
                # Ring prefill: the degree and the rank -> device map.
                "sp": core.config.sp,
                "sp_devices": (core.ring.describe() if core.ring is not None
                               else []),
                "prefix_cache": core.prefix_cache_stats(),
                "spec_decode": spec_decode_stats(core),
                "mixed_prefill": core.mixed_prefill_stats(),
                "moe_mode": core.moe_mode,
                # [E+1]: per-expert assignments, then the dropped ones.
                "expert_load": (None if load is None else
                                [int(x) for x in load]
                                + [core.moe_dropped_tokens])}

    def reset_stats() -> None:
        # Launch counts, engine counters, the expert load and the prefix
        # hit and miss tokens start one window together, so launches per
        # dispatch can be read off one /debug/stats reply.
        kernels.reset_launch_counts()
        core.reset_expert_load()
        core.reset_prefix_stats()
        # The cost calibration and the shapes seen are engine state, not
        # statistics: they carry over.
        core.counters.reset_counts()
        if core.metrics.spec_decode_stats is not None:
            core.metrics.spec_decode_stats = SpecDecodeStats()

    return stats, reset_stats


def mm_transfer_plane(device: str):
    """The device plane a distributed frontend pulls encode workers'
    embeddings over, made at the first image; None where `--device`
    names a card this process does not have (the embeddings then ride the
    RPC inline, as to any plane-less peer)."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        logger.info("no card in this process: multimodal embeddings ride "
                    "the RPC inline")
        return None
    plane = dt.KvTransferPlane(device=resolve_device(device))
    plane.start()
    return plane


async def start_discovery(args, models: ModelManager, registry=None):
    """Distributed mode: watch the control plane's `models/` prefix and
    register each model's routed pipeline (the router's and migration's
    series on `registry`); returns the watcher and the shutdown
    coroutines, outermost first."""
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    host, _, port = args.control_plane.rpartition(":")
    cp = ControlPlaneClient(host, int(port))
    await cp.start()
    runtime = DistributedRuntime(cp)
    watcher = ModelWatcher(runtime, models, router_mode=args.router_mode,
                           migration_limit=args.migration_limit,
                           registry=registry,
                           mm_plane=lambda: mm_transfer_plane(args.device))
    await watcher.start()
    return watcher, [watcher.stop, runtime.shutdown, cp.close]


async def run(args) -> None:
    tracing.configure_from_args(args, service="frontend")
    # The frontend's flight recorder holds SLO transitions and slow
    # requests; crash / SIGUSR2 / exit dumps armed here.
    flight_recorder.configure_from_args(
        args, service="frontend").install_crash_dump()
    ledger.configure_from_args(args)
    # One registry for the process: the HTTP series and the router's.
    registry = MetricsRegistry()
    shutdowns = []
    if args.serve_control_plane:
        from dynamo_tpu_torch.runtime.control_plane import ControlPlaneState
        from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneServer
        from dynamo_tpu_torch.runtime.kv_store import make_backend

        cp_server = ControlPlaneServer(ControlPlaneState(
            backend=make_backend(args.control_plane_store)))
        cp_port = await cp_server.start(port=args.control_plane_port)
        args.control_plane = args.control_plane or f"127.0.0.1:{cp_port}"
        print(f"control plane on 127.0.0.1:{cp_port}", flush=True)
        shutdowns.append(cp_server.stop)
    models = ModelManager()
    cp_client = None
    if args.out.startswith("dyn://") and not args.mocker:
        handle, _, shutdown = await build_model_handle(args)
        models.register(handle)
        shutdowns.insert(0, shutdown)
        svc = HttpService(models, registry=registry)
        banner = f"static remote {args.out} as {handle.name!r}"
    elif args.control_plane:
        watcher, stops = await start_discovery(args, models, registry)
        cp_client = watcher.runtime.cp
        shutdowns[:0] = stops
        # Beside the request timings: the blocks the KV router indexes
        # per model and worker.
        svc = HttpService(models, stats=lambda: {
            "kv_index": watcher.kv_index_blocks(),
            "plane_counts": dt.plane_counts_by_plane()}, registry=registry)
        banner = (f"discovering models via {args.control_plane} (router "
                  f"{args.router_mode})")
    else:
        handle, core, shutdown = await build_model_handle(args)
        models.register(handle)
        shutdowns.append(shutdown)
        if core is None:
            # No engine here: the stats say that nothing launched.
            svc = HttpService(models, stats=lambda: {
                "kernels": kernels.launch_counts()}, registry=registry)
            banner = (f"serving {handle.name!r} "
                      f"({'mocker' if args.mocker else args.out})")
        else:
            stats, reset_stats = stats_hooks(core)
            svc = HttpService(models, stats=stats, reset_stats=reset_stats,
                              registry=registry)
            cfg = core.config.model
            banner = (f"serving {handle.name!r} ({args.model}, "
                      f"{cfg.num_layers} layers, moe_mode {core.moe_mode}, "
                      f"kv_quant {core.cache_cfg.kv_quant}, on {core.device}"
                      + (f", sp {core.ring.sp} ranks on "
                         f"{core.ring.describe()}"
                         if core.ring is not None else "") + ")")
    if args.input != "http":
        try:
            await run_ingress(args, models)
        finally:
            for shutdown in shutdowns:
                await shutdown()
        return
    # Goodput: the ledger sink judges requests by the SLO thresholds;
    # the monitor's PAGEs name the dominant ledger phase.
    svc.ledger_sink.slo_ttft = args.slo_ttft_p99
    svc.ledger_sink.slo_tpot = args.slo_tpot_p99
    svc.slo_monitor = slo.monitor_from_args(
        args, svc.request_metrics, registry=registry,
        attribution_fn=svc.ledger_sink.dominant_phase)
    if svc.slo_monitor is not None:
        svc.slo_monitor.start(interval=args.slo_tick)
        shutdowns.insert(0, svc.slo_monitor.stop)
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    try:
        port = await svc.start(args.http_host, args.http_port)
        if cp_client is not None:
            # Fleet discovery: the metrics aggregator, the planner and
            # `dynamo top` find this frontend under status_endpoints/ as
            # they find a worker (retried: a control plane mid-restart
            # must not crash the frontend).
            from dynamo_tpu_torch.runtime.status import (
                register_status_endpoint_task)

            adv_host = args.http_host
            if adv_host in ("0.0.0.0", "::", ""):
                logger.warning(
                    "--http-host %s is a wildcard bind; advertising "
                    "127.0.0.1 under status_endpoints/ — pass a routable "
                    "--http-host for cross-host scraping", adv_host)
                adv_host = "127.0.0.1"
            reg_task = register_status_endpoint_task(
                cp_client, "frontend", port, host=adv_host)
            shutdowns.insert(0, _cancel_coro(reg_task))
        print(f"dynamo_tpu_torch frontend {banner} on "
              f"http://{args.http_host}:{port}", flush=True)
        await stop_ev.wait()
    finally:
        await svc.stop()
        for shutdown in shutdowns:
            await shutdown()


async def run_ingress(args, models: ModelManager) -> None:
    """`--input text` or `--input batch` to its end, or until SIGINT /
    SIGTERM, which still runs the caller's shutdown path."""
    if args.input == "batch" and not args.batch_file:
        raise SystemExit("--input batch requires --batch-file")
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    work = asyncio.create_task(
        run_text_repl(models) if args.input == "text" else run_batch(
            models, args.batch_file,
            args.batch_output or args.batch_file + ".out"))
    stop_wait = asyncio.create_task(stop_ev.wait())
    await asyncio.wait({work, stop_wait}, return_when=asyncio.FIRST_COMPLETED)
    stop_wait.cancel()
    if work.done():
        work.result()          # surface the batch's or the REPL's error
    else:
        work.cancel()


def _cancel_coro(task):
    async def cancel():
        task.cancel()
    return cancel


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
