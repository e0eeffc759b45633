"""Time the meshless forward and engine of several checkouts of this repo
on one card, in one call, so that a change to the forward's host code is
compared with its parent on the same card, weights, inputs and timers.

Each checkout is run in a process of its own, in the order given (for an
A/B: old, new, new, old).  It builds K1 and K2 from that checkout's
sources, draws llama-3-1b's seed-0 weights on the card, and times, with
that checkout's code:

- `forward`: the decode step (`make_forward_step`, K1) at B rows of CTX
  cached tokens, R repeats of N calls queued back to back after a sync:
  host ms a call (the host clock over the N calls: the rate at which
  the host queues the step) and device ms a call (CUDA events around
  the N calls: equal to the host's where the host is the bound), each
  the median and the least of the R repeats (the least is the one that
  other processes on the host's cores disturbed least);
- `wave`: B greedy requests of P prompt tokens and M new tokens each,
  added at once to an `EngineCore` (prefix cache off) and stepped to
  their end, after one untimed wave: wall, TTFT mean, ITL mean (each
  request's first to last token over its tokens after the first) and
  tokens a second, from the host clock at each step's deltas.

    python3 step_ab.py --out smoke_out/step_ab.jsonl OLD NEW NEW OLD

OLD and NEW are checkout roots (a `git archive` of a commit unpacked into
a directory works).  One JSON line per checkout and run goes to --out;
the last lines of standard output are the card's `nvidia-smi` name and
power limit and one JSON summary: each metric's median per checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED, BS = 0, 64
B, CTX, N, R = 8, 1024, 30, 7    # forward: rows, cached tokens, calls,
                                 # repeats
P, M, WAVES = 128, 64, 3         # wave: prompt tokens, new tokens, repeats
METRICS = ("forward_host_ms", "forward_host_min_ms", "forward_device_ms",
           "forward_device_min_ms", "wave_wall_s", "wave_ttft_mean_s",
           "wave_itl_mean_s", "wave_tok_s")


def forward_ms(torch, cfg, state) -> dict:
    """Host and device ms a call of the decode step, N calls queued, the
    median and the least of R repeats."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    pages = CTX // BS
    cache = kvc.init_cache(kvc.KvCacheConfig.for_model(
        cfg, num_blocks=B * pages + 1, block_size=BS), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bt = torch.arange(1, B * pages + 1, **i32).view(B, pages)
    lens = torch.full((B,), CTX, **i32)
    args = (torch.arange(3, 3 + B, **i32)[:, None], (lens - 1)[:, None],
            lens, bt, torch.zeros(B, **i32))
    step = llama.make_forward_step(cfg, BS, use_decode_kernel=True)
    for _ in range(3):
        step(state, cache, *args)
    host, device = [], []
    for _ in range(R):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(N):
            step(state, cache, *args)
        host.append((time.perf_counter() - t0) * 1e3 / N)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / N)
    return {"forward_host_ms": statistics.median(host),
            "forward_host_min_ms": min(host),
            "forward_device_ms": statistics.median(device),
            "forward_device_min_ms": min(device),
            "forward_host_runs": host}


def wave(core, sampling_cls, tag: str) -> dict:
    """B requests at once, stepped to their end; host-clock timings."""
    vocab = core.config.model.vocab_size
    t0 = time.perf_counter()
    for i in range(B):
        core.add_request(f"{tag}{i}",
                         [(7 + 31 * i + j) % vocab for j in range(P)],
                         sampling_cls(max_tokens=M))
    stamps = {}
    while core.has_work:
        deltas = core.step()
        now = time.perf_counter()
        for d in deltas:
            if d.token_ids:
                stamps.setdefault(d.request_id, []).append(
                    (now, len(d.token_ids)))
    wall = time.perf_counter() - t0
    ttft = [s[0][0] - t0 for s in stamps.values()]
    itl = [(s[-1][0] - s[0][0]) / (sum(n for _, n in s) - s[0][1])
           for s in stamps.values()]
    tokens = sum(n for s in stamps.values() for _, n in s)
    if tokens != B * M:
        raise SystemExit(f"wave {tag}: {tokens} tokens, want {B * M}")
    return {"wave_wall_s": wall, "wave_ttft_mean_s": statistics.mean(ttft),
            "wave_itl_mean_s": statistics.mean(itl),
            "wave_tok_s": tokens / wall}


def child(tree: Path, label: str, run: int) -> None:
    """Time the forward and the engine of the checkout at `tree`."""
    sys.path.insert(0, str(tree))
    import torch

    import dynamo_tpu_torch
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.weights import init_params

    pkg = Path(dynamo_tpu_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        raise SystemExit(f"dynamo_tpu_torch came from {pkg}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-3-1b")
    dev = torch.device("cuda")
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    line = {"tree": label, "run": run, "B": B, "ctx": CTX, "calls": N,
            "repeats": R, "prompt": P, "new_tokens": M,
            **forward_ms(torch, cfg, state)}
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=B * (P + M) // BS + 16, device="cuda",
        enable_prefix_cache=False,
        scheduler=SchedulerConfig(block_size=BS)), params=state)
    wave(core, SamplingParams, "warm")
    waves = [wave(core, SamplingParams, f"w{k}-") for k in range(WAVES)]
    for k in waves[0]:
        line[k] = statistics.median(w[k] for w in waves)
    line["waves"] = waves
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--out", default="smoke_out/step_ab.jsonl")
    ap.add_argument("--child", nargs=3, metavar=("TREE", "LABEL", "RUN"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        tree, label, run = args.child
        child(Path(tree), label, int(run))
        return 0
    if not args.trees:
        ap.error("give at least one checkout root")
    lines = []
    for run, tree in enumerate(args.trees):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(Path(tree).resolve()), tree, str(run)],
            cwd=str(Path(tree).resolve()), capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            print(json.dumps({"failed": tree, "run": run,
                              "rc": res.returncode}), flush=True)
            return 1
        lines += [json.loads(x) for x in res.stdout.splitlines()
                  if x.startswith("{")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    summary = {}
    for x in lines:
        per = summary.setdefault(x["tree"], {})
        for k in METRICS:
            per.setdefault(k, []).append(x[k])
    for per in summary.values():
        for k, v in per.items():
            per[k] = {"median": statistics.median(v), "runs": v}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"order": args.trees, "trees": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
