"""Where each chat's TTFT goes on a distributed stack, for several
checkouts of this repo on one card in one call: the request ledger's
phases beside the frontend's TTFT, chat by chat, with the stretches that
no phase of the JAX package's ledger covers shown as `send` and `back`.

Each checkout is run in a process of its own, in the order given (for an
A/B: old, new, new, old).  It builds that checkout's kernels and starts
`chip_smoke.py`'s `serve_observed` stack (frontend A, `--router-mode kv`,
and one llama-3-1b worker, every plane on); after the warm-up chat and a
50 ms capture, `serve`'s wave of 8 chats, WAVES times.  Per chat, from
its ledger (`/debug/requests`) and the frontend's TTFT, in ms:

- `ttft`, and `recv` / `route`: the frontend's phases; `pre_route`: the
  frontend's receive end to the route's start;
- `send`: the route's end to the worker engine's submission (the wire
  out and the worker's intake);
- `queue` / `prefill` / `first`: the worker engine's phases;
- `back`: the engine's emission of the first token to the frontend's
  receipt of it (the wire back);
- `rpc` / `hop_receive`: the port's stamps of the wire and of the
  worker's intake, where the checkout has them;
- `coverage`: the ledger's TTFT phases (the checkout's own list) over
  the TTFT.

Frontend and worker share the host's monotonic clock, so `send` and
`back` subtract one process's times from the other's.

    python3 ledger_ab.py --out smoke_out/ledger_ab.jsonl OLD NEW NEW OLD

One JSON line per chat goes to --out; standard output gets a line per
chat, then the card's `nvidia-smi` name and power limit and, last, one
JSON summary: the first chat's TTFT, dark ms (`send` + `back`, less
`rpc` and `hop_receive`) and coverage, per checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WAVES = 3


def chat_row(entry: dict, ttft_s: float, ttft_phases) -> dict:
    """One chat's ms, from its ledger payload and the frontend's TTFT."""
    first = {}
    for s in entry["stamps"]:                 # the frontend's stamp first
        first.setdefault(s["phase"], s)
    hop_receive = [s for s in entry["stamps"] if s["phase"] == "receive"][1:]
    start = first["receive"]["t"] - first["receive"]["dur"]
    route, queue = first["route"], first["queue"]
    arrival = queue["t"] - queue["dur"]
    ms = lambda x: round(x * 1e3, 3)
    return {
        "ttft": ms(ttft_s), "recv": ms(first["receive"]["dur"]),
        "pre_route": ms(route["t"] - route["dur"] - first["receive"]["t"]),
        "route": ms(route["dur"]), "send": ms(arrival - route["t"]),
        "queue": ms(queue["dur"]), "prefill": ms(first["prefill"]["dur"]),
        "first": ms(first["first_token"]["dur"]),
        "back": ms(start + ttft_s - first["first_token"]["t"]),
        "rpc": ms(first["rpc"]["dur"]) if "rpc" in first else 0.0,
        "hop_receive": ms(hop_receive[0]["dur"]) if hop_receive else 0.0,
        "coverage": sum(s["dur"] for s in entry["stamps"]
                        if s["phase"] in ttft_phases) / ttft_s}


def child(tree: Path, label: str, run: int) -> None:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.ops.cuda import build
    from dynamo_tpu_torch.runtime.ledger import TTFT_PHASES

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cs.OBSERVED_DIR.mkdir(parents=True, exist_ok=True)
    with cs.distributed_stack(workers=(("worker", cs.OBSERVED_WORKER),),
                              frontend_b=False, tag="ledger_ab",
                              frontend_args=cs.OBSERVED_FRONTEND) as (
            a, _, (w,), _):
        cs._chat(a, cs.chat_body(-1, False, 4))
        cs._get_json(w + "/debug/deviceprofile?ms=50")
        for wave in range(WAVES):
            reqs = cs.stack_wave(a, w)["reqs"]
            led = json.loads(cs._http(a + "/debug/requests?n=64"))
            by_rid = {e["request_id"]: e for e in led["slowest"]}
            for i, r in enumerate(reqs):
                print(json.dumps({
                    "tree": label, "run": run, "wave": wave, "chat": i,
                    **chat_row(by_rid[r["request_id"]], r["ttft_s"],
                               TTFT_PHASES)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--out", default="smoke_out/ledger_ab.jsonl")
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
        got = [json.loads(x) for x in res.stdout.splitlines()
               if x.startswith("{")]
        for x in got:
            print(json.dumps(x), flush=True)
        lines += got
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    summary = {}
    for x in lines:
        if x["chat"]:
            continue
        per = summary.setdefault(x["tree"], {"ttft": [], "dark": [],
                                             "coverage": []})
        per["ttft"].append(x["ttft"])
        per["dark"].append(round(x["send"] + x["back"] - x["rpc"]
                                 - x["hop_receive"], 3))
        per["coverage"].append(round(x["coverage"], 4))
    for per in summary.values():
        per["dark_median"] = statistics.median(per["dark"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"order": args.trees, "first_chat": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
