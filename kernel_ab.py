"""Time K1 (paged decode attention) and K3 (the grouped expert FFN) of
several checkouts of this repo on one card, in one call, so that two
versions of a kernel are compared on the same card, inputs and timers.

Each checkout is run in a process of its own, in the order given (for an
A/B: old, new, new, old), which builds the kernels from that checkout's
sources and times its wrappers at chip_smoke.py's shapes, on inputs made
by chip_smoke.py's own builders from one seed a case, with chip_smoke.py's
timers: K1 by CUDA-graph replay (`graph_ms`) and by an eager loop
(`time_ms`), K3 by the eager loop.  Each output is held against the
checkout's plain version first, with chip_smoke.py's limits.

    python3 kernel_ab.py --out chiprun_out/kernel_ab.jsonl OLD NEW NEW OLD

OLD and NEW are checkout roots (a `git archive` of a commit unpacked into
a directory works).  One JSON line per checkout and case goes to --out;
the last lines of standard output are the card's `nvidia-smi` name and
power limit and one JSON summary: each case's median per checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py of this script's own checkout, loaded by path (the
    checkout being timed may hold a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs):
    """(kernel, shape) of every case, in a fixed order."""
    out = []
    for quant in (False, True):
        for d in (64, 128):
            for B, ctx in cs.DECODE_SHAPES:
                out.append(("paged_decode_attention" + ("_int8" if quant else ""),
                            {"B": B, "ctx": ctx, "D": d}))
    for name in ("moe_grouped", "moe_grouped_int8"):
        for n in cs.MOE_TOKENS:
            out.append((name, {"tokens": n}))
    return out


def child(tree: Path, label: str, run: int) -> None:
    """Time every case with the kernels of the checkout at `tree`."""
    sys.path.insert(0, str(tree))
    import torch

    import dynamo_tpu_torch
    from dynamo_tpu_torch.ops.cuda import (grouped_expert_ffn,
                                           grouped_expert_ffn_plain,
                                           paged_decode_attention,
                                           paged_decode_attention_plain)

    pkg = Path(dynamo_tpu_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        raise SystemExit(f"dynamo_tpu_torch came from {pkg}, not {tree}")
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = None
    for i, (name, shape) in enumerate(cases(cs)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + i)
        quant = name.endswith("_int8")
        if name.startswith("paged_decode"):
            a = cs.decode_inputs(torch, gen, shape["D"], quant, shape["B"],
                                 shape["ctx"])
            ops = (a["q"], a["kc"], a["vc"], a["bt"], a["sl"])

            def kern():
                return paged_decode_attention(*ops, block_size=cs.BS,
                                              **a["sc"])

            ref = paged_decode_attention_plain(*ops, block_size=cs.BS,
                                               **a["sc"])
        else:
            if moe is None:
                moe = cs.moe_weights(torch, gen)
            p = moe[1] if quant else moe[0]
            a = cs.moe_inputs(torch, gen, p, shape["tokens"])

            def kern():
                return grouped_expert_ffn(*a["args"], tile_rows=a["tile_rows"],
                                          **a["scales"])

            ref = grouped_expert_ffn_plain(*a["args"], tile_rows=a["tile_rows"],
                                           **a["scales"])
        out = kern()
        torch.cuda.synchronize()
        reading = cs.closeness(torch, f"{label} {name}", out, ref, name)
        line = {"tree": label, "run": run, "kernel": name, "shape": shape,
                "max_abs_err": reading["max_abs_err"],
                "row_rel_err": reading["row_rel_err"],
                "eager_ms": cs.time_ms(torch, kern)}
        if name.startswith("paged_decode"):
            line["graph_ms"] = cs.graph_ms(torch, kern)
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.jsonl")
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
        key = f"{x['kernel']} {json.dumps(x['shape'], sort_keys=True)}"
        per = summary.setdefault(key, {}).setdefault(x["tree"], {})
        for t in ("graph_ms", "eager_ms"):
            if t in x:
                per.setdefault(t, []).append(x[t])
    for per in summary.values():
        for times in per.values():
            for t, v in times.items():
                times[t] = {"median": statistics.median(v), "runs": v}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"order": args.trees, "cases": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
