"""The port's multi-process lockstep (parallel/multihost.py) on the CPU
rig: two processes, gloo between them, each owning half of the rank grid.
The processes are `tests/torch_mh_runner.py` (the port alone, no JAX) or
the port's worker; every pair runs under its own deadline, is killed on
failure and reports both processes' output.

1. The lockstep frames round-trip through the port's codec and decode to
   the objects JAX's msgpack frames decode to; `encode_sampling` is
   JAX's dict; `encode_blocks` carries bf16 through the transfer plane's
   wire encoding.
2. A dp 2 x tp 4 engine over 2 processes x 4 ranks gives the tokens of
   JAX's single-process 8-device engine on JAX's workload
   (tests/test_multihost.py `_single_process_reference`: its prompts and
   sampling) in JAX's four modes: plain, prefix, dp_attention and
   fused_int8; the follower ends holding no request and replayed every
   op the leader broadcast.  JAX's seeded stochastic row (req-c) draws
   from threefry bits the port cannot reproduce (engine/sampling.py), so
   that row is held against the port's one-process grid engine, which
   keeps the same (seed, token index) law; the greedy rows against JAX.
   A cancel is replayed.
3. The tp 2, dp 2 and dp 2 x tp 2 grids split over 2 processes compute
   the one-process grid's packed-prefill and decode logits and window
   tokens bit for bit, f32 and bf16 (the bf16 runs on an int8 cache), and
   tiny-moe's ("dense" MoE) with every step's expert load;
   the wire blocks extracted from a spanning grid's copies (plain dp x
   tp, dp-attention, dp-local; bf16 and int8) equal the one-process
   grid's, and a block injected into both reads back equal.
4. The refusals: JAX's words for pp, spec, embeddings and multimodal
   under multihost, for a meshless engine and a mesh on rank 0's devices
   alone, for a follower without --lockstep; ep and sp across processes
   name ROADMAP.md A7.6.
5. (`e2e`) A disaggregated decode on a 2-process tp 2 worker behind the
   port's frontend answers with the tokens of a single-process tp 2
   worker, as JAX's `test_disagg_decode_on_two_process_mesh`.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import make_mesh
from dynamo_tpu.parallel import multihost as jmh
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.parallel import multihost
from dynamo_tpu_torch.parallel.mesh import DpGrid, MeshConfig
from dynamo_tpu_torch.runtime.rpc import packb, unpackb
from dynamo_tpu_torch.worker import main as worker_main
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "torch_mh_runner.py"
PAIR_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _pair(*args) -> tuple:
    """Run the runner's follower then leader with `args`; (leader output,
    follower output).  Both are killed at the pair's deadline, and a
    failure shows both outputs."""
    procs = []
    for role in ("follower", "leader"):
        procs.append(subprocess.Popen(
            [sys.executable, str(RUNNER), args[0], role, *map(str, args[1:])],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + PAIR_TIMEOUT_S
    outs = ["", ""]
    try:
        for i in (1, 0):
            outs[i], _ = procs[i].communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    fo, lo = outs
    assert procs[1].returncode == 0, f"leader failed:\n{lo}\n--follower--\n{fo}"
    assert procs[0].returncode == 0, f"follower failed:\n{fo}\n--leader--\n{lo}"
    return lo, fo


def _line(out: str, tag: str):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise AssertionError(f"no {tag} line in:\n{out}")


# ---------------------------------------------------------------------------
# 1. Frames

BLOCKS = {
    7: np.arange(2 * 2 * 3 * 8, dtype=np.float32).reshape(1, 2, 2, 3, 8),
    2 ** 63 + 5: np.arange(-40, 56, dtype=np.int8).reshape(1, 2, 2, 3, 8),
}
FRAMES = [
    {"op": "step"},
    {"op": "stop"},
    {"op": "clear"},
    {"op": "cancel", "rid": "req-a"},
    {"op": "export", "hashes": [1, 2 ** 64 - 1, 12345]},
    {"op": "add", "rid": "r1", "prompt": [1, 2, 3], "priority": 0,
     "sampling": {"temperature": 0.8, "top_k": 20, "top_p": 0.5,
                  "max_tokens": 12, "stop_token_ids": [2], "seed": 1234,
                  "logprobs": True, "seed_offset": 3}},
]


@pytest.mark.parametrize("frame", FRAMES, ids=[f["op"] for f in FRAMES])
def test_frames_decode_to_jax_msgpack_objects(frame):
    want = msgpack.unpackb(msgpack.packb(frame, use_bin_type=True),
                           raw=False)
    assert unpackb(packb(frame)) == want


def test_import_frame_equals_jax_and_carries_bf16():
    """`encode_blocks` is JAX's {hash: (bytes, dtype, shape)} for the
    dtypes numpy holds, and a bf16 block round-trips bit for bit."""
    tblocks = {h: torch.from_numpy(a) for h, a in BLOCKS.items()}
    frame = {"op": "import", "blocks": multihost.encode_blocks(tblocks)}
    jframe = {"op": "import", "blocks": jmh.encode_blocks(BLOCKS)}
    want = msgpack.unpackb(msgpack.packb(jframe, use_bin_type=True),
                           raw=False)
    assert unpackb(packb(frame)) == want
    bf = torch.randn(2, 2, 2, 4, 8).to(torch.bfloat16)
    wire = unpackb(packb(multihost.encode_blocks({9: bf})))
    back = multihost.decode_blocks(wire)[9]
    assert back.dtype == torch.bfloat16 and torch.equal(back, bf)


def test_encode_sampling_equals_jax():
    for kw in ({}, dict(temperature=0.8, top_k=20, top_p=0.9, seed=1234,
                        max_tokens=7, stop_token_ids=(3, 4), logprobs=True,
                        seed_offset=5)):
        got = multihost.encode_sampling(SamplingParams(**kw))
        assert got == jmh.encode_sampling(JaxSamplingParams(**kw))
        assert multihost._decode_sampling(got) == SamplingParams(**kw)


def test_backend_rule():
    assert multihost.pick_backend(["cpu", "cpu"]) == "gloo"
    assert multihost.pick_backend(["GPU-a", "GPU-a"]) == "gloo"
    assert multihost.pick_backend(["GPU-a", "GPU-b"]) == "nccl"


# ---------------------------------------------------------------------------
# 2. The engine against JAX's single-process engine

PROMPTS = {
    "req-a": [1, 2, 3, 4, 5, 6, 7, 8],
    "req-b": [9, 8, 7, 6, 5],
    "req-c": [42, 43],
}


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """JAX's tiny-test draw, and the port's state of it saved for the
    runner processes."""
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    path = tmp_path_factory.mktemp("mh") / "state.pt"
    torch.save(from_jax_params(jax.device_get(params), "cpu"), path)
    return params, path


def _sampling(cls, mode: str) -> dict:
    """JAX's workload's sampling: req-c seeded stochastic but under
    fused_int8, which keeps every row greedy."""
    sampled = ({} if mode == "fused_int8"
               else {"req-c": cls(temperature=0.8, top_k=20, seed=1234,
                                  max_tokens=12)})
    return {rid: sampled.get(rid, cls(max_tokens=12)) for rid in PROMPTS}


def _drive(core, sampling: dict) -> dict:
    for rid, toks in PROMPTS.items():
        core.add_request(rid, toks, sampling[rid])
    out = {rid: [] for rid in PROMPTS}
    steps = 0
    while core.has_work and steps < 200:
        for d in core.step():
            out[d.request_id].extend(d.token_ids)
        steps += 1
    return out


def _port_reference(path, mode: str):
    """The same engine on a one-process dp 2 x tp 4 grid."""
    core = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        dp=2, tp=4, dp_attention=mode == "dp_attention",
        enable_prefix_cache=mode == "prefix",
        kv_quant="int8" if mode == "fused_int8" else "none",
        scheduler=SchedulerConfig(block_size=16)), params=torch.load(path))
    if mode == "fused_int8":
        core._window_eligible = lambda plan: False
    return _drive(core, _sampling(SamplingParams, mode))


def _jax_reference(params, mode: str):
    """JAX's `_single_process_reference` on the test's 8-device mesh,
    with explicit params."""
    mesh = make_mesh(JaxMeshConfig(dp=2, tp=4), jax.devices())
    core = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64, mesh=mesh,
        use_pallas_decode=False,
        dp_attention=(mode == "dp_attention"),
        enable_prefix_cache=(mode == "prefix"),
        kv_quant="int8" if mode == "fused_int8" else "none",
        decode_window=1 if mode == "fused_int8" else 4,
        scheduler=JaxSchedulerConfig(block_size=16)), params=params)
    return _drive(core, _sampling(JaxSamplingParams, mode))


@pytest.mark.parametrize("mode", ["plain", "prefix", "dp_attention",
                                  "fused_int8"])
def test_two_process_engine_matches_jax_single_process(jax_params, mode):
    params, path = jax_params
    lo, fo = _pair("engine", _free_port(), _free_port(), mode, path, 2, 4)
    got = _line(lo, "LEADER_TOKENS")
    want = _jax_reference(params, mode)
    greedy = [r for r in PROMPTS if mode == "fused_int8" or r != "req-c"]
    assert {r: got[r] for r in greedy} == {r: want[r] for r in greedy}
    assert got == _port_reference(path, mode)
    assert all(len(v) == 12 for v in got.values())
    assert _line(fo, "FOLLOWER_DONE") == []
    ops = _line(lo, "LEADER_OPS")
    assert _line(fo, "FOLLOWER_OPS") == ops
    assert ops["add"] == 3 and ops["step"] > 0 and ops["stop"] == 1
    lead, follow = _line(lo, "LEADER_STATS"), _line(fo, "FOLLOWER_STATS")
    assert lead["owned_ranks"] == [0, 1, 2, 3]
    assert follow["owned_ranks"] == [4, 5, 6, 7]
    assert lead["backend"] == follow["backend"] == "gloo"
    assert lead["broadcasts"] == sum(ops.values()) - 1    # before "stop"
    assert lead["collectives"] == follow["collectives"] > 0


def test_cancel_is_replayed(jax_params):
    _, path = jax_params
    lo, fo = _pair("engine", _free_port(), _free_port(), "cancel", path, 2, 4)
    ops = _line(lo, "LEADER_OPS")
    assert ops["cancel"] == 1 and _line(fo, "FOLLOWER_OPS") == ops
    assert _line(fo, "FOLLOWER_DONE") == []
    got = _line(lo, "LEADER_TOKENS")
    assert 0 < len(got["req-x"]) < 40
    assert all(len(got[r]) == 12 for r in PROMPTS)


# ---------------------------------------------------------------------------
# 3. Bit for bit against the one-process grid


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_spanning_grid_logits_equal_one_process_grid(jax_params, dtype, dp,
                                                     tp):
    _, path = jax_params
    lo, _ = _pair("logits", _free_port(), dtype, path, dp, tp)
    assert _line(lo, "LOGITS_EQUAL") == [True] * 4
    stats = _line(lo, "LEADER_STATS")
    assert stats["owned_ranks"] == list(range(dp * tp // 2))
    assert stats["collectives"] > 0


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_spanning_grid_moe_logits_and_loads_equal_one_process_grid(dp, tp):
    """tiny-moe ("dense" MoE on the grid): logits, window tokens and every
    step's expert load, summed over the processes, as one process's."""
    lo, _ = _pair("logits", _free_port(), "moe", "-", dp, tp)
    got = _line(lo, "LOGITS_EQUAL")
    assert len(got) == 4 + 4 and all(got)


@pytest.mark.parametrize("mode,dp,tp", [("plain", 1, 2), ("plain", 2, 2),
                                        ("attn", 2, 2), ("local", 2, 2)])
def test_spanning_wire_blocks_equal_one_process_grid(mode, dp, tp):
    lo, _ = _pair("blocks", _free_port(), mode, dp, tp)
    assert _line(lo, "BLOCKS_EQUAL") == [True] * 6


# ---------------------------------------------------------------------------
# 4. Refusals


def _fake_fabric(n=2):
    """A two-process fabric that is never asked for a collective."""
    return multihost.Fabric(0, n, "gloo", torch.device("cpu"))


def _core(**kw):
    return EngineCore(EngineConfig(
        model=tcfg.get_config(kw.pop("model", "tiny-test")), num_blocks=16,
        device="cpu", scheduler=SchedulerConfig(block_size=8),
        fabric=_fake_fabric(), **kw))


def _jax_capability(**kw):
    from dynamo_tpu.parallel.sharding import PlaneSpec, plane_capability

    return plane_capability(None, PlaneSpec(**kw), multihost=True).reason


def test_pp_spec_embed_mm_raise_jax_words():
    with pytest.raises(ValueError) as e:
        _core(pp=2)
    assert str(e.value) == "pipeline parallelism under a multi-process " \
        "mesh is not wired yet (multihost v2 covers tp/dp/dp-attention " \
        "with int8 and fused steps)"
    with pytest.raises(ValueError) as e:
        _core(tp=2, speculative_tokens=3)
    assert str(e.value) == _jax_capability(spec=True)
    core = _core(tp=2)
    with pytest.raises(ValueError) as e:
        core.embed_tokens([[1, 2, 3]])
    assert str(e.value) == _jax_capability(role="embed")
    with pytest.raises(ValueError) as e:
        core.add_request("m", [1, 2, 3], SamplingParams(),
                         prompt_embeds=np.zeros((2, 64), np.float32))
    assert str(e.value) == _jax_capability(role="mm")
    assert not core._requests


@pytest.mark.parametrize("axis", ["ep", "sp"])
def test_ep_and_sp_across_processes_name_a76(axis):
    with pytest.raises(ValueError, match="ROADMAP.md A7.6"):
        if axis == "ep":
            _core(model="tiny-moe", ep=2)
        else:
            DpGrid(["cpu"] * 4, 1, sp=2, fabric=_fake_fabric())


def _args(*extra):
    return worker_main.parse_args(["--control-plane", "127.0.0.1:1",
                                   "--model", "tiny-test", *extra])


def test_worker_span_rules_in_jax_words():
    with pytest.raises(SystemExit) as e:
        worker_main.build_mesh(_args("--num-processes", "2"))
    assert str(e.value) == (
        "--num-processes > 1 needs parallelism degrees that span the "
        "cluster (tp*dp*ep*sp*pp > 1); a meshless engine is process-local "
        "by construction")
    with pytest.raises(ValueError, match="a meshless engine is "
                       "process-local by construction"):
        _core()
    with pytest.raises(SystemExit) as e:
        worker_main.build_mesh(_args("--num-processes", "2", "--tp", "2",
                                     "--multihost-cpu-devices", "2"))
    assert str(e.value) == (
        "mesh tp2 fits rank 0's devices alone; multihost requires degrees "
        "that span all 2 processes' chips (raise --tp/--dp)")
    with pytest.raises(SystemExit, match="needs 4 devices; the cluster has 2"):
        worker_main.build_mesh(_args("--num-processes", "2", "--tp", "4",
                                     "--multihost-cpu-devices", "1"))
    assert worker_main.build_mesh(_args(
        "--num-processes", "2", "--tp", "2", "--multihost-cpu-devices",
        "1")).tp == 2
    with pytest.raises(SystemExit) as e:
        worker_main.run_follower_rank(worker_main.parse_args(
            ["--model", "tiny-test", "--num-processes", "2",
             "--process-id", "1", "--tp", "2"]))
    assert str(e.value) == "follower ranks need --lockstep HOST:PORT"


# ---------------------------------------------------------------------------
# 5. Disaggregated decode on a two-process worker


def _wait_for(log: Path, pattern: str, deadline: float, proc):
    while time.monotonic() < deadline:
        m = re.search(pattern, log.read_text())
        if m:
            return m.group(1)
        assert proc.poll() is None, log.read_text()
        time.sleep(0.1)
    raise AssertionError(f"{pattern!r} not in {log}:\n{log.read_text()}")


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _chat_ids(base: str, model: str, text: str):
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps({
            "model": model, "max_tokens": 8, "temperature": 0,
            "logprobs": True, "return_tokens_as_token_ids": True,
            "messages": [{"role": "user", "content": text}]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    return [e["token"] for e in body["choices"][0]["logprobs"]["content"]]


@pytest.mark.e2e
def test_disagg_decode_on_two_process_worker(tmp_path):
    http = _free_port()
    logs = {n: tmp_path / f"{n}.log" for n in
            ("frontend", "follower", "leader", "prefill", "single")}
    procs = {}
    common = ["--device", "cpu", "--model", "tiny-test", "--block-size", "8",
              "--health-port", "0"]

    def spawn(name, argv):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT, env=_env(),
            stdout=open(logs[name], "w"), stderr=subprocess.STDOUT)

    try:
        spawn("frontend", ["dynamo_tpu_torch.frontend",
                           "--serve-control-plane", "--control-plane-port",
                           "0", "--router-mode", "kv", "--http-port",
                           str(http)])
        deadline = time.monotonic() + 150
        cp = _wait_for(logs["frontend"], r"control plane on (\S+:\d+)",
                       deadline, procs["frontend"])
        mh = ["--multihost-cpu-devices", "1", "--num-processes", "2",
              "--tp", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
              "--lockstep", f"127.0.0.1:{_free_port()}"]
        worker = ["dynamo_tpu_torch.worker", *common]
        spawn("follower", worker + mh + ["--process-id", "1"])
        spawn("leader", worker + mh + [
            "--process-id", "0", "--control-plane", cp, "--model-name",
            "tiny-mh", "--role", "decode", "--max-local-prefill", "16",
            "--component", "mh"])
        spawn("prefill", worker + ["--control-plane", cp, "--role",
                                   "prefill", "--component", "mh"])
        spawn("single", worker + ["--control-plane", cp, "--model-name",
                                  "tiny-one", "--tp", "2", "--component",
                                  "one"])
        status = _wait_for(logs["leader"], r"worker status server on :(\d+)",
                           deadline, procs["leader"])
        base = f"http://127.0.0.1:{http}"
        while not {"tiny-mh", "tiny-one"} <= {
                m["id"] for m in _get(base + "/v1/models")["data"]}:
            assert time.monotonic() < deadline, logs["leader"].read_text()
            time.sleep(0.2)
        text = "a fairly long prompt that exceeds the local prefill " \
               "threshold for sure"
        got = _chat_ids(base, "tiny-mh", text)
        want = _chat_ids(base, "tiny-one", text)
        assert got == want and len(got) == 8
        stats = _get(f"http://127.0.0.1:{status}/debug/stats")
        assert stats["disagg"]["remote_prefills"] >= 1
        assert stats["lockstep"]["backend"] == "gloo"
        assert stats["lockstep"]["owned_ranks"] == [0]
        assert stats["lockstep"]["broadcasts_by_op"]["import"] >= 1
        assert stats["transfer_plane"] is None
        procs["leader"].terminate()
        for name in ("leader", "follower"):
            assert procs[name].wait(timeout=60) == 0, logs[name].read_text()
        done = [ln for ln in logs["follower"].read_text().splitlines()
                if ln.startswith("worker rank 1 done ")]
        end = json.loads(done[0][len("worker rank 1 done "):])
        assert end["requests_left"] == []
        assert end["ops"]["import"] >= 1 and end["ops"]["stop"] == 1
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
