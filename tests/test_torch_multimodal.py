"""The port's multimodal path against the JAX package's.

- Steps: the packed prefill step with `input_embeds` / `embed_mask`
  (the port's route; JAX's is its padded forward step with input
  embeds) and the port's forward step with them, against JAX's
  `make_forward_step(with_input_embeds=True)`: logits within 1e-4 (f32).
- Engines: JAX's and the port's EngineCore on the same tiny-test weights
  and the same `prompt_embeds` give identical greedy tokens — alone,
  with the span over several prefill chunks, and in mixed batches with
  plain prompts — and equal prefix-cache hit counters (a repeated image
  hits nothing; a plain prompt still does).  Validation errors match.
- Transport: `EncodeWorker` -> `MultimodalAttach` over the device plane
  (the same-process fabric on the CPU) and inline, the plane tallies.
- HTTP: image_url parts on the single-process frontend steer greedy
  output; a model without the hook answers 400.  A distributed frontend
  with a `--role encode` worker and a CPU worker serving a checkpoint
  directory serves image chats and the checkpoint's tokenizer (its card
  carries the 3 MB tokenizer.json over the control plane).
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.llm.multimodal import StubVisionEncoder as JaxEncoder
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine import kv_cache as tkvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm import multimodal as mm
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import from_jax_params
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
BS = 8
GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))
H = jcfg.get_config("tiny-test").hidden_size


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jcfg.get_config("tiny-test"),
                                jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def image(ref: str, n: int = 8, scale: float = 30.0) -> np.ndarray:
    """The stub tower's embeddings (scaled so they move a tiny random
    model's argmax); JAX's encoder and the port's agree."""
    emb = mm.StubVisionEncoder(H, n_tokens=n).encode(ref)
    np.testing.assert_array_equal(emb, JaxEncoder(H, n_tokens=n).encode(ref))
    return emb * scale


def test_steps_with_input_embeds_match_jax(weights):
    """Two segments, one with an embedding span over its first 5
    positions: the port's packed step and forward step against JAX's
    input-embeds forward step."""
    params, state = weights
    jc, tc = jcfg.get_config("tiny-test"), tcfg.get_config("tiny-test")
    emb = image("a.png", n=5)
    toks = np.asarray([[0, 0, 0, 0, 0, 7, 8, 9], [3, 4, 5, 6, 7, 8, 9, 10]],
                      np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    sl = np.asarray([8, 8], np.int32)
    bt = np.asarray([[1, 0], [2, 0]], np.int32)
    smp = np.asarray([7, 7], np.int32)
    embeds = np.zeros((2, 8, H), np.float32)
    embeds[0, :5] = emb
    mask = np.zeros((2, 8), bool)
    mask[0, :5] = True
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        jc, num_blocks=8, block_size=BS))
    jstep = jllama.make_forward_step(jc, BS, with_input_embeds=True)
    want, _ = jstep(params, jcache, *map(jnp.asarray, (toks, pos, sl, bt,
                                                        smp)),
                    input_embeds=jnp.asarray(embeds),
                    embed_mask=jnp.asarray(mask))
    want = np.asarray(want)

    def cache():
        return tkvc.init_cache(tkvc.KvCacheConfig.for_model(
            tc, num_blocks=8, block_size=BS), "cpu")

    t = torch.from_numpy
    got, _ = tllama.make_forward_step(tc, BS)(
        state, cache(), *map(t, (toks, pos, sl, bt, smp)),
        input_embeds=t(embeds), embed_mask=t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    packed = tllama.make_packed_prefill_step(tc, BS)
    got, _ = packed(
        state, cache(), t(toks.reshape(-1)), t(pos.reshape(-1)),
        t(np.repeat(np.arange(2, dtype=np.int32), 8)), t(bt),
        t(np.asarray([0, 8], np.int32)), t(np.asarray([8, 8], np.int32)),
        t(sl), t(np.asarray([7, 15], np.int32)),
        input_embeds=t(embeds.reshape(16, H)),
        embed_mask=t(mask.reshape(16)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    # The embeddings reach the logits.
    plain, _ = packed(
        state, cache(), t(toks.reshape(-1)), t(pos.reshape(-1)),
        t(np.repeat(np.arange(2, dtype=np.int32), 8)), t(bt),
        t(np.asarray([0, 8], np.int32)), t(np.asarray([8, 8], np.int32)),
        t(sl), t(np.asarray([7, 15], np.int32)))
    assert not torch.allclose(plain[0], got[0])
    np.testing.assert_allclose(plain[1].numpy(), want[1], rtol=0,
                               atol=LOGIT_TOL)


def _cores(weights, prefix_cache: bool, num_blocks: int = 64):
    params, state = weights
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=num_blocks,
        packed_prefill=True, enable_prefix_cache=prefix_cache,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=num_blocks,
        device="cpu", enable_prefix_cache=prefix_cache,
        scheduler=SchedulerConfig(**GEOM)), params=state)
    return j, t


def _run(core, sp_cls, requests, max_steps=2000):
    for rid, (prompt, emb, n) in requests.items():
        core.add_request(rid, prompt, sp_cls(max_tokens=n),
                         prompt_embeds=emb)
    out = {}
    for _ in range(max_steps):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    return out


def _hits(core) -> int:
    return core.allocator.manager.device.hits


WAVES = {
    "alone": [{"cat": ([0] * 8 + [5, 6, 7, 8], image("cat.png"), 6)}],
    # A 24-row span over two 16-token prefill chunks.
    "chunked": [{"big": ([0] * 24 + list(range(40, 48)),
                         image("big.png", n=24), 6)}],
    # Image and plain prompts in one batch, two images sharing
    # placeholder ids, a prompt shorter than the span's placeholders.
    "mixed": [{"cat": ([0] * 8 + [5, 6, 7, 8], image("cat.png"), 6),
               "plain": (list(range(1, 20)), None, 6),
               "dog": ([0] * 8 + [5, 6, 7, 8], image("dog.png"), 6),
               "short": ([0] * 8, image("sun.png"), 4)}],
    # The same image twice and a plain prompt twice, in two waves: the
    # plain prompt hits its sealed blocks, the image never does.
    "repeat": [{"cat": ([0] * 16 + [5, 6, 7, 8], image("cat.png", 16), 6),
                "plain": (list(range(1, 21)), None, 6)},
               {"cat2": ([0] * 16 + [5, 6, 7, 8], image("cat.png", 16), 6),
                "plain2": (list(range(1, 21)), None, 6)}],
}


@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_greedy_equals_jax(weights, wave, prefix_cache):
    j, t = _cores(weights, prefix_cache)
    want, got = {}, {}
    jhits, thits = [], []
    for reqs in WAVES[wave]:
        want.update(_run(j, JaxSamplingParams, reqs))
        got.update(_run(t, SamplingParams, reqs))
        if prefix_cache:
            jhits.append(_hits(j))
            thits.append(_hits(t))
    assert got == want
    assert all(len(v) > 0 for v in got.values())
    if prefix_cache:
        assert thits == jhits
    if wave == "mixed":
        assert got["cat"] != got["dog"]     # the image steers the tokens
    if wave == "repeat" and prefix_cache:
        # plain2 hit plain's 2 sealed blocks; cat2 hit none of cat's.
        assert thits[1] - thits[0] == 2
        assert t.prefix_cache_stats()["hit_tokens"] == 16


def test_validation_matches_jax(weights):
    j, t = _cores(weights, False)
    for emb in (np.zeros((3, H)), np.zeros((2, 7)), np.zeros((4,))):
        with pytest.raises(ValueError) as want:
            j.add_request("x", [1, 2], JaxSamplingParams(max_tokens=1),
                          prompt_embeds=emb)
        with pytest.raises(ValueError) as got:
            t.add_request("x", [1, 2], SamplingParams(max_tokens=1),
                          prompt_embeds=emb)
        assert str(got.value) == str(want.value)


def test_encode_worker_device_plane_and_inline():
    """A puller on the encode worker's fabric pulls the staged
    embeddings off the device plane (one offer, a short TTL); a puller
    without a plane gets inline float32 bytes.  Both equal the tower's
    output; the tallies say which plane each took."""
    from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcServer

    async def main():
        plane = dt.KvTransferPlane(device="cpu")
        plane.start()
        worker = mm.EncodeWorker(mm.StubVisionEncoder(H),
                                 transfer_plane=plane)
        server = RpcServer()
        server.register(mm.ENCODE_ENDPOINT, worker.make_handler())
        addr = await server.start()
        rpc = RpcClient(addr)
        dt.reset_plane_counts()
        try:
            puller = dt.KvTransferPlane(device="cpu")
            puller.start()
            dev = await mm.fetch_embeddings(rpc, "img://a", puller)
            inline = await mm.fetch_embeddings(rpc, "img://a", None)
        finally:
            await rpc.close()
            await server.stop()
        want = mm.StubVisionEncoder(H).encode("img://a")
        np.testing.assert_array_equal(dev, want)
        np.testing.assert_array_equal(inline, want)
        assert worker.encoded == 2 and worker.offered == 1
        assert puller.pulled_blocks == 1
        assert plane.stats()["offers"] == 1
        assert plane._outstanding[next(iter(plane._outstanding))][1] \
            - time.monotonic() <= mm.EMBED_OFFER_TTL_S
        assert dt.plane_counts() == {("device", "mm_embeds"): 1,
                                     ("host", "mm_embeds"): 1}

    asyncio.run(asyncio.wait_for(main(), 60))


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image_chat(model, url, n=8):
    return {"model": model, "temperature": 0, "max_tokens": n,
            "logprobs": True, "return_tokens_as_token_ids": True,
            "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text", "text": "describe"}]}]}


def _ids(body):
    return [int(e["token"].split(":")[1])
            for e in body["choices"][0]["logprobs"]["content"]]


def test_http_image_parts_single_process():
    """The single-process frontend's in-process tower: the same image
    decodes the same, another image differently; a model without the
    hook refuses image parts with a 400."""
    from dynamo_tpu_torch.frontend.main import build_model_handle, parse_args
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.service import ModelManager

    async def main():
        handle, core, shutdown = await build_model_handle(parse_args(
            ["--model", "tiny-test", "--model-name", "m", "--device", "cpu",
             "--block-size", "8", "--num-blocks", "160"]))
        models = ModelManager()
        models.register(handle)
        echo, _, stop_echo = await build_model_handle(parse_args(
            ["--out", "echo", "--model-name", "e"]))
        models.register(echo)
        svc = HttpService(models)
        port = await svc.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}/v1/chat/completions"
        try:
            outs = []
            for url in ("img://cat", "img://cat", "img://dog"):
                outs.append(await asyncio.to_thread(
                    _post, base, _image_chat("m", url)))
            refused = await asyncio.to_thread(_post, base,
                                              _image_chat("e", "img://cat"))
        finally:
            await svc.stop()
            await shutdown()
            await stop_echo()
        return outs, refused, core

    outs, refused, core = asyncio.run(asyncio.wait_for(main(), 120))
    assert all(s == 200 for s, _ in outs), outs
    ids = [_ids(b) for _, b in outs]
    assert ids[0] == ids[1] and ids[0] != ids[2]
    # 64 placeholder rows in front of the templated text.
    assert outs[0][1]["usage"]["prompt_tokens"] > 64
    # A repeated image hit nothing.
    assert core.prefix_cache_stats()["hit_tokens"] == 0
    assert refused[0] == 400 and "multimodal" in refused[1]["error"]["message"]


def tiny_checkpoint(d) -> None:
    """A bf16 HF-layout checkpoint of tiny-test widened to Llama-3's
    vocabulary, with chip_smoke's Llama-3-style tokenizer.json (3 MB) and
    chat template, written by chip_smoke's own writer."""
    import chip_smoke
    from dynamo_tpu_torch.models.weights import init_params

    cfg = tcfg.get_config("tiny-test").replace(
        vocab_size=128256, head_dim=32, dtype=torch.bfloat16)
    state = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d.mkdir(exist_ok=True)
    (d / "tokenizer.json").write_text(chip_smoke.llama3_tokenizer_json(),
                                      encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": chip_smoke.CKPT_TEMPLATE,
         "eos_token": "<|eot_id|>"}))
    (d / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": 512, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": True}))
    shard = {"model.embed_tokens.weight": state["embed"],
             "model.norm.weight": state["final_norm"]}
    for i, layer in enumerate(state["layers"]):
        p = f"model.layers.{i}."
        for ours, hf in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            shard[p + f"self_attn.{hf}_proj.weight"] = layer["attn"][ours].t()
        for hf in ("gate", "up", "down"):
            shard[p + f"mlp.{hf}_proj.weight"] = layer["mlp"]["w_" + hf].t()
        shard[p + "input_layernorm.weight"] = layer["attn_norm"]
        shard[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
    chip_smoke.write_safetensors(torch, d / "model.safetensors",
                                 {k: v.contiguous() for k, v in shard.items()})


def test_distributed_encode_worker_serves_image_chat(tmp_path):
    """A frontend (serving the control plane), a `--role encode` worker
    and a CPU LLM worker serving a checkpoint directory, as processes:
    the worker's card carries the checkpoint's 3 MB tokenizer.json inline
    over the control plane and the frontend serves it (a text chat's
    prompt is that tokenizer's ids of the rendered template); an image
    chat answers, steered by the image; the frontend's tallies show the
    inline plane (the CPU fabric is per process)."""
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
    import chip_smoke

    ckpt = tmp_path / "ckpt"
    tiny_checkpoint(ckpt)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    procs = []

    def spawn(name, args):
        log = open(tmp_path / f"{name}.log", "w+")
        p = subprocess.Popen([sys.executable, "-m"] + args, cwd=ROOT,
                             env=env, stdout=log, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((p, log))
        return log

    def wait_for(log, pattern, timeout=120):
        import re

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            log.seek(0)
            m = re.search(pattern, log.read())
            if m:
                return m
            time.sleep(0.2)
        log.seek(0)
        raise AssertionError(f"{pattern!r} not seen:\n{log.read()[-3000:]}")

    try:
        fe = spawn("fe", ["dynamo_tpu_torch.frontend", "--serve-control-plane",
                          "--control-plane-port", "0", "--http-port", "0",
                          "--device", "cpu"])
        cp = wait_for(fe, r"control plane on (\S+)").group(1)
        base = wait_for(fe, r"on (http://\S+)").group(1)
        spawn("llm", ["dynamo_tpu_torch.worker", "--control-plane", cp,
                      "--device", "cpu", "--model", str(ckpt),
                      "--model-name", "m", "--block-size", "8",
                      "--health-port", "-1"])
        enc = spawn("enc", ["dynamo_tpu_torch.worker", "--control-plane", cp,
                            "--device", "cpu", "--model", str(ckpt),
                            "--role", "encode"])
        wait_for(enc, r"encode worker instance \d+ at \S+ \(hidden 64, "
                      r"transfer local\)")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/v1/models") as r:
                if json.loads(r.read())["data"]:
                    break
            time.sleep(0.3)
        a = _post(base + "/v1/chat/completions", _image_chat("m", "img://a"))
        b = _post(base + "/v1/chat/completions", _image_chat("m", "img://b"))
        text_body = {"model": "m", "temperature": 0, "max_tokens": 4,
                     "messages": [{"role": "user",
                                   "content": chip_smoke.CKPT_TURN}]}
        text = _post(base + "/v1/chat/completions", text_body)
        with urllib.request.urlopen(base + "/debug/stats") as r:
            stats = json.loads(r.read())
    finally:
        for p, log in procs:
            p.terminate()
        for p, log in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
            log.close()
    assert a[0] == 200 and b[0] == 200 and text[0] == 200, (a, b, text)
    assert _ids(a[1]) != _ids(b[1])
    assert stats["plane_counts"] == {"host": {"mm_embeds": 2}}
    pre = OpenAIPreprocessor(HFTokenizer(str(ckpt / "tokenizer.json")),
                             chat_template=chip_smoke.CKPT_TEMPLATE)
    want = pre.preprocess_chat(ChatCompletionRequest.from_dict(text_body),
                               "x").token_ids
    assert text[1]["usage"]["prompt_tokens"] == len(want)
    assert want[0] == 128000 and len(want) < len(chip_smoke.CKPT_TURN)
