"""The port's OpenAI frontend on the CPU (`--device cpu`, tiny-test), and
the package's import boundary.

- In process: unary and streaming chat, a text completion, model listing,
  and the client errors (over-context prompt → 400, unknown model → 404,
  malformed body → 400, n > 1 → 400).
- As a process: `python -m dynamo_tpu_torch.frontend --device cpu` serves
  a chat completion.
- In a fresh interpreter (this suite's conftest imports jax for every
  test): importing every `dynamo_tpu_torch` module loads no `jax` and no
  `dynamo_tpu`.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from dynamo_tpu_torch.frontend.main import build_model_handle, parse_args
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.protocols import openai as oai
from dynamo_tpu_torch.llm.service import ModelManager

ROOT = Path(__file__).resolve().parents[1]


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _chat(content, **kw):
    body = {"model": "m", "messages": [{"role": "user", "content": content}],
            "temperature": 0, "max_tokens": 6}
    body.update(kw)
    return body


def test_http_frontend_on_cpu():
    args = parse_args(["--model", "tiny-test", "--model-name", "m",
                       "--device", "cpu"])

    async def main():
        handle, core, shutdown = await build_model_handle(args)
        models = ModelManager()
        models.register(handle)
        svc = HttpService(models)
        port = await svc.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            return await asyncio.to_thread(_drive, base), core
        finally:
            await svc.stop()
            await shutdown()

    out, core = asyncio.run(main())
    assert out["health"] == {"status": "ready", "models": ["m"]}
    assert [m["id"] for m in out["models"]["data"]] == ["m"]
    status, body = out["unary"]
    assert status == 200
    resp = json.loads(body)
    assert resp["object"] == "chat.completion"
    assert resp["usage"]["completion_tokens"] == 6
    assert resp["choices"][0]["finish_reason"] == "length"
    status, body = out["stream"]
    assert status == 200
    lines = [ln for ln in body.split("\n") if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    chunks = [oai.sse_decode_line(ln) for ln in lines[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["usage"]["completion_tokens"] == 6
    assert any(c["choices"] and c["choices"][0].get("finish_reason") == "length"
               for c in chunks)
    # Greedy: the streamed text equals the unary text for the same prompt.
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks if c["choices"])
    assert text == resp["choices"][0]["message"]["content"]
    status, body = out["completion"]
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 4
    status, body = out["over_context"]
    assert status == 400 and "maximum context length" in body
    assert out["unknown_model"][0] == 404
    assert out["bad_json"][0] == 400
    assert out["n2"][0] == 400
    assert not core.has_work


def _drive(base):
    out = {"health": _get(base + "/health"),
           "models": _get(base + "/v1/models"),
           "unary": _post(base + "/v1/chat/completions", _chat("hello")),
           "stream": _post(base + "/v1/chat/completions",
                           _chat("hello", stream=True,
                                 stream_options={"include_usage": True})),
           "completion": _post(base + "/v1/completions",
                               {"model": "m", "prompt": "abc", "max_tokens": 4,
                                "temperature": 0.8, "seed": 1}),
           "over_context": _post(base + "/v1/chat/completions",
                                 _chat("x" * 600)),
           "unknown_model": _post(base + "/v1/chat/completions",
                                  {**_chat("hi"), "model": "nope"}),
           "n2": _post(base + "/v1/chat/completions", _chat("hi", n=2))}
    req = urllib.request.Request(base + "/v1/chat/completions", data=b"{oops",
                                 headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=10)
        out["bad_json"] = (200, "")
    except urllib.error.HTTPError as e:
        out["bad_json"] = (e.code, e.read().decode())
    return out


def test_frontend_module_serves_on_cpu(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "frontend.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--model",
         "tiny-test", "--model-name", "m", "--http-port", str(port),
         "--device", "cpu"], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "frontend.log").read_text()
            try:
                if _get(base + "/health", timeout=2)["status"] == "ready":
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "frontend did not come up"
            time.sleep(0.2)
        status, body = _post(base + "/v1/chat/completions",
                             _chat("hi", max_tokens=3))
        assert status == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 3
        stats = _get(base + "/debug/stats")
        assert stats["device"] == "cpu"
        # CPU tensors take the plain versions: no kernel launched.
        assert stats["kernels"] == {"paged_decode_attention": 0,
                                    "paged_prefill_attention": 0,
                                    "moe_grouped": 0}
        assert stats["moe_mode"] == "dense" and stats["expert_load"] is None
        assert len(stats["requests"]) == 1
        assert stats["counters"]["prefill_dispatches"] > 0
        # The reset zeroes launch counts, engine counters and request
        # timings together.
        assert _post(base + "/debug/stats/reset", {})[0] == 200
        stats = _get(base + "/debug/stats")
        assert set(stats["counters"].values()) == {0}
        assert set(stats["kernels"].values()) == {0}
        assert stats["requests"] == []
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert proc.returncode == 0


def test_package_imports_no_jax_and_nothing_of_dynamo_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dynamo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dynamo_tpu_torch.__path__, 'dynamo_tpu_torch.')]\n"
        "for n in names:\n"
        "    if not n.endswith('__main__'):\n"
        "        importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'dynamo_tpu' "
        "or m.startswith('dynamo_tpu.'))\n"
        "print(len(names), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


def test_entry_points_default_to_cuda():
    import torch

    from dynamo_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert parse_args([]).device == "cuda"
