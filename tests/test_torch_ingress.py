"""The port frontend's other ingress and backends against the JAX
package's, on the CPU.

- `EchoEngine` streams the same deltas as JAX's.
- `--input batch` over the echo backend: the output rows (completion,
  token counts, a row's error) and the summary's counts equal JAX's
  `run_batch` on the same JSONL; `--input text` prints what JAX's REPL
  prints for the same lines.
- `--out mocker` (and `--mocker`) answers with no kernel launched;
  `--out dyn://...` attaches an endpoint served on the port's control
  plane without model discovery; a bad `--out` or a `dyn://` without a
  control plane is refused.
- The CLI runs a batch end to end in a subprocess.

Tolerance: none; everything is exact.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.frontend import main as jmain
from dynamo_tpu.llm.echo import EchoEngine as JaxEcho
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
from dynamo_tpu.llm.preprocessor import PreprocessedRequest as JaxRequest
from dynamo_tpu.llm.service import ModelHandle as JaxHandle
from dynamo_tpu.llm.service import ModelManager as JaxModels
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.frontend import main as tmain
from dynamo_tpu_torch.llm.echo import EchoEngine
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import ModelHandle, ModelManager
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.ops import cuda as kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOBS = [{"prompt": "hello there", "max_tokens": 5},
        {"prompt": "abc"},
        {"prompt": "temperature is ignored by echo", "temperature": 0.7,
         "max_tokens": 64},
        {"no_prompt": 1},
        {"prompt": ""}]


def _models(jax_side):
    if jax_side:
        tok = JaxByteTokenizer()
        models = JaxModels()
        models.register(JaxHandle(name="m", tokenizer=tok,
                                  preprocessor=JaxPre(tok),
                                  client=JaxEcho(delay_ms=0.0)))
    else:
        tok = ByteTokenizer()
        models = ModelManager()
        models.register(ModelHandle(name="m", tokenizer=tok,
                                    preprocessor=OpenAIPreprocessor(tok),
                                    client=EchoEngine(delay_ms=0.0)))
    return models


@pytest.mark.parametrize("tokens,max_tokens", [([5, 6, 7], 8),
                                               ([1, 2, 3, 4], 2), ([], 4)])
def test_echo_deltas_equal_jax(tokens, max_tokens):
    async def collect(engine, req):
        return [(d.token_ids, d.finished,
                 d.finish_reason and d.finish_reason.value)
                async for d in engine.generate(req)]

    got = asyncio.run(collect(EchoEngine(0.0), PreprocessedRequest(
        request_id="r", model="m", token_ids=tokens,
        sampling=SamplingParams(max_tokens=max_tokens))))
    want = asyncio.run(collect(JaxEcho(0.0), JaxRequest(
        request_id="r", model="m", token_ids=tokens,
        sampling=JaxSamplingParams(max_tokens=max_tokens))))
    assert got == want and got[-1][1]


def test_batch_over_echo_equal_jax(tmp_path):
    src = tmp_path / "jobs.jsonl"
    src.write_text("".join(json.dumps(j) + "\n" for j in JOBS) + "\n")
    outs = []
    for mod, jax_side in ((tmain, False), (jmain, True)):
        out = tmp_path / f"out_{jax_side}.jsonl"
        summary = asyncio.run(mod.run_batch(_models(jax_side), str(src),
                                            str(out)))
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        outs.append((rows, summary["requests"], summary["output_tokens"]))
    assert outs[0] == outs[1]
    rows = outs[0][0]
    assert rows[0]["completion"] == "hello"
    assert rows[1]["completion"] == "abc"
    assert "error" in rows[3]


def test_text_repl_over_echo_equal_jax(monkeypatch, capsys):
    lines = ["hi", "", "/clear", "again", "/quit"]
    printed = []
    for mod, jax_side in ((tmain, False), (jmain, True)):
        feed = iter(lines)
        monkeypatch.setattr(mod, "_read_prompt", lambda f=feed: next(f))
        asyncio.run(mod.run_text_repl(_models(jax_side)))
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "hi" in printed[0] and "(history cleared)" in printed[0]


def _args(*argv):
    return tmain.parse_args(["--device", "cpu", "--model-name", "m",
                             *argv])


def test_out_mocker_answers_without_a_kernel():
    async def main(args):
        handle, core, shutdown = await tmain.build_model_handle(args)
        assert core is None
        pre = handle.preprocessor.preprocess_completion(
            tmain.CompletionRequest(model="m", prompt="mock me",
                                    max_tokens=6), "r1")
        text, det = await tmain._completion_text(handle, pre)
        await shutdown()
        return det.completion_tokens

    kernels.reset_launch_counts()
    for argv in (("--out", "mocker"), ("--mocker", "--out", "echo")):
        assert asyncio.run(main(_args(*argv, "--speedup-ratio", "100"))) == 6
    assert not any(kernels.launch_counts().values())


def test_out_flags_are_checked():
    with pytest.raises(SystemExit):
        _args("--out", "bogus")
    with pytest.raises(SystemExit, match="control-plane"):
        asyncio.run(tmain.build_model_handle(
            _args("--out", "dyn://ns/backend/generate")))
    args = _args("--out", "echo", "--max-tokens-default", "7")
    handle, _, _ = asyncio.run(tmain.build_model_handle(args))
    assert isinstance(handle.client, EchoEngine)
    assert handle.preprocessor.default_max_tokens == 7


def test_out_dyn_attaches_an_endpoint_statically():
    """A worker serving echo on ns/backend/generate, registered as no
    model: the frontend's static attachment reaches it by path."""
    from dynamo_tpu_torch.llm.discovery import engine_wire_handler
    from dynamo_tpu_torch.runtime.control_plane_tcp import (
        ControlPlaneClient,
        ControlPlaneServer,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def main():
        srv = ControlPlaneServer()
        port = await srv.start()
        cp = ControlPlaneClient("127.0.0.1", port)
        await cp.start()
        rt = DistributedRuntime(cp)
        ep = rt.namespace("ns").component("backend").endpoint("generate")
        await ep.serve(engine_wire_handler(EchoEngine(0.0)))
        try:
            for mode in ("round_robin", "kv"):
                args = _args("--out", "dyn://ns/backend/generate",
                             "--control-plane", f"127.0.0.1:{port}",
                             "--router-mode", mode,
                             "--kv-cache-block-size", "8")
                handle, core, shutdown = await tmain.build_model_handle(args)
                assert core is None
                pre = handle.preprocessor.preprocess_completion(
                    tmain.CompletionRequest(model="m", prompt="static",
                                            max_tokens=16), f"r-{mode}")
                text, _ = await tmain._completion_text(handle, pre)
                await shutdown()
                assert text == "static"
        finally:
            await ep.leave()
            await rt.shutdown()
            await cp.close()
            await srv.stop()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_cli_batch_over_echo(tmp_path):
    src = tmp_path / "jobs.jsonl"
    src.write_text("".join(json.dumps(j) + "\n" for j in JOBS[:3]))
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--out", "echo",
         "--input", "batch", "--batch-file", str(src)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 3
    rows = [json.loads(line)
            for line in (tmp_path / "jobs.jsonl.out").read_text().splitlines()]
    assert [r["completion"] for r in rows] == ["hello", "abc",
                                              JOBS[2]["prompt"]]
