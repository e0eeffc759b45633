"""Tool calls and /v1/responses: the port against the JAX package.

- Parsers: JAX's `parse_tool_calls` and the port's on a fixed corpus of
  hermes, mistral and JSON call syntax (valid, malformed, mixed with
  text) under every parser name, call ids aside; the streaming parser
  under any chunking of a string gives its one-shot parse (hypothesis),
  and the same deltas as JAX's streaming parser.
- Template: `tools` / `tool_choice` render the same prompt as JAX's
  preprocessor, or raise the same client error.
- HTTP: JAX's HttpService and the port's, each over a scripted engine
  client that emits the same bytes as tokens: /v1/responses (unary and
  SSE), a chat with tools and a forced `tool_choice` (the call), with
  `tool_choice: "none"` (plain content) and parsed hermes calls, unary
  and streaming, give bodies equal apart from ids and timestamps; a
  forced function with no tools is a 400 on both.
"""

from __future__ import annotations

import asyncio
import json
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.engine import TokenDelta as JaxTokenDelta
from dynamo_tpu.engine.scheduler import FinishReason as JaxFinish
from dynamo_tpu.llm import postprocessor as jpost
from dynamo_tpu.llm.http_service import HttpService as JaxHttpService
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPre
from dynamo_tpu.llm.protocols import openai as joai
from dynamo_tpu.llm.service import ModelHandle as JaxHandle
from dynamo_tpu.llm.service import ModelManager as JaxManager
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByte
from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm import postprocessor as tpost
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols import openai as toai
from dynamo_tpu_torch.llm.service import ModelHandle, ModelManager
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

CALL = '{"name": "get_weather", "arguments": {"city": "Paris"}}'
CORPUS = [
    "plain text, no call",
    f"<tool_call>{CALL}</tool_call>",
    f"Let me check. <tool_call>\n{CALL}\n</tool_call> done",
    f"<tool_call>{CALL}</tool_call><tool_call>"
    '{"name": "b", "parameters": {"x": 1}}</tool_call>',
    "<tool_call>{not json}</tool_call>",
    "<tool_call>" + CALL,
    f"[TOOL_CALLS][{CALL}]",
    f"prefix [TOOL_CALLS] {CALL}",
    "[TOOL_CALLS] [1, 2]",
    CALL,
    f"[{CALL}, " + '{"name": "c", "arguments": "raw"}]',
    f"```json\n{CALL}\n```",
    '{"no_name": 1}',
    "  \n" + CALL,
    "<tool",
    "[TOOL_CALL",
    "",
]
PARSER_NAMES = ["auto", "hermes", "mistral", "json", "llama3_json"]


def strip_ids(calls):
    out = []
    for c in calls:
        c = dict(c)
        if "id" in c:
            assert c.pop("id").startswith("call_")
        out.append(c)
    return out


@pytest.mark.parametrize("fmt", PARSER_NAMES)
def test_unary_parsers_equal_jax(fmt):
    for text in CORPUS:
        jt, jc = jpost.parse_tool_calls(text, fmt)
        tt, tc = tpost.parse_tool_calls(text, fmt)
        assert tt == jt and strip_ids(tc) == strip_ids(jc), (fmt, text)
    with pytest.raises(ValueError):
        tpost.parse_tool_calls("x", "nope")
    for choice, tools in ((None, None), ("auto", [{}]),
                          ({"type": "function", "function": {"name": "f"}},
                           None),
                          ("required", [{"function": {"name": "g"}}]),
                          ("required", [{}, {}])):
        assert (tpost.forced_tool_name(choice, tools)
                == jpost.forced_tool_name(choice, tools))


def _stream(mod, text, cuts, fmt, forced=None):
    p = mod.StreamingToolCallParser(fmt, forced_name=forced)
    content, deltas = [], []
    prev = 0
    for c in sorted(set(cuts)) + [len(text)]:
        piece = text[prev:c]
        prev = c
        if piece:
            got, d = p.push(piece)
            content.append(got)
            deltas.extend(d)
    rest, d, any_calls = p.finish()
    content.append(rest)
    deltas.extend(d)
    return "".join(content), strip_ids(deltas), any_calls


def _assemble(deltas):
    calls = {}
    for d in deltas:
        c = calls.setdefault(d["index"], {"name": None, "arguments": ""})
        fn = d.get("function", {})
        if "name" in fn:
            c["name"] = fn["name"]
        c["arguments"] += fn.get("arguments", "")
    return [calls[i] for i in sorted(calls)]


@pytest.mark.parametrize("text", CORPUS)
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_streaming_any_chunking_equals_one_shot(text, data):
    """Any split of a string into chunks: the streamed content and the
    assembled calls equal the one-shot parse, and the deltas equal JAX's
    streaming parser's on the same chunks."""
    cuts = data.draw(st.lists(st.integers(0, max(len(text), 1)),
                              max_size=6))
    fmt = data.draw(st.sampled_from(PARSER_NAMES))
    content, deltas, any_calls = _stream(tpost, text, cuts, fmt)
    assert (content, deltas, any_calls) == _stream(jpost, text, cuts, fmt)
    want_text, want_calls = tpost.parse_tool_calls(text, fmt)
    assert any_calls == bool(want_calls)
    assert _assemble(deltas) == [
        {"name": c["function"]["name"],
         "arguments": c["function"]["arguments"]} for c in want_calls]
    if want_calls:
        # The unary parser strips around the calls; the stream may keep
        # the whitespace it released before seeing one.
        assert content.strip() == want_text.strip()
    else:
        assert content == text
    forced = _stream(tpost, text, cuts, fmt, forced="f")
    assert forced == _stream(jpost, text, cuts, fmt, forced="f")
    assert _assemble(forced[1]) == [{"name": "f", "arguments": text}]


TOOLS = [{"type": "function", "function": {"name": "get_weather",
                                           "parameters": {"type": "object"}}},
         {"type": "function", "function": {"name": "get_time"}}]


@pytest.mark.parametrize("choice,tools", [
    (None, None), (None, TOOLS), ("auto", TOOLS), ("none", TOOLS),
    ({"type": "function", "function": {"name": "get_time"}}, TOOLS),
    ({"type": "function", "function": {"name": "nope"}}, TOOLS),
    ({"type": "function", "function": {"name": "get_time"}}, None),
])
def test_template_tools_equal_jax(choice, tools):
    body = {"model": "m", "tools": tools, "tool_choice": choice,
            "messages": [{"role": "user", "content": "weather?"},
                         {"role": "assistant", "content": "",
                          "tool_calls": [{"id": "call_1", "type": "function",
                                          "function": {"name": "get_weather",
                                                       "arguments": "{}"}}]},
                         {"role": "tool", "content": "sunny"}]}
    jreq = joai.ChatCompletionRequest.model_validate(body)
    treq = toai.ChatCompletionRequest.from_dict(body)
    jpre, tpre = JaxPre(JaxByte()), OpenAIPreprocessor(ByteTokenizer())
    try:
        want = jpre.render_chat(jreq)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpre.render_chat(treq)
        assert str(got.value) == str(e)
        return
    assert tpre.render_chat(treq) == want


def test_responses_request_as_chat_equals_jax():
    body = {"model": "m", "instructions": "be brief", "max_output_tokens": 7,
            "temperature": 0.5, "top_p": 0.9,
            "input": [{"role": "developer", "content": "sys"},
                      {"role": "user", "content": [
                          {"type": "input_text", "text": "hi"}]},
                      {"content": "there"}]}
    j = joai.ResponsesRequest.model_validate(body).as_chat()
    t = toai.ResponsesRequest.from_dict(body).as_chat()
    assert [(m.role, m.text()) for m in t.messages] == \
        [(m.role, m.text()) for m in j.messages]
    assert (t.max_tokens, t.temperature, t.top_p) == \
        (j.max_tokens, j.temperature, j.top_p)
    for bad in ({"model": "m"}, {"model": "m", "input": 3},
                {"model": "m", "input": "x", "max_output_tokens": 0}):
        with pytest.raises(ValueError):
            toai.ResponsesRequest.from_dict(bad)


class Scripted:
    """An engine client that answers every request with `text`'s bytes,
    one token a delta, capped at max_tokens."""

    def __init__(self, text: str, delta_cls, finish_cls) -> None:
        self.ids = list(text.encode())
        self.delta, self.finish = delta_cls, finish_cls

    async def generate(self, request):
        n = request.sampling.max_tokens
        ids = self.ids[:n]
        for i, t in enumerate(ids):
            last = i == len(ids) - 1
            yield self.delta(
                request_id=request.request_id, token_ids=[t], finished=last,
                finish_reason=((self.finish.LENGTH if len(self.ids) > n
                                else self.finish.STOP) if last else None))
            await asyncio.sleep(0)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


VOLATILE = {"id", "created", "created_at"}


def scrub(x):
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    return x


def parse_body(status, text):
    """A JSON body, or an SSE stream's frames as (event, data) pairs."""
    if text.lstrip().startswith("{"):
        return status, scrub(json.loads(text))
    frames = []
    for block in text.strip().split("\n\n"):
        event, data = None, None
        for line in block.split("\n"):
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                data = line[6:]
        frames.append((event, data if data == "[DONE]"
                       else scrub(json.loads(data))))
    return status, frames


def serve_both(text, calls):
    """Each (path, body) of `calls` against JAX's service and the port's,
    both scripted to answer `text`; the parsed replies, JAX's first."""

    async def main():
        jm, tm = JaxManager(), ModelManager()
        jtok, ttok = JaxByte(), ByteTokenizer()
        jm.register(JaxHandle(name="m", tokenizer=jtok,
                              preprocessor=JaxPre(jtok),
                              client=Scripted(text, JaxTokenDelta,
                                              JaxFinish)))
        tm.register(ModelHandle(name="m", tokenizer=ttok,
                                preprocessor=OpenAIPreprocessor(ttok),
                                client=Scripted(text, TokenDelta,
                                                FinishReason)))
        jsvc, tsvc = JaxHttpService(jm), HttpService(tm)
        jport = await jsvc.start("127.0.0.1", 0)
        tport = await tsvc.start("127.0.0.1", 0)
        try:
            out = []
            for path, body in calls:
                j = await asyncio.to_thread(
                    _post, f"http://127.0.0.1:{jport}{path}", body)
                t = await asyncio.to_thread(
                    _post, f"http://127.0.0.1:{tport}{path}", body)
                out.append((parse_body(*j), parse_body(*t)))
            return out
        finally:
            await jsvc.stop()
            await tsvc.stop()

    return asyncio.run(asyncio.wait_for(main(), 60))


def _chat(**kw):
    body = {"model": "m", "temperature": 0, "max_tokens": 200,
            "messages": [{"role": "user", "content": "weather in Paris?"}]}
    body.update(kw)
    return body


FORCED = {"type": "function", "function": {"name": "get_weather"}}


@pytest.mark.parametrize("stream", [False, True])
def test_http_bodies_equal_jax(stream):
    hermes = f"Checking. <tool_call>{CALL}</tool_call>"
    calls = [
        ("/v1/responses", {"model": "m", "input": "hello", "stream": stream,
                           "instructions": "terse"}),
        ("/v1/responses", {"model": "m", "stream": stream,
                           "max_output_tokens": 5,
                           "input": [{"role": "user", "content": "hi"}]}),
        ("/v1/chat/completions", _chat(tools=TOOLS, tool_choice=FORCED,
                                       stream=stream)),
        ("/v1/chat/completions", _chat(tools=TOOLS, tool_choice="none",
                                       stream=stream)),
        ("/v1/chat/completions", _chat(tools=TOOLS, stream=stream)),
        ("/v1/chat/completions", _chat(tool_choice=FORCED, stream=stream)),
        ("/v1/chat/completions", _chat(tools=TOOLS,
                                       tool_call_parser="bogus")),
    ]
    for text in (hermes, CALL):
        replies = serve_both(text, calls)
        for (path, body), (want, got) in zip(calls, replies):
            assert got[0] == want[0], (path, body, want, got)
            if want[0] != 200:
                continue
            assert got == want, (path, body)
    # What the bodies say, on the port's side alone.
    (_, forced), (_, none), (_, auto) = [r[1] for r in replies[2:5]]
    if not stream:
        msg = forced["choices"][0]
        assert msg["finish_reason"] == "tool_calls"
        assert msg["message"]["tool_calls"][0]["function"] == {
            "name": "get_weather", "arguments": CALL}
        assert none["choices"][0]["message"]["content"] == CALL
        assert auto["choices"][0]["message"]["tool_calls"][0][
            "function"]["name"] == "get_weather"
        assert replies[5][1][0] == 400
