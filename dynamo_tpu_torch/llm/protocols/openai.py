"""OpenAI-compatible request/response types + SSE codec (port of
`dynamo_tpu/llm/protocols/openai.py` on dataclasses).

Requests parse with `from_dict`, which validates explicitly and raises
`ValueError` with the field's name (the HTTP layer turns it into a 400);
responses serialise with `to_dict`, which drops None fields as the JAX
package's `model_dump(exclude_none=True)` does.

Streaming: `sse_encode` frames `data: {json}\\n\\n`; the stream ends with
`SSE_DONE`.
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

ROLES = ("system", "user", "assistant", "tool")


def request_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now_ts() -> int:
    return int(time.time())


def _drop_none(x):
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _drop_none(v) for k, v in x.items() if v is not None}
    if isinstance(x, list):
        return [_drop_none(v) for v in x]
    return x


class _Wire:
    def to_dict(self) -> dict:
        return _drop_none(self)


# ---------------------------------------------------------------------------
# Validation helpers


def _get(d: dict, key: str, types, default=None, required=False):
    if key not in d or d[key] is None:
        if required:
            raise ValueError(f"field {key!r} is required")
        return default
    v = d[key]
    # bool is an int subclass: never accept it where a number is asked for.
    if isinstance(v, bool) and bool not in (types if isinstance(types, tuple)
                                            else (types,)):
        raise ValueError(f"field {key!r} has the wrong type")
    if not isinstance(v, types):
        raise ValueError(f"field {key!r} has the wrong type "
                         f"({type(v).__name__})")
    return v


def _in_range(key: str, v, lo=None, hi=None, lo_open=False):
    if v is None:
        return v
    if lo is not None and (v <= lo if lo_open else v < lo):
        raise ValueError(f"field {key!r} must be {'>' if lo_open else '>='} {lo}")
    if hi is not None and v > hi:
        raise ValueError(f"field {key!r} must be <= {hi}")
    return v


# ---------------------------------------------------------------------------
# Shared


@dataclass
class Usage(_Wire):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


def error_body(message: str, type_: str = "invalid_request_error",
               code: Optional[str] = None) -> dict:
    return _drop_none({"error": {"message": message, "type": type_,
                                 "code": code}})


@dataclass
class ChatMessage(_Wire):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None

    @classmethod
    def from_dict(cls, d) -> "ChatMessage":
        if not isinstance(d, dict):
            raise ValueError("each message must be an object")
        role = _get(d, "role", str, required=True)
        if role not in ROLES:
            raise ValueError(f"unknown message role {role!r}")
        content = d.get("content")
        if content is not None and not isinstance(content, (str, list)):
            raise ValueError("message content must be a string or a list "
                             "of parts")
        if isinstance(content, list) and not all(isinstance(p, dict)
                                                 for p in content):
            raise ValueError("message content parts must be objects")
        return cls(role=role, content=content,
                   name=_get(d, "name", str),
                   tool_calls=_get(d, "tool_calls", list))

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if self.content is None:
            return ""
        return "".join(
            p.get("text", "") for p in self.content
            if p.get("type") in ("text", "input_text", "output_text"))


@dataclass
class SamplingFields:
    """Sampling knobs shared by chat + text completions."""

    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    n: int = 1
    logprobs: Optional[Union[bool, int]] = None
    # Logprob entries name their token `token_id:<id>` (as vLLM's server
    # offers), for ids the tokenizer cannot spell on their own.
    return_tokens_as_token_ids: bool = False
    stream: bool = False
    stream_options: Optional[Dict[str, Any]] = None
    user: Optional[str] = None

    @staticmethod
    def _parse(d: dict) -> dict:
        out = dict(
            max_tokens=_in_range("max_tokens", _get(d, "max_tokens", int), 1),
            max_completion_tokens=_in_range(
                "max_completion_tokens",
                _get(d, "max_completion_tokens", int), 1),
            temperature=_in_range("temperature",
                                  _get(d, "temperature", (int, float)), 0.0, 2.0),
            top_p=_in_range("top_p", _get(d, "top_p", (int, float)), 0.0, 1.0,
                            lo_open=True),
            top_k=_in_range("top_k", _get(d, "top_k", int), 0),
            stop=_get(d, "stop", (str, list)),
            seed=_get(d, "seed", int),
            n=_in_range("n", _get(d, "n", int, default=1), 1, 8),
            logprobs=_get(d, "logprobs", (bool, int)),
            return_tokens_as_token_ids=_get(
                d, "return_tokens_as_token_ids", bool, default=False),
            stream=_get(d, "stream", bool, default=False),
            stream_options=_get(d, "stream_options", dict),
            user=_get(d, "user", str),
        )
        if isinstance(out["stop"], list) and not all(
                isinstance(s, str) for s in out["stop"]):
            raise ValueError("field 'stop' must be a string or a list of strings")
        return out

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def effective_max_tokens(self, default: int = 512) -> int:
        return self.max_completion_tokens or self.max_tokens or default


# ---------------------------------------------------------------------------
# Chat completions


@dataclass
class ChatCompletionRequest(SamplingFields):
    model: str = ""
    messages: List[ChatMessage] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d) -> "ChatCompletionRequest":
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        messages = _get(d, "messages", list, required=True)
        if not messages:
            raise ValueError("messages must be non-empty")
        return cls(model=_get(d, "model", str, required=True),
                   messages=[ChatMessage.from_dict(m) for m in messages],
                   **cls._parse(d))


@dataclass
class ChatChoiceDelta(_Wire):
    role: Optional[str] = None
    content: Optional[str] = None


@dataclass
class ChatLogprobEntry(_Wire):
    token: str
    logprob: float


@dataclass
class ChatLogprobs(_Wire):
    content: List[ChatLogprobEntry] = field(default_factory=list)


@dataclass
class ChatStreamChoice(_Wire):
    delta: ChatChoiceDelta
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatLogprobs] = None


@dataclass
class ChatCompletionChunk(_Wire):
    id: str
    model: str
    choices: List[ChatStreamChoice]
    object: str = "chat.completion.chunk"
    created: int = field(default_factory=now_ts)
    usage: Optional[Usage] = None


@dataclass
class ChatChoice(_Wire):
    message: ChatMessage
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatLogprobs] = None


@dataclass
class ChatCompletionResponse(_Wire):
    id: str
    model: str
    choices: List[ChatChoice]
    object: str = "chat.completion"
    created: int = field(default_factory=now_ts)
    usage: Usage = field(default_factory=Usage)


# ---------------------------------------------------------------------------
# Text completions


@dataclass
class CompletionRequest(SamplingFields):
    model: str = ""
    prompt: Union[str, List[int]] = ""
    echo: bool = False

    @classmethod
    def from_dict(cls, d) -> "CompletionRequest":
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        prompt = _get(d, "prompt", (str, list), required=True)
        if isinstance(prompt, list) and not all(
                isinstance(t, int) and not isinstance(t, bool) for t in prompt):
            raise ValueError("batched prompts not supported; send one "
                             "request per prompt (a string or a token list)")
        return cls(model=_get(d, "model", str, required=True), prompt=prompt,
                   echo=_get(d, "echo", bool, default=False), **cls._parse(d))


@dataclass
class CompletionChoice(_Wire):
    text: str
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclass
class CompletionResponse(_Wire):
    """Doubles as the SSE chunk type when streaming (same object tag);
    chunks leave `usage` unset."""

    id: str
    model: str
    choices: List[CompletionChoice]
    object: str = "text_completion"
    created: int = field(default_factory=now_ts)
    usage: Optional[Usage] = None


# ---------------------------------------------------------------------------
# Embeddings


def _is_token(t) -> bool:
    return isinstance(t, int) and not isinstance(t, bool)


@dataclass
class EmbeddingRequest(_Wire):
    model: str
    # A string, a list of strings, a token list or a list of token lists.
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: str = "float"     # "float" | "base64"
    user: Optional[str] = None

    @classmethod
    def from_dict(cls, d) -> "EmbeddingRequest":
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        inp = _get(d, "input", (str, list), required=True)
        if isinstance(inp, list) and inp and not (
                all(isinstance(x, str) for x in inp)
                or all(_is_token(x) for x in inp)
                or all(isinstance(x, list) and all(_is_token(t) for t in x)
                       for x in inp)):
            raise ValueError("field 'input' must be a string, a list of "
                             "strings, a token list or a list of token "
                             "lists")
        fmt = _get(d, "encoding_format", str, default="float")
        if fmt not in ("float", "base64"):
            raise ValueError("field 'encoding_format' must be 'float' or "
                             "'base64'")
        return cls(model=_get(d, "model", str, required=True), input=inp,
                   encoding_format=fmt, user=_get(d, "user", str))

    def inputs(self) -> List[Union[str, List[int]]]:
        """The prompts, each a string or a token list."""
        if isinstance(self.input, str):
            return [self.input]
        if not self.input:
            return []
        if _is_token(self.input[0]):
            return [list(self.input)]
        return list(self.input)


@dataclass
class EmbeddingData(_Wire):
    index: int
    # A float list, or base64 of packed little-endian float32 when the
    # request asked for encoding_format="base64".
    embedding: Union[List[float], str]
    object: str = "embedding"


@dataclass
class EmbeddingResponse(_Wire):
    model: str
    data: List[EmbeddingData] = field(default_factory=list)
    usage: Usage = field(default_factory=Usage)
    object: str = "list"


# ---------------------------------------------------------------------------
# Models listing


@dataclass
class ModelInfo(_Wire):
    id: str
    object: str = "model"
    created: int = field(default_factory=now_ts)
    owned_by: str = "dynamo-tpu"


@dataclass
class ModelList(_Wire):
    data: List[ModelInfo] = field(default_factory=list)
    object: str = "list"


# ---------------------------------------------------------------------------
# SSE codec


SSE_DONE = "data: [DONE]\n\n"


def sse_encode(payload: _Wire) -> str:
    return f"data: {json.dumps(payload.to_dict())}\n\n"


def sse_decode_line(line: str) -> Optional[dict]:
    """Parse one `data: ...` line; None for comments/blank/[DONE]."""
    line = line.strip()
    if not line.startswith("data:"):
        return None
    body = line[5:].strip()
    if body == "[DONE]":
        return None
    return json.loads(body)
