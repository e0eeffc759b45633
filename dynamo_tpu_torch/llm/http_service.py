"""OpenAI-compatible HTTP service on asyncio streams (port of
`dynamo_tpu/llm/http_service.py`, standard library only).

Routes:
  POST /v1/chat/completions   chat, unary or SSE streaming
  POST /v1/completions        text completion, unary or SSE streaming
  GET  /v1/models             registered models
  GET  /health                readiness
  GET  /debug/stats           per-request timings + the server's stats hook
  POST /debug/stats/reset     clear both

HTTP/1.1 with keep-alive for unary responses; a streaming response ends
its connection after `data: [DONE]`.  A prompt at or over the model's
context limit is a 400; max_tokens is clamped to what fits.  Only n == 1
is served.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Set

from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.backend import StreamDetokenizer
from dynamo_tpu_torch.llm.protocols import openai as oai
from dynamo_tpu_torch.llm.service import ModelHandle, ModelManager

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error"}
MAX_BODY = 16 * 1024 * 1024


@dataclass
class RequestTiming:
    """Server-side timings of one generation (arrival → tokens)."""

    request_id: str
    stream: bool
    prompt_tokens: int
    completion_tokens: int = 0
    ttft_s: Optional[float] = None
    itl_sum_s: float = 0.0
    itl_n: int = 0
    duration_s: Optional[float] = None
    finish_reason: Optional[str] = None


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 type_: str = "invalid_request_error"):
        super().__init__(message)
        self.status, self.message, self.type = status, message, type_


class HttpService:
    def __init__(self, models: ModelManager,
                 stats: Optional[Callable[[], dict]] = None,
                 reset_stats: Optional[Callable[[], None]] = None,
                 max_records: int = 1024) -> None:
        self.models = models
        self._stats = stats
        self._reset_stats = reset_stats
        self.timings: deque = deque(maxlen=max_records)
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: Set[asyncio.StreamWriter] = set()

    # -- lifecycle --------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle_conn, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._writers):
            w.close()
        with contextlib.suppress(Exception):
            await asyncio.wait_for(self._server.wait_closed(), 5.0)
        self._server = None

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                parts = line.decode("latin-1").split()
                if len(parts) != 3:
                    await self._send_json(writer, 400, oai.error_body(
                        "malformed request line"), keep_alive=False)
                    return
                method, target, version = parts
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                if "chunked" in headers.get("transfer-encoding", "").lower():
                    await self._send_json(writer, 400, oai.error_body(
                        "chunked request bodies are not supported"),
                        keep_alive=False)
                    return
                try:
                    length = int(headers.get("content-length", "0") or 0)
                except ValueError:
                    length = -1
                if not 0 <= length <= MAX_BODY:
                    await self._send_json(writer, 413, oai.error_body(
                        "bad or oversized Content-Length"), keep_alive=False)
                    return
                body = await reader.readexactly(length) if length else b""
                keep_alive = (version == "HTTP/1.1" and
                              headers.get("connection", "").lower() != "close")
                path = target.split("?", 1)[0]
                if not await self._route(method, path, body, writer,
                                         keep_alive):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter, keep_alive: bool) -> bool:
        """Serve one request; returns whether the connection stays open."""
        routes = {
            ("GET", "/health"): self._health,
            ("GET", "/v1/models"): self._list_models,
            ("GET", "/debug/stats"): self._debug_stats,
            ("POST", "/debug/stats/reset"): self._debug_reset,
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
        }
        handler = routes.get((method, path))
        if handler is None:
            known = any(p == path for _, p in routes)
            status = 405 if known else 404
            await self._send_json(writer, status, oai.error_body(
                f"{method} {path} not served", "not_found"), keep_alive)
            return keep_alive
        try:
            result = await handler(body, writer)
        except HttpError as e:
            await self._send_json(writer, e.status,
                                  oai.error_body(e.message, e.type), keep_alive)
            return keep_alive
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # the server must outlive one bad request
            logger.exception("request failed")
            await self._send_json(writer, 500, oai.error_body(
                f"internal error: {type(e).__name__}", "internal_error"),
                keep_alive=False)
            return False
        if result is None:  # handler streamed its own response
            return False
        await self._send_json(writer, 200, result, keep_alive)
        return keep_alive

    @staticmethod
    async def _send_json(writer, status: int, obj, keep_alive: bool) -> None:
        data = json.dumps(obj).encode()
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n")
        writer.write(head.encode() + data)
        await writer.drain()

    # -- simple routes -----------------------------------------------------

    async def _health(self, _body, _writer) -> dict:
        return {"status": "ready" if len(self.models) else "starting",
                "models": self.models.names()}

    async def _list_models(self, _body, _writer) -> dict:
        return oai.ModelList(
            data=[oai.ModelInfo(id=n) for n in self.models.names()]).to_dict()

    async def _debug_stats(self, _body, _writer) -> dict:
        out = dict(self._stats()) if self._stats else {}
        out["requests"] = [t.__dict__ for t in self.timings]
        return out

    async def _debug_reset(self, _body, _writer) -> dict:
        if self._reset_stats:
            self._reset_stats()
        self.timings.clear()
        return {"ok": True}

    # -- generation --------------------------------------------------------

    def _parse(self, body: bytes, cls):
        try:
            data = json.loads(body or b"null")
        except ValueError as e:
            raise HttpError(400, f"invalid JSON: {e}") from None
        try:
            req = cls.from_dict(data)
        except ValueError as e:
            raise HttpError(400, f"invalid request: {e}") from None
        handle = self.models.get(req.model)
        if handle is None:
            raise HttpError(404, f"model {req.model!r} not found",
                            "model_not_found")
        if req.n != 1:
            raise HttpError(400, "n > 1 is not supported by this server")
        return req, handle

    @staticmethod
    def _validate_context(handle: ModelHandle, pre) -> None:
        ctx = handle.max_context
        n = len(pre.token_ids)
        if n >= ctx:
            raise HttpError(400, f"prompt has {n} tokens which exceeds the "
                                 f"model's maximum context length of {ctx} "
                                 "tokens")
        if pre.sampling.max_tokens > ctx - n:
            pre.sampling = replace(pre.sampling, max_tokens=ctx - n)

    async def _chat(self, body: bytes, writer) -> Optional[dict]:
        req, handle = self._parse(body, oai.ChatCompletionRequest)
        rid = oai.request_id("chatcmpl")
        pre = handle.preprocessor.preprocess_chat(req, rid)
        self._validate_context(handle, pre)
        logger.info("request %s: chat prompt_tokens=%d stream=%s", rid,
                    len(pre.token_ids), req.stream)
        if req.stream:
            await self._stream(writer, handle, req, pre, rid, chat=True)
            return None
        text, reason, det, lps = await self._collect(handle, req, pre, rid)
        logprobs = None
        if lps:
            logprobs = oai.ChatLogprobs(content=[
                oai.ChatLogprobEntry(token=handle.tokenizer.decode([t]),
                                     logprob=lp) for t, lp in lps])
        return oai.ChatCompletionResponse(
            id=rid, model=req.model,
            choices=[oai.ChatChoice(
                message=oai.ChatMessage(role="assistant", content=text),
                finish_reason=reason, logprobs=logprobs)],
            usage=self._usage(pre, det)).to_dict()

    async def _completions(self, body: bytes, writer) -> Optional[dict]:
        req, handle = self._parse(body, oai.CompletionRequest)
        rid = oai.request_id("cmpl")
        pre = handle.preprocessor.preprocess_completion(req, rid)
        self._validate_context(handle, pre)
        logger.info("request %s: completion prompt_tokens=%d stream=%s", rid,
                    len(pre.token_ids), req.stream)
        if req.stream:
            await self._stream(writer, handle, req, pre, rid, chat=False)
            return None
        text, reason, det, lps = await self._collect(handle, req, pre, rid)
        logprobs = None
        if lps:
            logprobs = {"tokens": [handle.tokenizer.decode([t]) for t, _ in lps],
                        "token_logprobs": [lp for _, lp in lps]}
        return oai.CompletionResponse(
            id=rid, model=req.model,
            choices=[oai.CompletionChoice(text=text, finish_reason=reason,
                                          logprobs=logprobs)],
            usage=self._usage(pre, det)).to_dict()

    @staticmethod
    def _usage(pre, det: StreamDetokenizer) -> oai.Usage:
        n_in, n_out = len(pre.token_ids), det.completion_tokens
        return oai.Usage(prompt_tokens=n_in, completion_tokens=n_out,
                         total_tokens=n_in + n_out)

    async def _token_stream(self, handle: ModelHandle, pre,
                            det: StreamDetokenizer, timing: RequestTiming,
                            lp_sink: Optional[list]):
        """Engine deltas → TextDeltas, recording TTFT and inter-token
        intervals; closing it cancels the engine request."""
        start = time.monotonic()
        last_t = None
        self.timings.append(timing)
        try:
            async with contextlib.aclosing(handle.client.generate(pre)) as gen:
                async for delta in gen:
                    now = time.monotonic()
                    if lp_sink is not None and delta.logprobs:
                        lp_sink.extend(zip(delta.token_ids, delta.logprobs))
                    if delta.token_ids:
                        if last_t is None:
                            timing.ttft_s = now - start
                        else:
                            timing.itl_sum_s += now - last_t
                            timing.itl_n += 1
                        last_t = now
                        out = det.push_tokens(delta.token_ids)
                        timing.completion_tokens = det.completion_tokens
                        if out.finished:  # stop string hit mid-stream
                            timing.finish_reason = out.finish_reason
                            yield out
                            return
                        if out.text:
                            yield out
                    if delta.finished:
                        out = det.finish(delta.finish_reason)
                        timing.finish_reason = out.finish_reason
                        yield out
                        return
            # Engine stream ended without a finish marker.
            out = det.finish(FinishReason.ERROR)
            timing.finish_reason = out.finish_reason
            yield out
        finally:
            timing.duration_s = time.monotonic() - start

    def _new_timing(self, rid, req, pre) -> RequestTiming:
        return RequestTiming(request_id=rid, stream=bool(req.stream),
                             prompt_tokens=len(pre.token_ids))

    async def _collect(self, handle, req, pre, rid):
        det = StreamDetokenizer(handle.tokenizer, pre.stop_sequences)
        lps: Optional[List] = [] if pre.sampling.logprobs else None
        parts, reason = [], None
        async with contextlib.aclosing(self._token_stream(
                handle, pre, det, self._new_timing(rid, req, pre), lps)) as s:
            async for out in s:
                parts.append(out.text)
                if out.finished:
                    reason = out.finish_reason
        return "".join(parts), reason, det, lps

    async def _stream(self, writer, handle, req, pre, rid, chat: bool) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
        det = StreamDetokenizer(handle.tokenizer, pre.stop_sequences)
        lps: Optional[List] = [] if pre.sampling.logprobs else None
        sent_lps = 0

        def chunk(text: Optional[str], finish: Optional[str], role=None):
            nonlocal sent_lps
            if chat:
                logprobs = None
                if lps and len(lps) > sent_lps:
                    logprobs = oai.ChatLogprobs(content=[
                        oai.ChatLogprobEntry(
                            token=handle.tokenizer.decode([t]), logprob=lp)
                        for t, lp in lps[sent_lps:]])
                    sent_lps = len(lps)
                return oai.ChatCompletionChunk(
                    id=rid, model=req.model,
                    choices=[oai.ChatStreamChoice(
                        delta=oai.ChatChoiceDelta(role=role, content=text),
                        finish_reason=finish, logprobs=logprobs)])
            return oai.CompletionResponse(
                id=rid, model=req.model,
                choices=[oai.CompletionChoice(text=text or "",
                                              finish_reason=finish)])

        if chat:
            writer.write(oai.sse_encode(chunk("", None, role="assistant")).encode())
        async with contextlib.aclosing(self._token_stream(
                handle, pre, det, self._new_timing(rid, req, pre), lps)) as s:
            async for out in s:
                if out.text:
                    writer.write(oai.sse_encode(chunk(out.text, None)).encode())
                if out.finished:
                    writer.write(oai.sse_encode(
                        chunk(None, out.finish_reason)).encode())
                await writer.drain()
        if (req.stream_options or {}).get("include_usage"):
            usage = self._usage(pre, det)
            final = (oai.ChatCompletionChunk(id=rid, model=req.model,
                                             choices=[], usage=usage)
                     if chat else
                     oai.CompletionResponse(id=rid, model=req.model,
                                            choices=[], usage=usage))
            writer.write(oai.sse_encode(final).encode())
        writer.write(oai.SSE_DONE.encode())
        await writer.drain()
