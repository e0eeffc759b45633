"""OpenAI-compatible HTTP service on asyncio streams (port of
`dynamo_tpu/llm/http_service.py`, standard library only).

Routes (JAX's, and the port's `/debug/stats`):
  POST /v1/chat/completions   chat, unary or SSE streaming; tools and
                              tool_choice (calls parsed from the reply,
                              llm/postprocessor.py); image_url parts
                              through the model's multimodal hook
  POST /v1/completions        text completion, unary or SSE streaming
  POST /v1/responses          the Responses API on the chat pipeline,
                              unary or SSE (named events)
  POST /v1/embeddings         last-token hidden-state embeddings
  POST /clear_kv_blocks       flush every model's reusable KV blocks
  GET  /v1/models             registered models
  GET  /metrics               Prometheus text: FrontendMetrics (the SLA
                              planner's series), RequestMetrics, the
                              ledger's phase histograms and goodput
                              pair, the SLO gauges
  GET  /debug/traces?n=K      this process's completed traces
  GET  /debug/requests?n=K    the K slowest completed request ledgers
  GET  /debug/slo             the SLO monitor's evaluation (or disabled)
  GET  /debug/flightrecorder?n=K  this process's flight-recorder ring
  GET  /debug/deviceprofile[?ms=N]  the device profiler (state / capture)
  GET  /health                readiness
  GET  /live                  liveness
  GET  /debug/stats           per-request timings + the server's stats hook
  POST /debug/stats/reset     clear both

Each generation opens an `http.{route}` root span (the request id is its
trace id) with `frontend.preprocess` under it, and records the
`frontend.queue_wait` / `frontend.ttft` / `decode.tpot` spans; the
`x-dynamo-priority` header rides the request's `priority` annotation to
the router; the request ledger begins here and completed ledgers fold
into the `LedgerSink`.

HTTP/1.1 with keep-alive for unary responses; a streaming response ends
its connection after `data: [DONE]`.  A prompt at or over the model's
context limit is a 400; max_tokens is clamped to what fits.  Only n == 1
is served.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Set
from urllib.parse import parse_qs

import numpy as np
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm import postprocessor as post
from dynamo_tpu_torch.llm.backend import StreamDetokenizer
from dynamo_tpu_torch.llm.protocols import openai as oai
from dynamo_tpu_torch.llm.service import (
    PRIORITY_ANNOTATION,
    ModelHandle,
    ModelManager,
)
from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime import ledger as ledger_mod
from dynamo_tpu_torch.runtime import slo as slo_mod
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.metrics import (
    FrontendMetrics,
    MetricsRegistry,
    RequestMetrics,
)
from dynamo_tpu_torch.runtime.status import (
    BAD_N,
    debug_deviceprofile,
    query_int,
)

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable"}
MAX_BODY = 16 * 1024 * 1024
# Inputs of one /v1/embeddings request: each is a prefill on the engine,
# and an unbounded batch would hold token streams back for seconds.
MAX_EMBED_INPUTS = 128


def _lp_token(handle, req, token_id: int) -> str:
    """A logprob entry's token: its text, or `token_id:<id>` when the
    request sets `return_tokens_as_token_ids`."""
    if req.return_tokens_as_token_ids:
        return f"token_id:{token_id}"
    return handle.tokenizer.decode([token_id])


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


@dataclass
class HttpRequest:
    """One parsed request: what a route handler reads."""

    method: str
    path: str
    query: Dict[str, List[str]]
    headers: Dict[str, str]
    body: bytes
    # The connection's reader (a streamed reply watches it for the
    # client's close).
    reader: Optional[asyncio.StreamReader] = None


_STREAMING_PATHS = ("/v1/chat/completions", "/v1/completions",
                    "/v1/responses")


def _wants_stream(req: HttpRequest) -> bool:
    try:
        return bool(json.loads(req.body or b"{}").get("stream"))
    except (ValueError, AttributeError):
        return False


def _cancel_on_close(reader: Optional[asyncio.StreamReader],
                     task: asyncio.Task) -> Optional[asyncio.Future]:
    """Watch a streamed reply's connection: the reply closes it, so the
    client sends nothing more, and an end of stream means the client is
    gone.  That cancels the handler's task, whose token stream's close
    cancels the engine request, without waiting for the next write to
    fail (a stretch of tokens that decode to no text writes nothing)."""
    if reader is None:
        return None

    async def watch() -> None:
        with contextlib.suppress(ConnectionError):
            if await reader.read(1):
                return          # not a close: leave the reply alone
        task.cancel()

    return asyncio.ensure_future(watch())


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 type_: str = "invalid_request_error"):
        super().__init__(message)
        self.status, self.message, self.type = status, message, type_


class HttpService:
    # TPOT interval spans recorded per trace before they would crowd out
    # the rest of the timeline (the histogram still sees every interval).
    MAX_TPOT_SPANS = 32

    def __init__(self, models: ModelManager,
                 stats: Optional[Callable[[], dict]] = None,
                 reset_stats: Optional[Callable[[], None]] = None,
                 max_records: int = 1024,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[tracing.Tracer] = None) -> None:
        self.models = models
        self._stats = stats
        self._reset_stats = reset_stats
        self.timings: deque = deque(maxlen=max_records)
        self.registry = registry or MetricsRegistry()
        self.metrics = FrontendMetrics(self.registry)
        # Per-request lifecycle histograms (dynamo_request_*): TTFT /
        # TPOT / queue wait and outcomes, always on (cheap).
        self.request_metrics = RequestMetrics(self.registry)
        # The SLO burn-rate monitor (runtime/slo.py) the frontend main
        # installs when --slo-* flags configure objectives; None →
        # /debug/slo reports enabled=false.
        self.slo_monitor = None
        # Where completed request ledgers fold: phase histograms, the
        # goodput pair, /debug/requests and the SLO attribution.
        self.ledger_sink = ledger_mod.LedgerSink(self.registry)
        self.tracer = tracer or tracing.get_tracer()
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
                path, _, qs = target.partition("?")
                req = HttpRequest(method, path, parse_qs(qs), headers, body,
                                  reader)
                if not await self._route(req, writer, keep_alive):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _route(self, req: HttpRequest, writer: asyncio.StreamWriter,
                     keep_alive: bool) -> bool:
        """Serve one request; returns whether the connection stays open.
        A handler returns a dict (a 200 JSON reply), a (status, body)
        pair (a str body is sent as Prometheus text), or None when it
        streamed its own response."""
        routes = {
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._live,
            ("GET", "/v1/models"): self._list_models,
            ("GET", "/metrics"): self._prometheus,
            ("GET", "/debug/traces"): self._debug_traces,
            ("GET", "/debug/requests"): self._debug_requests,
            ("GET", "/debug/slo"): self._debug_slo,
            ("GET", "/debug/flightrecorder"): self._debug_flightrecorder,
            ("GET", "/debug/deviceprofile"): self._debug_deviceprofile,
            ("GET", "/debug/stats"): self._debug_stats,
            ("POST", "/debug/stats/reset"): self._debug_reset,
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("POST", "/v1/responses"): self._responses,
            ("POST", "/v1/embeddings"): self._embeddings,
            ("POST", "/clear_kv_blocks"): self._clear_kv_blocks,
        }
        handler = routes.get((req.method, req.path))
        if handler is None:
            known = any(p == req.path for _, p in routes)
            status = 405 if known else 404
            await self._send_json(writer, status, oai.error_body(
                f"{req.method} {req.path} not served", "not_found"),
                keep_alive)
            return keep_alive
        watch = (_cancel_on_close(req.reader, asyncio.current_task())
                 if req.path in _STREAMING_PATHS and _wants_stream(req)
                 else None)
        try:
            result = await handler(req, writer)
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
        finally:
            if watch is not None:
                watch.cancel()
        if result is None:  # handler streamed its own response
            return False
        status, obj = result if isinstance(result, tuple) else (200, result)
        await self._send_json(writer, status, obj, keep_alive)
        return keep_alive

    @staticmethod
    async def _send_json(writer, status: int, obj, keep_alive: bool) -> None:
        """`obj` as JSON, or a str as Prometheus text."""
        if isinstance(obj, str):
            data, ctype = obj.encode(), "text/plain; version=0.0.4"
        else:
            data, ctype = json.dumps(obj).encode(), "application/json"
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n")
        writer.write(head.encode() + data)
        await writer.drain()

    # -- simple routes -----------------------------------------------------

    async def _health(self, _req, _writer) -> dict:
        return {"status": "ready" if len(self.models) else "starting",
                "models": self.models.names()}

    async def _live(self, _req, _writer) -> dict:
        return {"status": "live"}

    async def _list_models(self, _req, _writer) -> dict:
        return oai.ModelList(
            data=[oai.ModelInfo(id=n) for n in self.models.names()]).to_dict()

    async def _prometheus(self, _req, _writer):
        return 200, self.registry.expose()

    async def _debug_traces(self, req, _writer):
        """Most recent completed traces (`?n=K`, default 32)."""
        n = query_int(req.query, "n", 32)
        return BAD_N if n is None else tracing.debug_traces_payload(
            n, self.tracer)

    async def _debug_requests(self, req, _writer):
        """Slowest-N completed request ledgers (`?n=K`, default 10) with
        their phase stamps, the window's dominant phase and goodput."""
        n = query_int(req.query, "n", 10)
        return BAD_N if n is None else self.ledger_sink.debug_payload(n)

    async def _debug_slo(self, _req, _writer) -> dict:
        """The SLO burn-rate evaluation over this frontend's request
        histograms (the --slo-* flags enable it)."""
        if self.slo_monitor is None:
            return slo_mod.disabled_payload()
        return self.slo_monitor.payload()

    async def _debug_flightrecorder(self, req, _writer):
        """This process's flight-recorder ring (`?n=K`, default 256)."""
        n = query_int(req.query, "n", 256)
        return BAD_N if n is None else (
            flight_recorder.get_recorder().debug_payload(n))

    async def _debug_deviceprofile(self, req, _writer):
        """This process's device profiler: state without `?ms=`, one
        bounded capture with `?ms=N` (worker captures ride the workers'
        status ports or the control-plane `profile/<pid>` command)."""
        return await debug_deviceprofile(req.query)

    async def _debug_stats(self, _req, _writer) -> dict:
        out = dict(self._stats()) if self._stats else {}
        out["requests"] = [t.__dict__ for t in self.timings]
        return out

    async def _debug_reset(self, _req, _writer) -> dict:
        if self._reset_stats:
            self._reset_stats()
        self.timings.clear()
        return {"ok": True}

    async def _clear_kv_blocks(self, _req, _writer) -> dict:
        """Admin: flush every model's reusable KV blocks; per model its
        status and the count cleared."""
        out = {}
        for name in self.models.names():
            handle = self.models.get(name)
            clear = getattr(handle.client, "clear_kv_blocks", None)
            if clear is None:
                out[name] = {"status": "unsupported"}
                continue
            try:
                out[name] = {"status": "ok", "cleared": await clear()}
            except Exception as e:   # reported per model, not raised
                out[name] = {"status": "error", "error": str(e)}
        return out

    # -- embeddings --------------------------------------------------------

    async def _embeddings(self, http: HttpRequest, _writer) -> dict:
        try:
            req = oai.EmbeddingRequest.from_dict(
                json.loads(http.body or b"null"))
        except ValueError as e:
            raise HttpError(400, f"invalid request: {e}") from None
        handle = self.models.get(req.model)
        if handle is None:
            raise HttpError(404, f"model {req.model!r} not found",
                            "model_not_found")
        embed = getattr(handle.client, "embed", None)
        if embed is None:
            raise HttpError(501, "this model's engine does not serve "
                                 "embeddings", "not_implemented")
        inputs = req.inputs()
        if not inputs:
            raise HttpError(400, "input must be non-empty")
        if len(inputs) > MAX_EMBED_INPUTS:
            raise HttpError(400, f"too many inputs ({len(inputs)} > "
                                 f"{MAX_EMBED_INPUTS} per request)")
        token_lists = []
        for item in inputs:
            toks = (handle.tokenizer.encode(item) if isinstance(item, str)
                    else list(item))
            if len(toks) >= handle.max_context:
                raise HttpError(
                    400, f"input of {len(toks)} tokens exceeds the model's "
                         f"maximum context length of {handle.max_context}")
            token_lists.append(toks)
        try:
            vecs = await embed(token_lists)
        except (ValueError, NotImplementedError) as e:
            raise HttpError(400, str(e)) from None
        except (ConnectionError, OSError) as e:
            raise HttpError(503, f"embedding worker unavailable: {e}",
                            "service_unavailable") from None

        def encode(vec):
            if req.encoding_format == "base64":
                return base64.b64encode(
                    np.asarray(vec, "<f4").tobytes()).decode("ascii")
            return [float(x) for x in vec]

        n_in = sum(len(t) for t in token_lists)
        return oai.EmbeddingResponse(
            model=req.model,
            data=[oai.EmbeddingData(index=i, embedding=encode(v))
                  for i, v in enumerate(vecs)],
            usage=oai.Usage(prompt_tokens=n_in, total_tokens=n_in)).to_dict()

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
        if getattr(req, "n", 1) != 1:
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

    def _start_trace(self, route: str, rid: str, model: str):
        """Root span of one HTTP request, the request id its trace id;
        returns (span, contextvar token), no-ops when tracing is off."""
        span = self.tracer.start_span(
            f"http.{route}", trace_id=rid,
            attrs={"rid": rid, "model": model})
        token = tracing.use_span(span) if span.ctx is not None else None
        return span, token

    @staticmethod
    def _end_trace(span, token) -> None:
        span.end()
        if token is not None:
            tracing.restore(token)

    @staticmethod
    def _attach_priority(http: HttpRequest, pre) -> None:
        """QoS class: the x-dynamo-priority header (a named class or 0..2)
        rides the request's annotations; absent = standard, and the
        reading side is as forgiving (service.priority_of)."""
        header = http.headers.get("x-dynamo-priority")
        if header:
            pre.annotations[PRIORITY_ANNOTATION] = header.strip()

    async def _prepare(self, http: HttpRequest, handle, route: str,
                       rid: str, stream: bool, preprocess, root,
                       messages=None):
        """The preprocess span, the images of `messages` (a chat's), the
        context check and the priority; the prompt's size and the stream
        flag land on the root span."""
        with self.tracer.start_span("frontend.preprocess"):
            try:
                pre = preprocess()
            except ValueError as e:
                raise HttpError(400, str(e)) from None
        if messages is not None:
            pre = await self._attach_images(handle, messages, pre)
        self._validate_context(handle, pre)
        self._attach_priority(http, pre)
        logger.info("request %s: %s prompt_tokens=%d stream=%s", rid, route,
                    len(pre.token_ids), stream)
        root.set_attr(prompt_tokens=len(pre.token_ids), stream=stream)
        return pre

    async def _attach_images(self, handle, messages, pre):
        """image_url parts -> prompt_embeds through the model's hook
        (llm/multimodal.py); a model without one refuses them."""
        from dynamo_tpu_torch.llm.multimodal import MultimodalAttach

        if not MultimodalAttach.image_refs(messages):
            return pre
        if handle.multimodal is None:
            raise HttpError(400, "this model has no multimodal pipeline "
                                 "configured (image_url parts unsupported)")
        try:
            with self.tracer.start_span("frontend.encode_images"):
                return await handle.multimodal.attach(messages, pre)
        except Exception as e:
            raise HttpError(502, f"image encoding failed: {e}",
                            "encode_error") from None

    async def _chat(self, http: HttpRequest, writer) -> Optional[dict]:
        req, handle = self._parse(http.body, oai.ChatCompletionRequest)
        rid = oai.request_id("chatcmpl")
        root, tok = self._start_trace("chat", rid, req.model)
        try:
            pre = await self._prepare(
                http, handle, "chat", rid, bool(req.stream),
                lambda: handle.preprocessor.preprocess_chat(req, rid), root,
                messages=req.messages)
            if req.stream:
                await self._stream(writer, handle, req, pre, rid, chat=True)
                return None
            text, reason, det, lps = await self._collect(handle, req, pre,
                                                         rid)
        finally:
            self._end_trace(root, tok)
        tool_calls = None
        if req.tools and req.tool_choice != "none":
            # Only a request that declares tools is parsed; a parse
            # failure leaves plain content.  A forced function takes the
            # whole completion as its arguments.
            forced = post.forced_tool_name(req.tool_choice, req.tools)
            if forced:
                text, calls = "", post.force_tool_call(text, forced)
            else:
                text, calls = post.parse_tool_calls(text,
                                                    req.tool_call_parser)
            if calls:
                tool_calls, reason = calls, "tool_calls"
        logprobs = None
        if lps:
            logprobs = oai.ChatLogprobs(content=[
                oai.ChatLogprobEntry(token=_lp_token(handle, req, t),
                                     logprob=lp) for t, lp in lps])
        return oai.ChatCompletionResponse(
            id=rid, model=req.model,
            choices=[oai.ChatChoice(
                # `content` is present (maybe "") unless the message is a
                # tool call.
                message=oai.ChatMessage(
                    role="assistant",
                    content=(text or None) if tool_calls else text,
                    tool_calls=tool_calls),
                finish_reason=reason, logprobs=logprobs)],
            usage=self._usage(pre, det)).to_dict()

    async def _responses(self, http: HttpRequest, writer) -> Optional[dict]:
        """/v1/responses: normalised onto the chat pipeline; unary, or SSE
        `response.created` -> `response.output_text.delta`* ->
        `response.completed`."""
        body, handle = self._parse(http.body, oai.ResponsesRequest)
        rid = oai.request_id("resp")
        root, tok = self._start_trace("responses", rid, body.model)
        try:
            chat = body.as_chat()
            pre = await self._prepare(
                http, handle, "responses", rid, bool(body.stream),
                lambda: handle.preprocessor.preprocess_chat(chat, rid), root)
            if body.stream:
                await self._stream_responses(writer, handle, body, chat,
                                             pre, rid)
                return None
            text, reason, det, _ = await self._collect(handle, chat, pre,
                                                       rid)
        finally:
            self._end_trace(root, tok)
        return self._responses_body(body, rid, text, reason, pre,
                                    det).to_dict()

    @staticmethod
    def _responses_body(body, rid, text, reason, pre, det):
        # Responses-API status: stop -> completed; the length ceiling ->
        # incomplete; an engine error -> failed.
        status = {"stop": "completed", "length": "incomplete",
                  "error": "failed"}.get(str(reason or "stop"), "completed")
        n_in, n_out = len(pre.token_ids), det.completion_tokens
        return oai.ResponsesResponse(
            id=rid, model=body.model, status=status,
            output=[oai.ResponseOutputMessage(
                status=status,
                content=[oai.ResponseOutputText(text=text)])],
            usage=oai.ResponsesUsage(input_tokens=n_in, output_tokens=n_out,
                                     total_tokens=n_in + n_out))

    async def _stream_responses(self, writer, handle, body, chat, pre,
                                rid) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
        created = oai.ResponsesResponse(id=rid, model=body.model,
                                        status="in_progress")
        writer.write(oai.sse_encode_event(
            "response.created", {"type": "response.created",
                                 "response": created.to_dict()}).encode())
        det = StreamDetokenizer(handle.tokenizer, pre.stop_sequences)
        parts, reason = [], None
        async with contextlib.aclosing(self._token_stream(
                handle, pre, det, self._new_timing(rid, chat, pre), None,
                body.model)) as s:
            async for out in s:
                if out.text:
                    parts.append(out.text)
                    writer.write(oai.sse_encode_event(
                        "response.output_text.delta",
                        {"type": "response.output_text.delta",
                         "delta": out.text}).encode())
                if out.finished:
                    reason = out.finish_reason
                await writer.drain()
        final = self._responses_body(body, rid, "".join(parts), reason, pre,
                                     det)
        writer.write(oai.sse_encode_event(
            "response.completed", {"type": "response.completed",
                                   "response": final.to_dict()}).encode())
        await writer.drain()

    async def _completions(self, http: HttpRequest, writer) -> Optional[dict]:
        req, handle = self._parse(http.body, oai.CompletionRequest)
        rid = oai.request_id("cmpl")
        root, tok = self._start_trace("completion", rid, req.model)
        try:
            pre = await self._prepare(
                http, handle, "completion", rid, bool(req.stream),
                lambda: handle.preprocessor.preprocess_completion(req, rid),
                root)
            if req.stream:
                await self._stream(writer, handle, req, pre, rid, chat=False)
                return None
            text, reason, det, lps = await self._collect(handle, req, pre,
                                                         rid)
        finally:
            self._end_trace(root, tok)
        logprobs = None
        if lps:
            logprobs = {"tokens": [_lp_token(handle, req, t) for t, _ in lps],
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
                            lp_sink: Optional[list], model: str):
        """Engine deltas → TextDeltas, with the TTFT / ITL observations,
        the request-lifecycle spans (queue wait → TTFT → per-token TPOT
        intervals, under the request's root span), the request ledger and
        the terminal outcome; closing it cancels the engine request."""
        start = time.monotonic()
        labels = {"model": model}
        self.metrics.requests_total.inc(labels=labels)
        self.metrics.requests_in_flight.add(1, labels=labels)
        tracer = self.tracer
        parent = tracing.current_span() if tracer.enabled else None
        # The ledger begins before the client pipeline, so route / queue /
        # prefill / kv_transfer stamps land on it.
        led = ledger_mod.begin(pre)
        # Queue wait, frontend view: arrival → the generation stream
        # starting; the engine.queue_wait span covers in-engine wait.
        t_entry = time.monotonic()
        self.request_metrics.queue_wait.observe(t_entry - start,
                                                labels=labels)
        if led is not None:
            led.stamp("receive", dur=t_entry - start, t=t_entry)
        if parent is not None:
            tracer.record_span("frontend.queue_wait", parent, start, t_entry)
        last_t = None
        self.timings.append(timing)

        def done(ok: bool) -> None:
            # The terminal outcome feeds the SLO error-rate objective;
            # the ledger folds with the request's TTFT and mean TPOT.
            self.request_metrics.observe_outcome(ok=ok)
            self.ledger_sink.fold(
                led, timing.ttft_s,
                timing.itl_sum_s / timing.itl_n if timing.itl_n else None,
                det.completion_tokens, ok=ok)

        try:
            async with contextlib.aclosing(handle.client.generate(pre)) as gen:
                async for delta in gen:
                    now = time.monotonic()
                    ledger_mod.absorb_delta(pre, delta, where="frontend")
                    if lp_sink is not None and delta.logprobs:
                        lp_sink.extend(zip(delta.token_ids, delta.logprobs))
                    if delta.token_ids:
                        if last_t is None:
                            timing.ttft_s = now - start
                            self.metrics.ttft.observe(timing.ttft_s,
                                                      labels=labels)
                            self.request_metrics.ttft.observe(
                                timing.ttft_s, labels=labels)
                            if parent is not None:
                                tracer.record_span("frontend.ttft", parent,
                                                   start, now)
                        else:
                            timing.itl_sum_s += now - last_t
                            timing.itl_n += 1
                            self.metrics.itl.observe(now - last_t,
                                                     labels=labels)
                            self.request_metrics.tpot.observe(
                                now - last_t, labels=labels)
                            if (parent is not None
                                    and timing.itl_n <= self.MAX_TPOT_SPANS):
                                tracer.record_span(
                                    "decode.tpot", parent, last_t, now,
                                    attrs={"index": timing.itl_n,
                                           "tokens": len(delta.token_ids)})
                        last_t = now
                        out = det.push_tokens(delta.token_ids)
                        timing.completion_tokens = det.completion_tokens
                        if out.finished:  # stop string hit mid-stream
                            timing.finish_reason = out.finish_reason
                            done(True)
                            yield out
                            return
                        if out.text:
                            yield out
                    if delta.finished:
                        # Engine ERROR finishes burn error budget; stop,
                        # length and cancel are served requests.
                        done(delta.finish_reason is not FinishReason.ERROR)
                        out = det.finish(delta.finish_reason)
                        timing.finish_reason = out.finish_reason
                        yield out
                        return
            # Engine stream ended without a finish marker (worker died).
            done(False)
            out = det.finish(FinishReason.ERROR)
            timing.finish_reason = out.finish_reason
            yield out
        finally:
            timing.duration_s = time.monotonic() - start
            self.metrics.requests_in_flight.add(-1, labels=labels)
            self.metrics.request_duration.observe(timing.duration_s,
                                                  labels=labels)
            self.metrics.input_tokens.observe(len(pre.token_ids),
                                              labels=labels)
            self.metrics.output_tokens.observe(det.completion_tokens,
                                               labels=labels)

    def _new_timing(self, rid, req, pre) -> RequestTiming:
        return RequestTiming(request_id=rid, stream=bool(req.stream),
                             prompt_tokens=len(pre.token_ids))

    async def _collect(self, handle, req, pre, rid):
        det = StreamDetokenizer(handle.tokenizer, pre.stop_sequences)
        lps: Optional[List] = [] if pre.sampling.logprobs else None
        parts, reason = [], None
        async with contextlib.aclosing(self._token_stream(
                handle, pre, det, self._new_timing(rid, req, pre), lps,
                req.model)) as s:
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
                            token=_lp_token(handle, req, t), logprob=lp)
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

        # Streaming tool calls: the parser turns content deltas into
        # `delta.tool_calls` fragments; the finish reason becomes
        # "tool_calls" when any call went out.
        parser = None
        if chat and req.tools and req.tool_choice != "none":
            parser = post.StreamingToolCallParser(
                req.tool_call_parser,
                forced_name=post.forced_tool_name(req.tool_choice, req.tools))

        def tool_chunk(call):
            return oai.ChatCompletionChunk(
                id=rid, model=req.model,
                choices=[oai.ChatStreamChoice(
                    delta=oai.ChatChoiceDelta(tool_calls=[call]))])

        if chat:
            writer.write(oai.sse_encode(chunk("", None, role="assistant")).encode())
        async with contextlib.aclosing(self._token_stream(
                handle, pre, det, self._new_timing(rid, req, pre), lps,
                req.model)) as s:
            async for out in s:
                text, calls, finish = out.text, [], out.finish_reason
                if parser is not None:
                    text, calls = (parser.push(out.text) if out.text
                                   else ("", []))
                    if out.finished:
                        rest, more, any_calls = parser.finish()
                        text, calls = text + rest, calls + more
                        if any_calls:
                            finish = "tool_calls"
                if text:
                    writer.write(oai.sse_encode(chunk(text, None)).encode())
                for call in calls:
                    writer.write(oai.sse_encode(tool_chunk(call)).encode())
                if out.finished:
                    writer.write(oai.sse_encode(
                        chunk(None, finish)).encode())
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
