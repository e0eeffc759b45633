"""Model manager + the engine-client seam (port of
`dynamo_tpu/llm/service.py`).

`EngineClient` is the streaming contract the HTTP frontend talks to;
`LocalEngineClient` serves it from an in-process `InferenceEngine` (the
single-process frontend and each worker), `llm/discovery` and
`llm/kv_router` serve it over the RPC from workers, and `ModelManager`
is the frontend's model registry (models come and go as workers do).

`LocalEngineClient` binds the serving task's trace span to the request
id (the engine thread's spans parent under it) and stamps the request
ledger's engine phases on the event loop.  The QoS class rides the
request's `priority` annotation (`priority_of`); the KV router's
selector reads it, and `LocalEngineClient` passes it to the engine's
scheduler, which admits the highest class first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Protocol

from dynamo_tpu_torch.engine.engine import InferenceEngine, TokenDelta
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.ledger import ledger_of


class EngineClient(Protocol):
    """Streaming generate contract."""

    def generate(self, request: PreprocessedRequest
                 ) -> AsyncIterator[TokenDelta]: ...


# QoS classes: the frontend's x-dynamo-priority header (or a router or
# operator annotation) rides the request's annotations under this key.
PRIORITY_ANNOTATION = "priority"
PRIORITY_CLASSES = {"best_effort": 0, "best-effort": 0, "batch": 0,
                    "standard": 1, "default": 1,
                    "interactive": 2, "realtime": 2}


def priority_of(request) -> int:
    """Priority from a request's `priority` annotation: a named class or
    a bare integer; anything malformed (a version-skewed frontend) is
    standard — never fail a request over QoS metadata."""
    raw = request.annotations.get(PRIORITY_ANNOTATION)
    if raw is None:
        return 1
    raw = str(raw).strip().lower()
    if raw in PRIORITY_CLASSES:
        return PRIORITY_CLASSES[raw]
    try:
        return max(0, min(2, int(raw)))
    except ValueError:
        return 1


class LocalEngineClient:
    """EngineClient over an in-process InferenceEngine."""

    def __init__(self, engine: InferenceEngine) -> None:
        self.engine = engine

    async def generate(self, request: PreprocessedRequest
                       ) -> AsyncIterator[TokenDelta]:
        # Bind the serving task's span to the request id so the engine
        # thread's admission→first-token spans parent under it.
        tracer = tracing.get_tracer()
        span = tracing.current_span()
        if span is not None:
            tracer.bind(request.request_id, span.ctx)
        # Ledger stamps, all on this event loop: the engine's queue /
        # prefill / first_token phases from the timings the core parked
        # at first-token time, and a per-token decode interval summary.
        led = ledger_of(request)
        n_intervals = 0
        interval_sum = 0.0
        interval_max = 0.0
        last_t: Optional[float] = None
        try:
            async for delta in self.engine.generate(
                    request.request_id, request.token_ids, request.sampling,
                    priority=priority_of(request)):
                if led is not None and delta.token_ids:
                    now = time.monotonic()
                    if last_t is None:
                        self._stamp_first_token(led, request.request_id, now)
                    else:
                        gap = now - last_t
                        n_intervals += 1
                        interval_sum += gap
                        interval_max = max(interval_max, gap)
                    last_t = now
                if led is not None and delta.finished and n_intervals:
                    led.stamp("decode", dur=interval_sum, n=n_intervals,
                              max_s=round(interval_max, 6))
                yield delta
        finally:
            tracer.unbind(request.request_id)

    def _stamp_first_token(self, led, request_id: str, emit: float) -> None:
        """Engine-phase stamps from the core's parked first-token
        timings: queue (submission→prefill start), prefill (start→end,
        with cached-token and preemption attrs) and first_token (prefill
        end→the first token's delta reaching this loop at `emit`) tile
        the engine's share of TTFT.  The first token leaves the engine
        when its step returns — after that step's window dispatch, which
        a host-bound step makes long — so `first_token` ends at its
        emission, where JAX's ends at the token's sampling (its window
        dispatch is one asynchronous call)."""
        timings = self.engine.pop_ledger_timings(request_id)
        if timings is None:
            return
        arrival, pf_start, pf_end, _first, prompt, cached, preempts = timings
        led.stamp("queue", dur=pf_start - arrival, t=pf_start)
        led.stamp("prefill", dur=pf_end - pf_start, t=pf_end,
                  prompt_tokens=prompt, cached_tokens=cached,
                  preempts=preempts)
        led.stamp("first_token", dur=emit - pf_end, t=emit)

    async def embed(self, token_lists):
        """Last-token hidden-state embeddings, [n, hidden] f32 (the
        /v1/embeddings engine surface)."""
        return await self.engine.embed(token_lists)

    async def clear_kv_blocks(self) -> int:
        return await self.engine.clear_kv_blocks()


@dataclass
class ModelHandle:
    """Everything the frontend needs to serve one model."""

    name: str
    tokenizer: Tokenizer
    preprocessor: OpenAIPreprocessor
    client: EngineClient
    # Context ceiling: a prompt alone at or over it is a 400, and
    # max_tokens is clamped to fit.
    max_context: int = 8192


class ModelManager:
    def __init__(self) -> None:
        self._models: Dict[str, ModelHandle] = {}

    def register(self, handle: ModelHandle) -> None:
        self._models[handle.name] = handle

    def remove(self, name: str) -> None:
        self._models.pop(name, None)

    def get(self, name: str) -> Optional[ModelHandle]:
        return self._models.get(name)

    def names(self) -> List[str]:
        return sorted(self._models)

    def __len__(self) -> int:
        return len(self._models)
