"""Echo engine: the pipeline-testing backend (port of
`dynamo_tpu/llm/echo.py`).

Role of the reference's `EchoEngineCore`/`EchoEngineFull`
(`lib/llm/src/engines.rs:71,113`, selectable as `dynamo-run out=echo`):
an EngineClient that streams the prompt's own tokens back at a fixed
cadence, so every frontend, router and migration behavior is testable
with no model weights and deterministic output.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest


class EchoEngine:
    """Streams the prompt back, one token per `delay_ms`, capped by
    max_tokens; finish_reason mirrors the cap semantics."""

    def __init__(self, delay_ms: float = 1.0) -> None:
        self.delay_ms = delay_ms

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        rid = request.request_id
        budget = request.sampling.max_tokens
        out = list(request.token_ids)[:budget]
        for i, tok in enumerate(out):
            await asyncio.sleep(self.delay_ms / 1000.0)
            last = i == len(out) - 1
            yield TokenDelta(
                request_id=rid, token_ids=[tok], finished=last,
                finish_reason=(FinishReason.LENGTH if last else None))
        if not out:
            yield TokenDelta(request_id=rid, token_ids=[], finished=True,
                             finish_reason=FinishReason.LENGTH)
