"""Request migration: resume in-flight streams across worker death (port
of `dynamo_tpu/llm/migration.py`, the re-prefill rung: the planned-drain
handoff with its KV carry comes with the drain, and the flight-recorder
hook with the observability modules).

Role of the reference's `lib/llm/src/migration.rs:27-163` (RetryManager):
wraps an EngineClient; when the stream dies mid-request (ConnectionError /
no instances), it re-issues the request to a surviving worker with the
already-generated tokens appended to the prompt and `max_tokens`
decremented (`track_response` semantics, `migration.rs:148-163`), up to
`migration_limit` attempts.  The client sees one uninterrupted stream.

Resume contract: greedy streams are identical to uninterrupted serving
(the resumed prompt recomputes the same logits); seeded stochastic
streams keep the (seed, token-index) law via `SamplingParams.seed_offset`,
which advances the engine's draw index by the tokens a previous
incarnation already emitted.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
from typing import AsyncIterator

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.runtime.distributed import NoInstancesError
from dynamo_tpu_torch.runtime.logutil import warn_rate_limited

logger = logging.getLogger(__name__)

RETRYABLE = (ConnectionError, NoInstancesError)


class MigrationClient:
    """EngineClient decorator adding stream migration."""

    def __init__(self, inner, migration_limit: int = 3,
                 retry_delay: float = 0.05,
                 max_retry_delay: float = 2.0,
                 registry=None) -> None:
        """`registry` (runtime/metrics.MetricsRegistry, optional): counts
        `dynamo_migrations_total{reason}` — "death" (the connection died
        mid-stream) or "no_instances" (routing found nobody)."""
        self.inner = inner
        self.migration_limit = migration_limit
        self.retry_delay = retry_delay
        self.max_retry_delay = max_retry_delay
        self.migrations = 0          # cumulative hops
        self._counter = (registry.counter(
            "migrations_total",
            "Stream migrations by trigger reason (drain handoff, drain "
            "refusal, worker death, empty instance set)")
            if registry is not None else None)

    def _backoff(self, attempt: int) -> float:
        """Jittered exponential backoff: 2^attempt over the base delay,
        capped, with +/-50% jitter so a fleet of retrying streams never
        thunders back in lockstep."""
        base = min(self.max_retry_delay,
                   self.retry_delay * (2.0 ** attempt))
        return base * (0.5 + random.random())

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        generated: list = []
        attempts_left = self.migration_limit
        attempt = 0
        req = request
        while True:
            gen = self.inner.generate(req)
            try:
                async for delta in gen:
                    generated.extend(delta.token_ids)
                    yield delta
                    if delta.finished:
                        return
                return  # clean end without finished marker: done
            except RETRYABLE as e:
                reason = ("no_instances"
                          if isinstance(e, NoInstancesError) else "death")
            finally:
                # Deterministic close: an upstream disconnect leaves `gen`
                # suspended — close it NOW so the wire layer sends its
                # cancel frame before the retry, not at GC time.
                try:
                    await gen.aclose()
                except Exception:
                    pass  # nothing to salvage: the stream is done either way
            if attempts_left <= 0:
                logger.error("migration budget exhausted for %s (last "
                             "reason: %s)", request.request_id, reason)
                raise ConnectionError(
                    f"migration budget exhausted after "
                    f"{self.migration_limit} attempts ({reason})")
            attempts_left -= 1
            attempt += 1
            self.migrations += 1
            if self._counter is not None:
                self._counter.inc(labels={"reason": reason})
            # Resume: prompt + tokens so far; budget shrinks by what was
            # already delivered (reference migration.rs:148), and
            # seed_offset keeps seeded sampling's (seed, token-index)
            # contract across the hop.
            new_max = request.sampling.max_tokens - len(generated)
            if new_max <= 0:
                # Full budget was delivered before the worker left (only
                # the finished marker was lost) — close the stream as a
                # normal length-finish, not an error.
                yield TokenDelta(request_id=request.request_id,
                                 token_ids=[], finished=True,
                                 finish_reason=FinishReason.LENGTH)
                return
            req = dataclasses.replace(
                request,
                request_id=(f"{request.request_id}"
                            f"#m{self.migration_limit - attempts_left}"),
                token_ids=list(request.token_ids) + generated,
                annotations=dict(request.annotations),
                sampling=dataclasses.replace(
                    request.sampling, max_tokens=new_max,
                    seed_offset=(request.sampling.seed_offset
                                 + len(generated))),
            )
            # One warning per reason, rate-limited across the retry storm
            # a dead fleet produces.
            warn_rate_limited(
                logger, f"migrate:{reason}", 10.0,
                "migrating streams (%s): e.g. %s, %d tokens in, "
                "%d attempts left",
                reason, request.request_id, len(generated), attempts_left)
            await asyncio.sleep(self._backoff(attempt - 1))

    async def embed(self, token_lists):
        return await self.inner.embed(token_lists)

    async def clear_kv_blocks(self) -> int:
        return await self.inner.clear_kv_blocks()
