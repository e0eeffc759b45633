"""Request migration: resume in-flight streams across worker death AND
planned drain (port of `dynamo_tpu/llm/migration.py`).

Role of the reference's `lib/llm/src/migration.rs:27-163` (RetryManager):
wraps an EngineClient; when the stream dies mid-request (ConnectionError /
no instances), it re-issues the request to a surviving worker with the
already-generated tokens appended to the prompt and `max_tokens`
decremented (`track_response` semantics, `migration.rs:148-163`), up to
`migration_limit` attempts.  The client sees one uninterrupted stream.

KV-carrying migration: a worker leaving
the fleet (planner scale-down, `--drain` SIGTERM, control-plane drain
command) ends each in-flight stream with a `migrate` delta — llm/drain.py
— naming its kv_blocks address and the stream's sealed-token high-water
mark.  The re-issue then carries a `migrate_kv` annotation
(prefix_share.MIGRATE_ANNOTATION); the receiving worker's
PrefixShareClient pulls the resident prefix peer-to-peer (CUDA IPC
where the peers share a card) BEFORE admission, so the resumed stream prefills only
the unsealed tail instead of recomputing everything the source already
paid for.  The re-prefill path stays as the fallback rung for unplanned
death and refused pulls.

Resume contract: greedy streams are byte-identical to uninterrupted
serving (the sealed prefix is the same KV, the tail recomputes the same
logits); seeded stochastic streams keep the (seed, token-index) law via
`SamplingParams.seed_offset`, which advances the engine's draw index by
the tokens a previous incarnation already emitted.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import time
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.block_manager.prefix_share import (
    MIGRATE_ANNOTATION,
    encode_hint,
)
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime.distributed import NoInstancesError
from dynamo_tpu_torch.runtime.ledger import ledger_of
from dynamo_tpu_torch.runtime.logutil import warn_rate_limited
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)

RETRYABLE = (ConnectionError, NoInstancesError)

# A draining worker refuses new admissions with this marker in the error
# string (llm/drain.py raises it; the RPC layer relays handler errors as
# RpcError with the remote message).  The refusal is as retryable as a
# death: the instance record is about to vanish — re-route elsewhere.
DRAIN_REFUSAL = "worker-draining"


def _is_drain_refusal(e: Exception) -> bool:
    return DRAIN_REFUSAL in str(e)


class MigrationClient:
    """EngineClient decorator adding stream migration.

    `registry` (runtime/metrics.MetricsRegistry, optional): counts
    `dynamo_migrations_total{reason}` — reason is what triggered the
    hop: "drain" (planned handoff, KV carried when the source offered
    it), "drain_refused" (raced a worker into its drain window),
    "death" (connection died mid-stream), "no_instances" (routing found
    nobody; the retry waits out the re-registration window).
    """

    def __init__(self, inner, migration_limit: int = 3,
                 retry_delay: float = 0.05, max_retry_delay: float = 2.0,
                 registry=None) -> None:
        self.inner = inner
        self.migration_limit = migration_limit
        self.retry_delay = retry_delay
        self.max_retry_delay = max_retry_delay
        self.migrations = 0          # cumulative hops (all reasons)
        self._counter = (registry.counter(
            "migrations_total",
            "Stream migrations by trigger reason (drain handoff, drain "
            "refusal, worker death, empty instance set)")
            if registry is not None else None)

    async def embed(self, token_lists):
        return await self.inner.embed(token_lists)

    async def clear_kv_blocks(self) -> int:
        return await self.inner.clear_kv_blocks()

    def _backoff(self, attempt: int) -> float:
        """Jittered exponential backoff: 2^attempt over the base delay,
        capped, with +/-50% jitter so a fleet of retrying streams never
        thunders back in lockstep."""
        base = min(self.max_retry_delay,
                   self.retry_delay * (2.0 ** attempt))
        return base * (0.5 + random.random())

    def _count(self, reason: str) -> None:
        self.migrations += 1
        if self._counter is not None:
            self._counter.inc(labels={"reason": reason})
        fl = flight_recorder.get_recorder()
        if fl.enabled:
            fl.record("migrate", reason=reason, hops=self.migrations)

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        generated: list = []
        attempts_left = self.migration_limit
        attempt = 0
        req = request
        led = ledger_of(request)
        while True:
            migrate_info: Optional[dict] = None
            reason = None
            t_break = None
            gen = self.inner.generate(req)
            try:
                async for delta in gen:
                    if delta.migrate is not None:
                        # Planned drain handoff: the worker ends the
                        # stream here with its KV address; nothing to
                        # surface to the client — resume on a peer.
                        migrate_info = delta.migrate
                        reason = "drain"
                        break
                    generated.extend(delta.token_ids)
                    yield delta
                    if delta.finished:
                        return
                if migrate_info is None:
                    return  # clean end without finished marker: done
            except RETRYABLE as e:
                reason = ("no_instances"
                          if isinstance(e, NoInstancesError) else "death")
            except RpcError as e:
                if not _is_drain_refusal(e):
                    raise
                reason = "drain_refused"
            finally:
                # Deterministic close: a break (migrate delta) or an
                # upstream disconnect leaves `gen` suspended — close it
                # NOW so the wire layer sends its cancel frame and
                # worker-side wrappers run their cleanup before the
                # retry, not at GC time.
                t_break = time.monotonic()
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
            self._count(reason)
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
            annotations = dict(request.annotations)
            # A stale migrate hint from a previous hop must never chase
            # a worker that has since exited.
            annotations.pop(MIGRATE_ANNOTATION, None)
            carry = 0
            if (migrate_info and migrate_info.get("address")
                    and migrate_info.get("covered_tokens", 0) > 0):
                # KV-carrying rung: tell the receiving worker where the
                # sealed prefix lives; its PrefixShareClient pulls it
                # before admission (re-prefill only on refusal).
                carry = int(migrate_info["covered_tokens"])
                annotations[MIGRATE_ANNOTATION] = encode_hint(
                    migrate_info["address"], carry)
            req = dataclasses.replace(
                request,
                request_id=(f"{request.request_id}"
                            f"#m{self.migration_limit - attempts_left}"),
                token_ids=list(request.token_ids) + generated,
                annotations=annotations,
                sampling=dataclasses.replace(
                    request.sampling, max_tokens=new_max,
                    seed_offset=(request.sampling.seed_offset
                                 + len(generated))),
            )
            if led is not None:
                # The live ledger rides as a PLAIN attribute, not a
                # dataclass field — dataclasses.replace drops it, so the
                # resumed incarnation must carry it explicitly.
                req.ledger = led
            # One warning per stream per reason, rate-limited across the
            # retry storm a dead fleet produces (was one line per
            # attempt per request).
            warn_rate_limited(
                logger, f"migrate:{reason}", 10.0,
                "migrating streams (%s): e.g. %s, %d tokens in, "
                "%d KV tokens carried, %d attempts left",
                reason, request.request_id, len(generated), carry,
                attempts_left)
            if reason != "drain":
                # Planned handoffs re-route immediately (the drained
                # worker already left the instance set); failures back
                # off with jitter.
                await asyncio.sleep(self._backoff(attempt - 1))
            if led is not None and t_break is not None:
                # Client-visible stall: stream break → re-issue
                # (includes the backoff for unplanned deaths).
                led.stamp("migration", dur=time.monotonic() - t_break,
                          reason=reason, attempt=attempt,
                          carried_tokens=carry)
