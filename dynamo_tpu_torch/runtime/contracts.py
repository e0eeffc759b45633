"""Runtime thread-affinity contracts for the serving hot paths (port of
`dynamo_tpu/runtime/contracts.py`).

The "engine thread only" / "never the engine thread" / "no host syncs
in the steady window" rules of the engine, the block manager and the SLO
monitor, checked at run time in two modes:

- **Default (production / bench): zero cost.**  When the
  ``DYNAMO_CONTRACTS`` env var is unset (or ``0``), every decorator
  returns the original function object unchanged — no wrapper, no
  attribute lookups, no branch on the call path.
- **Debug (``DYNAMO_CONTRACTS=1`` — the test suite's conftest sets
  it): assert caller-thread identity** on every call and raise
  :class:`ContractViolation` (an ``AssertionError`` subclass) with the
  offending thread's name when a contract is broken.

Three decorators, the same names the JAX package's static lint reads
(its rules are not ported for this package):

``@engine_thread_only``
    The function must always run on ONE consistent thread per instance
    (whichever thread calls first pins the identity).  Ownership
    legitimately transfers when ``InferenceEngine`` starts/stops its
    step loop: :func:`release_owner` clears the pin so the new owner
    re-pins on its first call.

``@never_engine_thread``
    The function must never run on a registered engine thread
    (:func:`register_engine_thread` — ``InferenceEngine._run_loop``
    registers itself).  Calling one of these from the engine thread is
    either a deadlock (awaiting a command the engine thread itself must
    drain) or a latency bug (blocking the step loop on telemetry).

``@hot_path``
    A pure marker: the function body must stay free of host syncs
    (``.item()``, ``.cpu()``, ``torch.cuda.synchronize``, blocking
    future ``.result()``) beyond the counted ones; never checked at run
    time.

All three handle plain functions, ``async def`` coroutines and async
generators (the check runs on the calling thread before delegation).
"""

from __future__ import annotations

import functools
import inspect
import os
import threading
from typing import Set


def _env_enabled() -> bool:
    return os.environ.get("DYNAMO_CONTRACTS", "0").strip().lower() not in (
        "", "0", "false", "no", "off")


#: Evaluated once at import: decoration happens at module-import time, so
#: flipping the env var mid-process has no effect (the zero-cost
#: guarantee depends on decorators resolving to the bare function object
#: when disabled).
ENABLED = _env_enabled()

_OWNER_ATTR = "_dynamo_contract_owner"

_engine_threads: Set[int] = set()
_engine_threads_lock = threading.Lock()


class ContractViolation(AssertionError):
    """A thread-affinity contract was broken (debug mode only)."""


# -- engine-thread registry ------------------------------------------------


def register_engine_thread() -> None:
    """Mark the CURRENT thread as an engine thread (the step-loop thread
    calls this on entry).  Idempotent."""
    with _engine_threads_lock:
        _engine_threads.add(threading.get_ident())


def unregister_engine_thread() -> None:
    """Remove the CURRENT thread from the engine-thread registry (the
    step loop calls this on exit, so a thread id recycled by the OS
    never haunts ``@never_engine_thread`` checks)."""
    with _engine_threads_lock:
        _engine_threads.discard(threading.get_ident())


def release_owner(*objects) -> None:
    """Clear the pinned-thread identity on the given instances so the
    next ``@engine_thread_only`` call re-pins.  Called at ownership
    transfer points: ``InferenceEngine.start()`` (the step-loop thread
    takes over a core built on the main thread) and ``stop()`` (tests
    may drive the core directly afterwards)."""
    for obj in objects:
        if obj is None:
            continue
        try:
            obj.__dict__.pop(_OWNER_ATTR, None)
        except AttributeError:
            pass  # slotted/foreign object: it was never pinned


# -- decorator plumbing ----------------------------------------------------


def _wrap(fn, check):
    """Wrap `fn` so `check(args)` runs on the calling thread first."""
    if inspect.isasyncgenfunction(fn):
        @functools.wraps(fn)
        async def agen_wrapper(*args, **kwargs):
            check(args)
            async for item in fn(*args, **kwargs):
                yield item
        return agen_wrapper
    if inspect.iscoroutinefunction(fn):
        @functools.wraps(fn)
        async def coro_wrapper(*args, **kwargs):
            check(args)
            return await fn(*args, **kwargs)
        return coro_wrapper

    @functools.wraps(fn)
    def sync_wrapper(*args, **kwargs):
        check(args)
        return fn(*args, **kwargs)
    return sync_wrapper


def engine_thread_only(fn):
    """All calls (per instance) must come from one consistent thread.

    The pin lives in the instance ``__dict__`` — the first decorated
    call stores ``(ident, name)``; later calls from a different thread
    raise.  Module-level functions pin on the function object itself.
    """
    fn.__dynamo_contract__ = "engine_thread_only"
    if not ENABLED:
        return fn

    def check(args):
        holder = args[0] if args and hasattr(args[0], "__dict__") else fn
        ident = threading.get_ident()
        # setdefault is atomic under the GIL: two threads racing the
        # FIRST call must not both pin.
        owner = holder.__dict__.setdefault(
            _OWNER_ATTR, (ident, threading.current_thread().name))
        if owner[0] != ident:
            raise ContractViolation(
                f"{fn.__qualname__} is engine-thread-only: instance is "
                f"owned by thread {owner[1]!r} but was called from "
                f"{threading.current_thread().name!r} "
                "(contracts.release_owner transfers ownership)")

    wrapper = _wrap(fn, check)
    wrapper.__dynamo_contract__ = "engine_thread_only"
    return wrapper


def never_engine_thread(fn):
    """The function must not run on a registered engine thread."""
    fn.__dynamo_contract__ = "never_engine_thread"
    if not ENABLED:
        return fn

    def check(args):
        if threading.get_ident() in _engine_threads:
            raise ContractViolation(
                f"{fn.__qualname__} must never run on the engine thread "
                f"(called from {threading.current_thread().name!r}) — it "
                "would block or deadlock the step loop")

    wrapper = _wrap(fn, check)
    wrapper.__dynamo_contract__ = "never_engine_thread"
    return wrapper


def hot_path(fn):
    """Marker only: never wraps, so the steady decode window pays
    nothing for the contract existing, in either mode."""
    fn.__dynamo_contract__ = "hot_path"
    return fn
