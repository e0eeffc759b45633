"""Rate-limited logging for serving-path failure swallows.

Port of `dynamo_tpu/runtime/logutil.py`.

dynamo-lint rule DL003 forbids silent `except Exception: pass` in
serving-path modules: donor/transfer/control-plane failures used to
vanish entirely.  Most of those sites sit on per-request or per-poll
paths where UNBOUNDED logging would flood under a persistent failure
(a dead donor hit by every request, a backend whose memory_stats always
raises) — this helper logs the first occurrence per key immediately and
then at most once per `interval` seconds.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

_last_emit: Dict[str, float] = {}
_lock = threading.Lock()


def warn_rate_limited(logger, key: str, interval: float,
                      msg: str, *args) -> bool:
    """`logger.warning(msg, *args)` at most once per `interval` seconds
    per `key`; returns True when the record was actually emitted.
    Thread-safe (telemetry threads and event loops share keys)."""
    now = time.monotonic()
    with _lock:
        last = _last_emit.get(key)
        if last is not None and now - last < interval:
            return False
        _last_emit[key] = now
    logger.warning(msg, *args)
    return True
