"""Pluggable KV persistence backends for the control plane.

Port of `dynamo_tpu/runtime/kv_store.py`.

Role of the reference's `lib/runtime/src/storage/key_value_store/
{etcd,mem,nats}.rs` — one KeyValueStore interface, several stores.  Here
the control plane IS the store (ControlPlaneState); the pluggable part
is its persistence:

- **MemoryBackend** — nothing survives the process (the default; the
  mem.rs analog).
- **FileBackend** — UNLEASED keys (operator config: disagg thresholds,
  model metadata) survive control-plane restarts via an atomic JSON
  snapshot.  LEASED keys are deliberately NOT persisted: they are
  liveness records whose leases died with the process — reloading them
  would resurrect ghost workers (etcd's lease semantics).

Backends only see unleased traffic; ControlPlaneState filters.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, Optional, Protocol

logger = logging.getLogger(__name__)


class KeyValueBackend(Protocol):
    def load(self) -> Dict[str, dict]:
        """Initial (unleased) contents."""
        ...

    def put(self, key: str, value: dict) -> None: ...

    def delete(self, key: str) -> None: ...


class MemoryBackend:
    def load(self) -> Dict[str, dict]:
        return {}

    def put(self, key: str, value: dict) -> None:
        pass

    def delete(self, key: str) -> None:
        pass


class FileBackend:
    """Atomic-snapshot JSON file; every mutation rewrites the snapshot
    (control-plane config churn is low-rate — correctness over IO)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._data: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except (OSError, json.JSONDecodeError):
                logger.exception("kv snapshot %s unreadable; starting "
                                 "empty", path)
                self._data = {}

    def load(self) -> Dict[str, dict]:
        return dict(self._data)

    def _flush(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".kv_snapshot_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f)
            os.replace(tmp, self.path)
        except OSError:
            logger.exception("kv snapshot flush failed")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def put(self, key: str, value: dict) -> None:
        self._data[key] = value
        self._flush()

    def delete(self, key: str) -> None:
        if self._data.pop(key, None) is not None:
            self._flush()


def make_backend(spec: Optional[str]) -> KeyValueBackend:
    """'file:/path.json' → FileBackend; None/'' / 'memory' → memory."""
    if not spec or spec == "memory":
        return MemoryBackend()
    if spec.startswith("file:"):
        return FileBackend(spec[len("file:"):])
    raise ValueError(f"unknown kv store spec {spec!r} "
                     "(have: memory, file:PATH)")
