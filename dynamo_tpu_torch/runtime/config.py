"""Layered configuration: defaults ← TOML file ← DYN_* environment.

Port of `dynamo_tpu/runtime/config.py`.

Role of the reference's figment-based config (`lib/runtime/src/config.rs:
37,168-181`: defaults ← TOML ← `DYN_RUNTIME_*`/`DYN_SYSTEM_*`).  The
precedence here matches, with CLI flags (handled by each entrypoint's
argparse on top of these) as the final layer:

    defaults  <  TOML file  <  environment  <  CLI flags

- TOML path: `DYN_CONFIG` env var, else `./dynamo.toml` if present.
- Environment: `DYN_<KEY>` (upper-cased, `-`→`_`) overrides key `<key>`;
  values parse as TOML literals when possible (so `DYN_HTTP_PORT=8080`
  is an int and `DYN_MOCKER=true` a bool), falling back to raw strings.

Dynamic (watched) config lives on the control plane instead (the
reference's etcd-watched keys).
"""

from __future__ import annotations

import logging
import os
import tomllib
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

ENV_PREFIX = "DYN_"
DEFAULT_TOML = "dynamo.toml"


def _parse_env_value(raw: str) -> Any:
    try:
        # TOML value grammar gives ints/floats/bools/strings/lists for free.
        return tomllib.loads(f"v = {raw}")["v"]
    except tomllib.TOMLDecodeError:
        return raw


def load_layered_config(defaults: Dict[str, Any],
                        section: Optional[str] = None,
                        env_prefix: str = ENV_PREFIX,
                        toml_path: Optional[str] = None) -> Dict[str, Any]:
    """Resolve one flat config dict.  `section`: optional TOML table name
    (e.g. "worker" reads `[worker]`); top-level keys apply to every
    section (reference DYN_RUNTIME_* vs per-binary split)."""
    out = dict(defaults)

    path = toml_path or os.environ.get(env_prefix + "CONFIG") or (
        DEFAULT_TOML if os.path.exists(DEFAULT_TOML) else None)
    if path:
        try:
            with open(path, "rb") as f:
                data = tomllib.load(f)
        except (OSError, tomllib.TOMLDecodeError) as e:
            raise ValueError(f"bad config file {path!r}: {e}") from e
        for k, v in data.items():
            if not isinstance(v, dict) and k in out:
                out[k] = v
        if section and isinstance(data.get(section), dict):
            for k, v in data[section].items():
                if k in out:
                    out[k] = v

    for k in out:
        raw = os.environ.get(env_prefix + k.upper().replace("-", "_"))
        if raw is not None:
            out[k] = _parse_env_value(raw)
    return out


def apply_to_parser_defaults(parser, config: Dict[str, Any]) -> None:
    """Push resolved config values under the argparse defaults, so CLI
    flags stay the top layer: flag > env > toml > default."""
    known = {a.dest for a in parser._actions}
    parser.set_defaults(**{k.replace("-", "_"): v for k, v in config.items()
                           if k.replace("-", "_") in known})
