"""Local model-hub resolution (port of `dynamo_tpu/models/hub.py`).

`org/repo` names resolve in the standard huggingface_hub cache layout,

    $HF_HUB_CACHE  or  $HF_HOME/hub  (default ~/.cache/huggingface/hub)
        models--{org}--{repo}/snapshots/{revision}/

taking the revision `refs/main` names (else the most recently modified
snapshot).  Nothing is downloaded: a cache miss raises with the paths it
looked in, and the directory found loads as a checkpoint directory
(models/loader.py).
"""

from __future__ import annotations

import os
from typing import Optional


def hub_cache_dir() -> str:
    """The huggingface_hub cache root, honoring its env overrides."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    hf_home = os.environ.get("HF_HOME",
                             os.path.expanduser("~/.cache/huggingface"))
    return os.path.join(hf_home, "hub")


def resolve_cached_repo(repo_id: str,
                        cache_dir: Optional[str] = None) -> str:
    """`org/repo` -> its local snapshot directory, or FileNotFoundError."""
    cache = cache_dir or hub_cache_dir()
    folder = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    snapshots = os.path.join(folder, "snapshots")
    if not os.path.isdir(snapshots):
        raise FileNotFoundError(
            f"model {repo_id!r} not in the local hub cache "
            f"(looked in {snapshots}; nothing is downloaded — "
            "pre-populate the cache or pass a checkpoint directory)")
    # refs/main holds the commit hash the default revision points at.
    ref = os.path.join(folder, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            rev = f.read().strip()
        path = os.path.join(snapshots, rev)
        if os.path.isdir(path):
            return path
    revs = [os.path.join(snapshots, d) for d in os.listdir(snapshots)]
    revs = [d for d in revs if os.path.isdir(d)]
    if not revs:
        raise FileNotFoundError(
            f"model {repo_id!r}: cache folder exists but holds no "
            f"snapshots ({snapshots})")
    return max(revs, key=os.path.getmtime)
