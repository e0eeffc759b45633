"""Draft-token proposers for speculative decoding (copy of
`dynamo_tpu/engine/drafter.py`, which needs no device).

The engine's speculative step (`EngineCore._run_decode_spec`) takes any
drafter: it verifies the drafts in one batched forward
(`sampling.speculative_verify`), so a bad drafter only wastes the verify
step's width and never changes what is emitted.

- `NgramDrafter`: prompt-lookup decoding, the continuation of the most
  recent earlier occurrence of the trailing n-gram; no parameters and no
  device work.
- `DraftModelDrafter`: wraps a caller's `propose_fn(history, k)`, the hook
  for a small draft model.  It runs on the engine thread, so it must be
  synchronous and bounded.

Contract: `propose(history, k)` returns up to k draft token ids (maybe
none); the engine pads them and counts only the ones proposed.
"""

from __future__ import annotations

from typing import Callable, List, Sequence


class Drafter:
    """Interface: guess the next `k` tokens given the tokens so far."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup drafts: find the most recent earlier occurrence of
    the trailing `ngram` and propose the k tokens that followed it; empty
    when the history is short or the n-gram never repeats.  When the
    continuation is shorter than k (the match sits near the tail, as in a
    short cycle), the lookup runs again on history + draft until k tokens
    are drafted or the chain breaks."""

    def __init__(self, ngram: int = 3) -> None:
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = ngram

    def _lookup(self, hist: List[int], k: int) -> List[int]:
        n = len(hist)
        ngram = self.ngram
        if n <= ngram:
            return []
        tail = hist[-ngram:]
        # Right to left over earlier positions: the most recent wins.
        for start in range(n - ngram - 1, -1, -1):
            if hist[start:start + ngram] == tail:
                cont = hist[start + ngram:start + ngram + k]
                if cont:
                    return list(cont)
        return []

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        out: List[int] = []
        while len(out) < k:
            cont = self._lookup(hist, k - len(out))
            if not cont:
                break
            out.extend(cont)
            hist.extend(cont)
        return out[:k]


class DraftModelDrafter(Drafter):
    """Adapter for an external draft model: `propose_fn(history, k)`
    must be synchronous and bounded (it runs on the engine thread)."""

    def __init__(self, propose_fn: Callable[[Sequence[int], int],
                                            List[int]]) -> None:
        self.propose_fn = propose_fn

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        out = self.propose_fn(history, k)
        return list(out)[:k] if out else []
