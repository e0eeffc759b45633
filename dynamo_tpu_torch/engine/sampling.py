"""Token sampling on the device (port of `dynamo_tpu/engine/sampling.py`).

Every row carries its own (temperature, top_k, top_p); greedy is
temperature == 0.  `_filtered_logits` is the JAX filter op for op.

Random draws: JAX folds a threefry key per row with the token index; those
bits cannot be reproduced here.  The port keeps the same law — a row's
draw depends only on (seed, token index + seed_offset) — with a torch
generator per draw (Philox on the card) seeded from that pair, and draws
by the Gumbel-max trick over the filtered logits, which samples exactly
the categorical distribution.  Stochastic outputs therefore agree with
JAX in distribution, not token for token; greedy agrees exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling config."""

    temperature: float = 0.0     # 0 → greedy
    top_k: int = 0               # 0 → disabled
    top_p: float = 1.0           # 1 → disabled
    max_tokens: int = 16
    stop_token_ids: tuple = ()
    seed: Optional[int] = None
    # Return the log-probability of each sampled token (OpenAI
    # `logprobs`); such requests take the single-step decode path.
    logprobs: bool = False
    # Tokens an earlier incarnation of this stream already emitted, so a
    # seeded row keeps its (seed, token index) law across a restart.
    seed_offset: int = 0


def chosen_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) under softmax(logits): [B, V], [B] → [B] float32."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return picked - logz


def _filtered_logits(
    logits: torch.Tensor,        # [B, V] float32
    temperature: torch.Tensor,   # [B]
    top_k: torch.Tensor,         # [B] int, 0 = off
    top_p: torch.Tensor,         # [B] float32, 1.0 = off
) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p survivors kept and the
    rest at -inf."""
    B, V = logits.shape
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    safe_temp = torch.where(temperature > 0, temperature,
                            torch.ones_like(temperature))
    scaled = logits / safe_temp[:, None]
    # One descending sort serves both filters.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    top_k = top_k.long()
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=V),
                        torch.full_like(top_k, V))
    kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, neg_inf)
    # top-p on the top-k-masked distribution: the first k_eff sorted
    # columns are the survivors; keep the smallest prefix reaching top_p.
    # top_p >= 1 bypasses the cutoff (f32 cumsum can round below 1).
    col = torch.arange(V, device=logits.device)[None, :]
    sorted_masked = torch.where(col < k_eff[:, None], sorted_desc, neg_inf)
    cumprobs = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    # First index reaching top_p (0 when none does, as jnp.argmax).
    cutoff_idx = torch.argmax((cumprobs >= top_p[:, None]).to(torch.int8),
                              dim=-1)
    cutoff_logit = torch.gather(sorted_masked, 1, cutoff_idx[:, None])
    top_p_on = (top_p < 1.0)[:, None]
    return torch.where(top_p_on & (scaled < cutoff_logit), neg_inf, scaled)


def draw_seed(seed: int, index: int) -> int:
    """64-bit generator seed for draw `index` of a stream seeded `seed`
    (splitmix64 of the pair): distinct pairs give unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _gumbel(n: int, seed: int, index: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(seed, index))
    u = torch.rand((n,), generator=g, device=device)
    return -torch.log(-torch.log(u))


def sample(
    logits: torch.Tensor,        # [B, V] float32
    temperature: torch.Tensor,   # [B]
    top_k: torch.Tensor,         # [B]
    top_p: torch.Tensor,         # [B]
    seeds: Sequence[Optional[int]],  # [B] host: None for greedy rows
    indices: Sequence[int],      # [B] host: token index of this draw
) -> torch.Tensor:
    """One token per row: argmax where temperature == 0 (or seed None),
    else a categorical draw from the filtered distribution keyed by
    (seed, index)."""
    greedy_tok = torch.argmax(logits, dim=-1)
    rows = [i for i, s in enumerate(seeds) if s is not None]
    if not rows:
        return greedy_tok.to(torch.int32)
    scaled = _filtered_logits(logits, temperature, top_k, top_p)
    V = logits.shape[1]
    noise = torch.stack([_gumbel(V, seeds[i], indices[i], logits.device)
                         for i in rows])
    idx = torch.tensor(rows, device=logits.device)
    out = greedy_tok.clone()
    out[idx] = torch.argmax(scaled[idx] + noise, dim=-1)
    return torch.where(temperature > 0, out, greedy_tok).to(torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
