"""Backend operator: token stream → text stream with stop handling.

Port of `dynamo_tpu/llm/backend.py`: incremental
detokenization via DecodeStream plus the stop-sequence "jail" — text that
could be the prefix of a stop string is held back until it either completes
the stop (finish, truncate) or diverges (release).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer


@dataclass
class TextDelta:
    text: str = ""
    finished: bool = False
    finish_reason: Optional[str] = None  # OpenAI wire name: stop/length/...


_WIRE_REASON = {
    FinishReason.STOP: "stop",
    FinishReason.LENGTH: "length",
    FinishReason.CANCELLED: "cancelled",
    FinishReason.ERROR: "error",
}


def wire_finish_reason(reason: Optional[FinishReason]) -> Optional[str]:
    return _WIRE_REASON.get(reason) if reason else None


class StreamDetokenizer:
    """Per-request text assembly: detokenize + stop-sequence jail."""

    def __init__(self, tokenizer: Tokenizer,
                 stop_sequences: Sequence[str] = ()) -> None:
        self._decode = DecodeStream(tokenizer)
        self._stops = [s for s in stop_sequences if s]
        self._jail = ""          # text withheld pending stop-match decision
        self._stopped = False
        self.completion_tokens = 0

    def _max_stop_len(self) -> int:
        return max((len(s) for s in self._stops), default=0)

    def push_tokens(self, token_ids: Sequence[int]) -> TextDelta:
        """Feed engine tokens, get releasable text (stop-aware)."""
        if self._stopped:
            return TextDelta()
        text = ""
        for t in token_ids:
            self.completion_tokens += 1
            text += self._decode.push(t)
        if not self._stops:
            return TextDelta(text=text)

        window = self._jail + text
        # Stop hit: truncate at the earliest match (OpenAI semantics: the
        # stop string itself is not returned).
        earliest = None
        for s in self._stops:
            idx = window.find(s)
            if idx != -1 and (earliest is None or idx < earliest):
                earliest = idx
        if earliest is not None:
            self._stopped = True
            self._jail = ""
            return TextDelta(text=window[:earliest], finished=True,
                             finish_reason="stop")

        # No full match: release everything except a tail that could still
        # grow into a stop string.
        hold = 0
        for k in range(min(self._max_stop_len() - 1, len(window)), 0, -1):
            tail = window[-k:]
            if any(s.startswith(tail) for s in self._stops):
                hold = k
                break
        self._jail = window[len(window) - hold:] if hold else ""
        release = window[: len(window) - hold] if hold else window
        return TextDelta(text=release)

    def finish(self, reason: Optional[FinishReason]) -> TextDelta:
        """End of engine stream: flush decoder + jail (no stop matched)."""
        if self._stopped:
            return TextDelta(finished=True, finish_reason="stop")
        text = self._jail + self._decode.flush()
        self._jail = ""
        # A stop token (EOS) finishing the stream is an OpenAI "stop".
        return TextDelta(text=text, finished=True,
                         finish_reason=wire_finish_reason(reason) or "stop")

    @property
    def stopped(self) -> bool:
        return self._stopped
