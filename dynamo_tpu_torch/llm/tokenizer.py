"""Tokenizer protocol + incremental detokenization (port of
`dynamo_tpu/llm/tokenizer.py`).

- `DecodeStream` — the incremental detokenizer the per-token loop needs:
  UTF-8 multi-byte sequences and merge boundaries mean tokens cannot be
  decoded one at a time and concatenated.
- `ByteTokenizer` — 1 byte = 1 token (+ specials), dependency-free.

The JAX package's `HFTokenizer` (HuggingFace `tokenizers`) is not ported:
the serving path runs on the standard library, numpy, torch and jinja2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Protocol, Sequence


class Tokenizer(Protocol):
    """What the preprocessor/backend need from any tokenizer."""

    def encode(self, text: str) -> List[int]: ...
    def decode(self, token_ids: Sequence[int]) -> str: ...
    @property
    def eos_token_ids(self) -> tuple: ...
    @property
    def vocab_size(self) -> int: ...


class DecodeStream:
    """Incremental detokenizer (reference `tokenizers.rs` DecodeStream).

    Holds back output while the byte sequence at the tail is an incomplete
    UTF-8 character or the tokenizer would merge differently: we decode the
    window of all unflushed tokens and emit only the stable prefix (text
    whose bytes can no longer change when more tokens arrive).
    """

    REPLACEMENT = "�"

    def __init__(self, tokenizer: "Tokenizer") -> None:
        self._tok = tokenizer
        self._pending: List[int] = []
        self._emitted = ""  # text already flushed for the pending window
        self._held = 0      # consecutive pushes held on a broken tail

    def _past_prefix(self, text: str) -> str:
        """Text beyond the already-emitted prefix.  When the tokenizer
        re-merged the window so the flushed prefix changed, we cannot
        retract flushed text; emit only the part past the longest
        common prefix (minimises duplication)."""
        if text.startswith(self._emitted):
            return text[len(self._emitted):]
        common = 0
        for a, b in zip(self._emitted, text):
            if a != b:
                break
            common += 1
        return text[common:]

    def push(self, token_id: int) -> str:
        """Feed one token; returns newly-stable text (possibly "")."""
        self._pending.append(token_id)
        text = self._tok.decode(self._pending)
        if text.endswith(self.REPLACEMENT):
            # Tail may be an incomplete multi-byte sequence — hold
            # everything after the already-emitted prefix.  But only
            # while it could still complete: a UTF-8 char spans at most
            # 4 bytes (4 byte-level tokens), so a tail still broken
            # after 4 consecutive held pushes is invalid bytes, not an
            # unfinished char.  An unconditional hold turned any
            # gibberish burst into a stalled stream and an EMPTY final
            # text (flush drops the held tail), which is how the
            # multimodal e2e test got a contentless 200.
            self._held += 1
            if self._held < 4:
                return ""
            # Emit everything before the NEWEST token as U+FFFD; the
            # newest token stays pending — it may be the first byte of
            # a legitimate char that follows the garbage run (emitting
            # it too would corrupt that char).
            last = self._pending[-1]
            out = self._past_prefix(self._tok.decode(self._pending[:-1]))
            self._pending = [last]
            self._emitted = ""
            self._held = 1
            return out
        self._held = 0
        if not text.startswith(self._emitted):
            # Tokenizer re-merged the window so the already-flushed
            # prefix changed (see _past_prefix).
            out = self._past_prefix(text)
            self._pending = []
            self._emitted = ""
            return out
        out = text[len(self._emitted):]
        # Window can be reset at a clean boundary to bound decode cost.
        if len(self._pending) >= 16:
            self._pending = []
            self._emitted = ""
        else:
            self._emitted = text
        return out

    def flush(self) -> str:
        """Emit whatever is still held back (end of stream).  A held
        INCOMPLETE tail (at most 3 tokens — longer broken tails already
        burst out of push()) is dropped: the char never finished."""
        text = self._tok.decode(self._pending)
        out = text[len(self._emitted):] if text.startswith(self._emitted) else text
        self._pending = []
        self._emitted = ""
        self._held = 0
        return out.replace(self.REPLACEMENT, "")


@dataclass
class ByteTokenizer:
    """Byte-level tokenizer: token = byte value; specials above 255.

    Deterministic, zero-dependency, exercises real UTF-8 boundary handling
    in DecodeStream (multi-byte chars span multiple tokens).
    """

    bos_id: int = 256
    eos_id: int = 257

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, token_ids: Sequence[int]) -> str:
        data = bytes(t for t in token_ids if 0 <= t <= 255)
        return data.decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> tuple:
        return (self.eos_id,)

    @property
    def vocab_size(self) -> int:
        return 258
