"""Tokenizer protocol + incremental detokenization (port of
`dynamo_tpu/llm/tokenizer.py`).

- `DecodeStream` — the incremental detokenizer the per-token loop needs:
  UTF-8 multi-byte sequences and merge boundaries mean tokens cannot be
  decoded one at a time and concatenated.
- `ByteTokenizer` — 1 byte = 1 token (+ specials), dependency-free.
- `HFTokenizer` — a local `tokenizer.json` (a path, or its contents as
  they ride the model card), run by `llm/tokenizer_json.py` on the
  standard library: equal to HuggingFace `tokenizers` token for token on
  the BPE pipelines the port serves, with JAX's EOS discovery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence

from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson


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


class HFTokenizer:
    """A local tokenizer.json, encoded without special tokens and decoded
    without them (JAX's `HFTokenizer` contract)."""

    def __init__(self, path: str, eos_token_ids: Optional[Sequence[int]] = None,
                 eos_token: Optional[str] = None):
        self._tok = TokenizerJson.from_file(path)
        self._init_eos(eos_token_ids, eos_token)

    @classmethod
    def from_json(cls, json_str: str,
                  eos_token_ids: Optional[Sequence[int]] = None,
                  eos_token: Optional[str] = None) -> "HFTokenizer":
        """From tokenizer.json CONTENTS: the artifact travels inside the
        model card, so a remote frontend never needs the worker's files."""
        self = cls.__new__(cls)
        self._tok = TokenizerJson.from_str(json_str)
        self._init_eos(eos_token_ids, eos_token)
        return self

    def _init_eos(self, eos_token_ids, eos_token) -> None:
        self._eos = tuple(eos_token_ids or ())
        candidates = ([eos_token] if eos_token else []) + [
            "</s>", "<|endoftext|>", "<|eot_id|>", "<|end_of_text|>"]
        if not self._eos:
            for name in candidates:
                tid = self._tok.token_to_id(name)
                if tid is not None:
                    self._eos += (tid,)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, token_ids: Sequence[int]) -> str:
        return self._tok.decode(token_ids, skip_special_tokens=True)

    @property
    def eos_token_ids(self) -> tuple:
        return self._eos

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()
