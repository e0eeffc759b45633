"""A `tokenizer.json` interpreter on the standard library.

The JAX package's `HFTokenizer` wraps HuggingFace `tokenizers`; the port
serves without that package, so this module reads the same file and runs
the same pipeline, token for token, for the BPE families the port serves:

- byte-level BPE (GPT-2, Qwen, Llama-3): a `Split` regex and/or the
  `ByteLevel` pre-tokenizer, `ignore_merges`, the `ByteLevel` decoder;
- SentencePiece-style BPE (Llama-2, Mistral / Mixtral, Gemma): the
  `Metaspace` pre-tokenizer or the `Prepend` / `Replace` normalizers,
  `byte_fallback` `<0xNN>` tokens, and the `Replace` / `ByteFallback` /
  `Fuse` / `Strip` / `Metaspace` decoders.

Encoding is `encode(text, add_special_tokens=False)`: added tokens split
the text first (leftmost-longest, with their `lstrip` / `rstrip` /
`single_word` flags), each other section is normalized, pre-tokenized and
merged by BPE rank.  The post-processor adds nothing without special
tokens, so it is not run.

Pre-tokenizer patterns are Oniguruma regexes with `\\p{L}`, `\\p{N}` and
Unicode `\\s`, which Python's `re` lacks: `onig_to_re` rewrites each such
class into an explicit `re` character class built from `unicodedata`
general categories (and the Unicode White_Space set for `\\s`), so the
backtracking semantics stay those of one regex engine over the same
alternation.

A component the interpreter does not implement raises
`UnsupportedTokenizer` naming it: there is no silent fallback.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json component this interpreter does not implement."""


# ---------------------------------------------------------------------------
# Oniguruma classes as `re` character classes

# Unicode White_Space (Oniguruma's `\s` and Rust's char::is_whitespace);
# Python's `\s` differs (it also takes U+001C..U+001F).
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


@functools.lru_cache(maxsize=1)
def _category_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """General category (two letters) -> sorted code point ranges."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    cur, start = None, 0
    for cp in range(0x110000):
        cat = unicodedata.category(chr(cp))
        if cat != cur:
            if cur is not None:
                out.setdefault(cur, []).append((start, cp - 1))
            cur, start = cat, cp
    out.setdefault(cur, []).append((start, 0x10FFFF))
    return out


def _ranges_for(prop: str) -> List[Tuple[int, int]]:
    cats = _category_ranges()
    if len(prop) == 1:
        picked = [r for c, rs in cats.items() if c[0] == prop for r in rs]
    elif prop in cats:
        picked = list(cats[prop])
    else:
        raise UnsupportedTokenizer(f"regex property \\p{{{prop}}}")
    if not picked:
        raise UnsupportedTokenizer(f"regex property \\p{{{prop}}}")
    return sorted(picked)


def _cp(c: int) -> str:
    return f"\\u{c:04x}" if c <= 0xFFFF else f"\\U{c:08x}"


def _class_body(ranges) -> str:
    return "".join(_cp(lo) if lo == hi else f"{_cp(lo)}-{_cp(hi)}"
                   for lo, hi in ranges)


def onig_to_re(pattern: str) -> str:
    """Rewrite an Oniguruma pattern's Unicode classes (`\\p{..}`,
    `\\P{..}`, `\\s`, `\\S`) as explicit `re` classes; everything else
    passes through."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if i + 2 >= n or pattern[i + 2] != "{":
                    raise UnsupportedTokenizer(f"regex escape \\{e} without "
                                               "braces")
                end = pattern.index("}", i + 3)
                prop = pattern[i + 3:end]
                negated = e == "P"
                if prop.startswith("^"):
                    prop, negated = prop[1:], not negated
                body = _class_body(_ranges_for(prop))
                i = end + 1
            elif e in "sS":
                body, negated = _class_body(_WHITE_SPACE), e == "S"
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if negated:
                    raise UnsupportedTokenizer(
                        "a negated Unicode class inside [...]")
                out.append(body)
            else:
                out.append(("[^" if negated else "[") + body + "]")
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            # A leading ^ or ] belongs to the class syntax.
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "[" and in_class:
            raise UnsupportedTokenizer("nested character classes")
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=64)
def _compile(pattern: str):
    return re.compile(onig_to_re(pattern))


# ---------------------------------------------------------------------------
# Splitting (tokenizers' SplitDelimiterBehavior)

Piece = Tuple[str, bool]       # (text, starts at the input's offset 0)


def _find_matches(text: str, pattern) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) spans covering `text`, as tokenizers'
    Pattern::find_matches: a str pattern matches literally, a compiled
    one by regex."""
    if not text:
        return [(0, 0, False)]
    spans: List[Tuple[int, int, bool]] = []
    prev = 0
    if isinstance(pattern, str):
        it = ((m, m + len(pattern)) for m in _literal_iter(text, pattern))
    else:
        it = ((m.start(), m.end()) for m in pattern.finditer(text))
    for s, e in it:
        if s == e:
            continue
        if prev != s:
            spans.append((prev, s, False))
        spans.append((s, e, True))
        prev = e
    if prev != len(text):
        spans.append((prev, len(text), False))
    return spans


def _literal_iter(text: str, lit: str):
    if not lit:
        return
    i = text.find(lit)
    while i >= 0:
        yield i
        i = text.find(lit, i + len(lit))


def split_pieces(text: str, pattern, behavior: str,
                 invert: bool = False) -> List[Tuple[int, int]]:
    """tokenizers' NormalizedString::split: the (start, end) pieces of
    `text` under one delimiter behavior, empty pieces dropped."""
    spans = _find_matches(text, pattern)
    if invert:
        spans = [(s, e, not m) for s, e, m in spans]
    b = behavior.lower()
    out: List[List] = []
    if b == "removed":
        out = [[s, e] for s, e, m in spans if not m]
    elif b == "isolated":
        out = [[s, e] for s, e, _ in spans]
    elif b in ("mergedwithprevious", "merged_with_previous"):
        prev_match = False
        for s, e, m in spans:
            if m and not prev_match and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_match = m
    elif b in ("mergedwithnext", "merged_with_next"):
        prev_match = False
        for s, e, m in reversed(spans):
            if m and not prev_match and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev_match = m
        out.reverse()
    else:
        raise UnsupportedTokenizer(f"split behavior {behavior!r}")
    return [(s, e) for s, e in out if s != e]


def _split_piece(piece: Piece, pattern, behavior: str,
                 invert: bool = False) -> List[Piece]:
    text, origin = piece
    return [(text[s:e], origin and s == 0)
            for s, e in split_pieces(text, pattern, behavior, invert)]


def _pattern_of(spec: dict):
    pat = spec.get("pattern") or {}
    if "String" in pat:
        return pat["String"]
    if "Regex" in pat:
        return _compile(pat["Regex"])
    raise UnsupportedTokenizer(f"pattern {pat!r}")


# ---------------------------------------------------------------------------
# Byte-level alphabet (GPT-2's bytes_to_unicode)


@functools.lru_cache(maxsize=1)
def byte_alphabet() -> Tuple[Dict[int, str], Dict[str, int]]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    enc = {b: chr(c) for b, c in zip(bs, cs)}
    return enc, {v: k for k, v in enc.items()}


# GPT-2's pattern: tokenizers' ByteLevel pre-tokenizer with use_regex.
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


# ---------------------------------------------------------------------------
# Pipeline components


def _normalize(spec: Optional[dict], text: str) -> str:
    if spec is None:
        return text
    kind = spec.get("type")
    if kind == "Sequence":
        for sub in spec.get("normalizers", []):
            text = _normalize(sub, text)
        return text
    if kind == "Prepend":
        return spec["prepend"] + text if text else text
    if kind == "Replace":
        pat = _pattern_of(spec)
        if isinstance(pat, str):
            return text.replace(pat, spec["content"])
        return pat.sub(lambda _m: spec["content"], text)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return unicodedata.normalize(kind, text)
    raise UnsupportedTokenizer(f"normalizer {kind!r}")


def _metaspace_scheme(spec: dict) -> str:
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    return scheme


def _pre_tokenize(spec: Optional[dict], pieces: List[Piece]) -> List[Piece]:
    if spec is None:
        return pieces
    kind = spec.get("type")
    if kind == "Sequence":
        for sub in spec.get("pretokenizers", []):
            pieces = _pre_tokenize(sub, pieces)
        return pieces
    if kind == "Split":
        pat = _pattern_of(spec)
        return [q for p in pieces for q in _split_piece(
            p, pat, spec.get("behavior", "Isolated"),
            bool(spec.get("invert", False)))]
    if kind == "ByteLevel":
        enc, _ = byte_alphabet()
        out: List[Piece] = []
        regex = _compile(GPT2_PATTERN) if spec.get("use_regex", True) else None
        for text, origin in pieces:
            if spec.get("add_prefix_space", True) and not text.startswith(" "):
                text = " " + text
            subs = ([(text, origin)] if regex is None
                    else _split_piece((text, origin), regex, "Isolated"))
            out.extend(("".join(enc[b] for b in s.encode("utf-8")), o)
                       for s, o in subs)
        return out
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = _metaspace_scheme(spec)
        out = []
        for text, origin in pieces:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and origin)):
                text = rep + text
            if spec.get("split", True):
                out.extend(_split_piece((text, origin), rep,
                                        "MergedWithNext"))
            else:
                out.append((text, origin))
        return out
    raise UnsupportedTokenizer(f"pre_tokenizer {kind!r}")


class _Bpe:
    """tokenizers' BPE model (no dropout)."""

    def __init__(self, spec: dict) -> None:
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise UnsupportedTokenizer(f"BPE {key}")
        if spec.get("dropout"):
            raise UnsupportedTokenizer("BPE dropout")
        self.vocab: Dict[str, int] = dict(spec.get("vocab") or {})
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            ia, ib = self.vocab.get(a), self.vocab.get(b)
            new = self.vocab.get(a + b)
            if ia is None or ib is None or new is None:
                raise UnsupportedTokenizer(
                    f"BPE merge {a!r} {b!r} outside the vocabulary")
            self.merges[(ia, ib)] = (rank, new)
        self._cache: Dict[str, List[int]] = {}

    def _word(self, w: str) -> List[int]:
        ids: List[int] = []
        unk: Optional[List[int]] = None         # [id, pending]
        for ch in w:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk[0])
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>")
                            for b in ch.encode("utf-8")]
                if all(t is not None for t in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise UnsupportedTokenizer(
                        f"unk_token {self.unk_token!r} outside the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk[0])
                if unk is None or not self.fuse_unk:
                    unk = [unk_id]
        if unk is not None:
            ids.append(unk[0])
        return self._merge(ids)

    def _merge(self, sym: List[int]) -> List[int]:
        n = len(sym)
        if n < 2:
            return sym
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue
            sym[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = merges.get((sym[prev[pos]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def tokenize(self, w: str) -> List[int]:
        if not w:
            return []
        if self.ignore_merges:
            tid = self.vocab.get(w)
            if tid is not None:
                return [tid]
        hit = self._cache.get(w)
        if hit is None:
            hit = self._word(w)
            if len(self._cache) < 65536:
                self._cache[w] = hit
        return list(hit)


def _decode_chain(spec: Optional[dict], tokens: List[str]) -> List[str]:
    if spec is None:
        return [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        for sub in spec.get("decoders", []):
            tokens = _decode_chain(sub, tokens)
        return tokens
    if kind == "ByteLevel":
        _, dec = byte_alphabet()
        data = bytearray()
        for t in tokens:
            if all(c in dec for c in t):
                data.extend(dec[c] for c in t)
            else:
                data.extend(t.encode("utf-8"))
        return [bytes(data).decode("utf-8", errors="replace")]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        strip_first = _metaspace_scheme(spec) != "never"
        return ["".join(("" if (i == 0 and strip_first) else " ")
                        if c == rep else c for c in t)
                for i, t in enumerate(tokens)]
    if kind == "Replace":
        pat = _pattern_of(spec)
        content = spec["content"]
        if isinstance(pat, str):
            return [t.replace(pat, content) for t in tokens]
        return [pat.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        out: List[str] = []
        pending = bytearray()

        def flush():
            if pending:
                try:
                    out.append(bytes(pending).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()

        for t in tokens:
            byte = None
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    byte = int(t[3:5], 16)
                except ValueError:
                    byte = None
            if byte is not None:
                pending.append(byte)
            else:
                flush()
                out.append(t)
        flush()
        return out
    if kind == "Fuse":
        return ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]
        out = []
        for t in tokens:
            lo = 0
            for i in range(min(start, len(t))):
                if t[i] != content:
                    break
                lo = i + 1
            hi = len(t)
            for i in range(min(stop, len(t))):
                idx = len(t) - i - 1
                if t[idx] != content:
                    break
                hi = idx
            out.append(t[lo:hi] if lo <= hi else "")
        return out
    raise UnsupportedTokenizer(f"decoder {kind!r}")


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


class _AddedToken:
    __slots__ = ("id", "content", "special", "lstrip", "rstrip",
                 "single_word", "normalized")

    def __init__(self, d: dict, tid: int) -> None:
        self.id = tid
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))
        self.normalized = bool(d.get("normalized", not self.special))


class _Matcher:
    """Leftmost-longest matching of added-token strings."""

    def __init__(self, entries: List[Tuple[str, _AddedToken]]) -> None:
        self._by_first: Dict[str, List[Tuple[str, _AddedToken]]] = {}
        for s, tok in entries:
            if s:
                self._by_first.setdefault(s[0], []).append((s, tok))
        for lst in self._by_first.values():
            lst.sort(key=lambda e: -len(e[0]))

    def __bool__(self) -> bool:
        return bool(self._by_first)

    def find(self, text: str):
        i, n = 0, len(text)
        while i < n:
            for s, tok in self._by_first.get(text[i], ()):
                if text.startswith(s, i):
                    yield i, i + len(s), tok
                    i += len(s)
                    break
            else:
                i += 1


class TokenizerJson:
    """One tokenizer.json, encode and decode as `tokenizers` does."""

    def __init__(self, spec: dict) -> None:
        model = spec.get("model") or {}
        mtype = model.get("type", "BPE" if "merges" in model else None)
        if mtype != "BPE":
            raise UnsupportedTokenizer(f"model {mtype!r}")
        self.model = _Bpe(model)
        self.normalizer = spec.get("normalizer")
        self.pre_tokenizer = spec.get("pre_tokenizer")
        self.decoder = spec.get("decoder")
        # Components are checked once at load, on an empty input.
        _normalize(self.normalizer, "")
        _pre_tokenize(self.pre_tokenizer, [])
        _decode_chain(self.decoder, [])
        self.added = self._number_added(spec.get("added_tokens") or [])
        self._added_by_id = {t.id: t for t in self.added}
        self._added_by_content = {t.content: t for t in self.added}
        self._special = {t.content for t in self.added if t.special}
        self._raw = _Matcher([(t.content, t) for t in self.added
                              if not t.normalized])
        self._norm = _Matcher([(_normalize(self.normalizer, t.content), t)
                               for t in self.added if t.normalized])
        self._id_to_token = {i: s for s, i in self.model.vocab.items()}

    def _number_added(self, entries: List[dict]) -> List[_AddedToken]:
        """Added tokens with the ids `tokenizers` gives them on load: a
        content in the model's vocabulary keeps that id, a new one takes
        the next id after the vocabulary (or after the largest added id
        already past it); the file's own "id" fields are not read."""
        vocab = self.model.vocab
        size = len(vocab)
        out: List[_AddedToken] = []
        ids: Dict[str, int] = {}
        for d in entries:
            content = d["content"]
            tid = ids.get(content, vocab.get(content))
            if tid is None:
                top = max(ids.values(), default=None)
                tid = (size if top is None else
                       top + 1 if top >= size or size == 0 else size)
            ids[content] = tid
            out.append(_AddedToken(d, tid))
        return out

    @classmethod
    def from_str(cls, text: str) -> "TokenizerJson":
        return cls(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- vocabulary --------------------------------------------------------

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added_by_content.get(token)
        if t is not None:
            return t.id
        return self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        t = self._added_by_id.get(tid)
        if t is not None:
            return t.content
        return self._id_to_token.get(tid)

    def get_vocab_size(self) -> int:
        vocab = dict(self.model.vocab)
        vocab.update({t.content: t.id for t in self.added})
        return len(vocab)

    # -- encode ------------------------------------------------------------

    def _split_added(self, text: str, matcher: _Matcher
                     ) -> List[Tuple[int, int, Optional[_AddedToken]]]:
        """tokenizers' AddedVocabulary::find_matches on one section."""
        if not matcher:
            return [(0, len(text), None)]
        out: List[Tuple[int, int, Optional[_AddedToken]]] = []
        start_offset = 0
        for s, e, tok in matcher.find(text):
            if tok.single_word:
                left_ok = s == 0 or not _is_word_char(text[s - 1])
                right_ok = e == len(text) or not _is_word_char(text[e])
                if not (left_ok and right_ok):
                    continue
            if tok.lstrip:
                j = s
                while j > 0 and text[j - 1].isspace():
                    j -= 1
                s = max(j, start_offset)
            if tok.rstrip:
                while e < len(text) and text[e].isspace():
                    e += 1
            if start_offset < s:
                out.append((start_offset, s, None))
            out.append((s, e, tok))
            start_offset = e
        if start_offset != len(text):
            out.append((start_offset, len(text), None))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of `text`, no special tokens added."""
        # (text or added token, starts at the input's offset 0)
        sections: List[Tuple[object, bool]] = []
        for s, e, tok in self._split_added(text, self._raw):
            sections.append((tok if tok is not None else text[s:e], s == 0))
        ids: List[int] = []
        for item, origin in sections:
            if isinstance(item, _AddedToken):
                ids.append(item.id)
                continue
            if not item:
                continue
            norm = _normalize(self.normalizer, item)
            for s, e, tok in self._split_added(norm, self._norm):
                if tok is not None:
                    ids.append(tok.id)
                    continue
                piece = norm[s:e]
                if not piece:
                    continue
                for word, _ in _pre_tokenize(self.pre_tokenizer,
                                             [(piece, origin and s == 0)]):
                    ids.extend(self.model.tokenize(word))
        return ids

    # -- decode ------------------------------------------------------------

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        tokens: List[str] = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None:
                continue
            if skip_special_tokens and tok in self._special:
                continue
            tokens.append(tok)
        return "".join(_decode_chain(self.decoder, tokens))
