"""Token blocks and chained block hashing (copy of `dynamo_tpu/tokens.py`,
with its own xxh3_64).

Fixed-size token blocks whose identity is a chained hash: each block's
hash commits to the whole prefix up to and including the block, so two
sequences share a block hash iff they share the entire prefix.  These
hashes key the prefix cache (llm/block_manager).

Hash function: xxh3_64 (seed 0) over (parent_hash_le64 || tokens_le_u32...),
with a fixed salt as the root's parent.  `xxh3_64` below is a plain
Python transcription of XXH3's 64-bit variant with its default secret, so
the port needs no `xxhash` package and hashes to the same values as the
JAX package: every length class a block or salt can take (9-16, 17-128,
129-240 bytes and the striped path beyond, scrambles included) follows
the reference code.  Inputs under 9 bytes are never hashed here and
raise.  The JAX package's native C++ chain is not ported; the Python
loop costs microseconds per 64-token block.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Salt used as the "parent hash" of the first block of a sequence.
ROOT_PARENT_HASH = 0xD1A0_0000_0000_0001

TokenId = int

# ---------------------------------------------------------------------------
# xxh3_64, seed 0 (XXH3_64bits of xxHash 0.8)

_M64 = (1 << 64) - 1
_P32_1, _P32_2, _P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_P64_1, _P64_2, _P64_3 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9)
_P64_4, _P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_PRIME_MX1 = 0x165667919E3779F9
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_STRIPE = 64
_STRIPES_PER_BLOCK = (len(_SECRET) - _STRIPE) // 8     # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK                   # 1024 bytes


def _u64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off:off + 8], "little")


def _fold(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PRIME_MX1) & _M64
    return h ^ (h >> 32)


def _mix16(data: bytes, off: int, soff: int) -> int:
    return _fold(_u64(data, off) ^ _u64(_SECRET, soff),
                 _u64(data, off + 8) ^ _u64(_SECRET, soff + 8))


def _accumulate(acc: List[int], data: bytes, off: int, soff: int) -> None:
    """One 64-byte stripe into the eight lanes."""
    words = struct.unpack_from("<8Q", data, off)
    keys = struct.unpack_from("<8Q", _SECRET, soff)
    for i in range(8):
        dk = words[i] ^ keys[i]
        acc[i ^ 1] = (acc[i ^ 1] + words[i]) & _M64
        acc[i] = (acc[i] + (dk & 0xFFFFFFFF) * (dk >> 32)) & _M64


def _scramble(acc: List[int]) -> None:
    keys = struct.unpack_from("<8Q", _SECRET, len(_SECRET) - _STRIPE)
    for i in range(8):
        a = acc[i] ^ (acc[i] >> 47) ^ keys[i]
        acc[i] = (a * _P32_1) & _M64


def _hash_long(data: bytes) -> int:
    n = len(data)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    blocks = (n - 1) // _BLOCK
    for b in range(blocks):
        for s in range(_STRIPES_PER_BLOCK):
            _accumulate(acc, data, b * _BLOCK + s * _STRIPE, s * 8)
        _scramble(acc)
    tail = ((n - 1) - blocks * _BLOCK) // _STRIPE
    for s in range(tail):
        _accumulate(acc, data, blocks * _BLOCK + s * _STRIPE, s * 8)
    _accumulate(acc, data, n - _STRIPE, len(_SECRET) - _STRIPE - 7)
    h = (n * _P64_1) & _M64
    for i in range(4):
        h += _fold(acc[2 * i] ^ _u64(_SECRET, 11 + 16 * i),
                   acc[2 * i + 1] ^ _u64(_SECRET, 11 + 16 * i + 8))
    return _avalanche(h & _M64)


def xxh3_64(data: bytes) -> int:
    """XXH3 64-bit hash of `data` with seed 0, for len(data) >= 9 (the
    lengths this module hashes: a block is 8 + 4 * block_size bytes, a
    salt 8 + len(salt))."""
    n = len(data)
    if n < 9:
        raise ValueError(f"xxh3_64 here takes 9 or more bytes, got {n}")
    if n <= 16:
        lo = _u64(data, 0) ^ (_u64(_SECRET, 24) ^ _u64(_SECRET, 32))
        hi = _u64(data, n - 8) ^ (_u64(_SECRET, 40) ^ _u64(_SECRET, 48))
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _fold(lo, hi)) & _M64)
    if n <= 128:
        acc = n * _P64_1
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96) + _mix16(data, n - 64, 112)
                acc += _mix16(data, 32, 64) + _mix16(data, n - 48, 80)
            acc += _mix16(data, 16, 32) + _mix16(data, n - 32, 48)
        acc += _mix16(data, 0, 0) + _mix16(data, n - 16, 16)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = n * _P64_1
        for i in range(8):
            acc += _mix16(data, 16 * i, 16 * i)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            acc += _mix16(data, 16 * i, 16 * (i - 8) + 3)
        acc += _mix16(data, n - 16, 136 - 17)
        return _avalanche(acc & _M64)
    return _hash_long(data)


# ---------------------------------------------------------------------------
# Chained block hashes


def _as_u32(tokens) -> np.ndarray:
    """Coerce tokens to uint32, raising (never wrapping) on out-of-range
    or non-integral ids: a wrap would alias cache keys."""
    arr = np.asarray(tokens)
    if arr.dtype == np.uint32:
        return arr
    if not np.issubdtype(arr.dtype, np.integer):
        try:
            as_int = arr.astype(np.int64)
        except (ValueError, OverflowError, TypeError) as e:
            raise ValueError(f"token ids must be integers: {e}") from e
        if np.issubdtype(arr.dtype, np.floating) and not np.array_equal(as_int, arr):
            raise ValueError("token ids must be integers, got non-integral floats")
        arr = as_int
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
        raise ValueError(
            f"token ids must fit in uint32, got range [{arr.min()}, {arr.max()}]")
    return arr.astype(np.uint32)


def hash_block(parent_hash: int, tokens: Sequence[int]) -> int:
    """Chained sequence hash of one block given its parent's hash."""
    return xxh3_64(struct.pack("<Q", parent_hash & _M64)
                   + _as_u32(tokens).astype("<u4").tobytes())


def compute_block_hashes(tokens: Sequence[int], block_size: int,
                         parent_hash: int = ROOT_PARENT_HASH) -> List[int]:
    """Sequence hashes of every complete block of `tokens` (a trailing
    partial block is not hashed)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    arr = _as_u32(tokens)
    hashes: List[int] = []
    h = parent_hash
    for i in range(len(arr) // block_size):
        h = hash_block(h, arr[i * block_size:(i + 1) * block_size])
        hashes.append(h)
    return hashes


@dataclass(frozen=True)
class TokenBlock:
    """A complete, immutable block: its tokens, chained hash, parent's
    hash and index within its sequence."""

    tokens: Tuple[TokenId, ...]
    block_hash: int
    parent_hash: int
    position: int


class TokenBlockSequence:
    """The block decomposition and chained hashes of a growing token
    sequence: complete blocks freeze with their hash, the partial tail
    stays mutable."""

    def __init__(self, tokens: Optional[Iterable[TokenId]] = None,
                 block_size: int = 64):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.blocks: List[TokenBlock] = []
        self._partial: List[TokenId] = []
        if tokens is not None:
            self.extend(tokens)

    def append(self, token: TokenId) -> Optional[TokenBlock]:
        """Append one token; returns the newly completed block, if any."""
        token = int(token)
        if not 0 <= token <= 0xFFFFFFFF:
            raise ValueError(f"token id must fit in uint32, got {token}")
        self._partial.append(token)
        if len(self._partial) >= self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[TokenId]) -> List[TokenBlock]:
        """Append many tokens; returns every block this call completed."""
        toks: List[TokenId] = _as_u32(
            tokens if isinstance(tokens, (list, np.ndarray))
            else list(tokens)).tolist()
        new_blocks: List[TokenBlock] = []
        for t in toks:
            self._partial.append(t)
            if len(self._partial) >= self.block_size:
                new_blocks.append(self._seal())
        return new_blocks

    def _seal(self) -> TokenBlock:
        parent = self.last_hash()
        blk = TokenBlock(tokens=tuple(self._partial),
                         block_hash=hash_block(parent, self._partial),
                         parent_hash=parent, position=len(self.blocks))
        self.blocks.append(blk)
        self._partial = []
        return blk

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self._partial)

    @property
    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self.blocks]

    def last_hash(self) -> int:
        return self.blocks[-1].block_hash if self.blocks else ROOT_PARENT_HASH


@dataclass
class SaltedBlockHasher:
    """Hash-domain separation: a salt mixed into the root parent hash, so
    identical token streams in different domains (adapters, models) do
    not share cache identity."""

    salt: bytes = b""
    _root: int = field(init=False)

    def __post_init__(self) -> None:
        if self.salt:
            self._root = xxh3_64(struct.pack("<Q", ROOT_PARENT_HASH)
                                 + bytes(self.salt))
        else:
            self._root = ROOT_PARENT_HASH

    @property
    def root(self) -> int:
        return self._root

    def block_hashes(self, tokens: Sequence[int], block_size: int) -> List[int]:
        return compute_block_hashes(tokens, block_size, parent_hash=self._root)
