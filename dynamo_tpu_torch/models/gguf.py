"""GGUF checkpoint loading: parse, dequantize, the port's state (port of
`dynamo_tpu/models/gguf.py`).

The reader implements GGUF v2/v3:

    magic "GGUF" | version u32 | n_tensors u64 | n_kv u64
    metadata kv*: key (u64-len string), type u32, value
    tensor info*: name, n_dims u32, dims u64[n] (ne order: fastest
                  first), ggml_type u32, offset u64
    padding to `general.alignment` (default 32), then tensor data

Tensor types: F32, F16, Q8_0 (32-element blocks: an f16 scale, 32 int8)
and Q4_K / Q5_K / Q6_K (256-element superblocks with 6-bit sub-scales,
ggml's `dequantize_row_q{4,5,6}_K` bit layouts).  Other types raise with
JAX's message.

Two dequantizers with one contract: `_dequant` is JAX's numpy version on
the host, kept as the plain oracle (`GgufFile.tensor`); `dequant_torch`
does the same arithmetic with torch ops on whatever device holds the raw
block bytes.  `load_gguf` uploads each tensor's raw bytes to the device
and dequantizes there (`GgufFile.tensor_device`), so a quantized file
crosses the bus at its packed size and the host never holds a float32
copy of the model.

Weight conventions: GGML lists dims fastest first, so a linear layer is
stored `[n_out, n_in]` row-major and transposes into the state's `x @ W`.
`attn_q` / `attn_k` carry llama.cpp's interleaved-rope permutation;
`_unpermute` restores HF's half-rotation layout.  The tokenizer metadata
(`tokenizer.ggml.*`) comes back beside the state.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

State = Dict

GGUF_MAGIC = b"GGUF"

# ggml tensor types we materialise.
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q5_K = 13
GGML_Q6_K = 14
_TYPE_NAMES = {0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0",
               7: "Q5_1", 8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K",
               12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K"}
QK_K = 256  # K-quant superblock length
# bytes per block: (block_bytes, block_elems)
_BLOCK_GEOM = {
    GGML_Q8_0: (34, 32),
    GGML_Q4_K: (144, QK_K),   # d f16 + dmin f16 + 12 scale bytes + 128 qs
    GGML_Q5_K: (176, QK_K),   # ... + 32 qh bytes
    GGML_Q6_K: (210, QK_K),   # 128 ql + 64 qh + 16 scales + d f16
}

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, \
    _F64 = range(13)
_SCALAR_FMT = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d"}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == _BOOL:
        return bool(f.read(1)[0])
    if vtype == _STR:
        return _read_str(f)
    if vtype == _ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        if etype in _SCALAR_FMT:
            fmt = _SCALAR_FMT[etype]
            size = struct.calcsize(fmt)
            raw = f.read(size * n)
            return list(np.frombuffer(
                raw, dtype=np.dtype(fmt[1:]).newbyteorder("<")))
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


def _scale_min_k4(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte K-quant scale block into 8 six-bit (scale, min)
    pairs per superblock (ggml `get_scale_min_k4`): j<4 reads the low 6
    bits of bytes j / j+4; j>=4 combines the low nibble of byte j+4 with
    the top 2 bits of byte j-4 (scale) / j (min).

    scales: [n_blocks, 12] u8 → (sc, mn): [n_blocks, 8] f32."""
    q = scales.astype(np.uint16)
    sc = np.empty(q.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = (q[..., j] & 63).astype(np.float32)
        mn[..., j] = (q[..., j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[..., j] = ((q[..., j + 4] & 0x0F)
                      | ((q[..., j - 4] >> 6) << 4)).astype(np.float32)
        mn[..., j] = ((q[..., j + 4] >> 4)
                      | ((q[..., j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _dequant_q4_k(raw: bytes, n_blocks: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
         ("qs", "u1", (128,))]), count=n_blocks)
    d = rec["d"].astype(np.float32)[:, None]          # [B, 1]
    dmin = rec["dmin"].astype(np.float32)[:, None]
    sc, mn = _scale_min_k4(rec["scales"])             # [B, 8]
    # qs: 4 chunks of 32 bytes; each byte holds (low nibble → sub-block
    # 2c, high nibble → sub-block 2c+1).
    qs = rec["qs"].reshape(n_blocks, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)               # [B, 4, 32]
    hi = (qs >> 4).astype(np.float32)
    out = np.empty((n_blocks, 8, 32), np.float32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return ((d * sc)[:, :, None] * out
            - (dmin * mn)[:, :, None]).reshape(-1)


def _dequant_q5_k(raw: bytes, n_blocks: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
         ("qh", "u1", (32,)), ("qs", "u1", (128,))]), count=n_blocks)
    d = rec["d"].astype(np.float32)[:, None]
    dmin = rec["dmin"].astype(np.float32)[:, None]
    sc, mn = _scale_min_k4(rec["scales"])
    qs = rec["qs"].reshape(n_blocks, 4, 32)
    qh = rec["qh"]                                    # [B, 32]
    out = np.empty((n_blocks, 8, 32), np.float32)
    for j in range(4):
        u1, u2 = 1 << (2 * j), 2 << (2 * j)
        out[:, 2 * j] = ((qs[:, j] & 0x0F)
                         + np.where(qh & u1, 16, 0)).astype(np.float32)
        out[:, 2 * j + 1] = ((qs[:, j] >> 4)
                             + np.where(qh & u2, 16, 0)).astype(np.float32)
    return ((d * sc)[:, :, None] * out
            - (dmin * mn)[:, :, None]).reshape(-1)


def _dequant_q6_k(raw: bytes, n_blocks: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("ql", "u1", (128,)), ("qh", "u1", (64,)),
         ("scales", "i1", (16,)), ("d", "<f2")]), count=n_blocks)
    d = rec["d"].astype(np.float32)                   # [B]
    sc = rec["scales"].astype(np.float32)             # [B, 16]
    out = np.empty((n_blocks, 2, 4, 32), np.float32)  # halves x rows x l
    for h in range(2):                                # two 128-elem halves
        ql = rec["ql"][:, 64 * h:64 * (h + 1)]        # [B, 64]
        qh = rec["qh"][:, 32 * h:32 * (h + 1)]        # [B, 32]
        q1 = ((ql[:, :32] & 0x0F) | ((qh >> 0) & 3) << 4).astype(
            np.int8)
        q2 = ((ql[:, 32:] & 0x0F) | ((qh >> 2) & 3) << 4).astype(np.int8)
        q3 = ((ql[:, :32] >> 4) | ((qh >> 4) & 3) << 4).astype(np.int8)
        q4 = ((ql[:, 32:] >> 4) | ((qh >> 6) & 3) << 4).astype(np.int8)
        for r, q in enumerate((q1, q2, q3, q4)):
            # row r covers elements [128h + 32r, 128h + 32(r+1)); its
            # 16-elem groups use scales[8h + 2r + l//16].
            g0 = sc[:, 8 * h + 2 * r][:, None]
            g1 = sc[:, 8 * h + 2 * r + 1][:, None]
            scale = np.concatenate(
                [np.repeat(g0, 16, axis=1), np.repeat(g1, 16, axis=1)],
                axis=1)                               # [B, 32]
            out[:, h, r] = (q.astype(np.float32) - 32.0) * scale
    return (d[:, None, None, None] * out).reshape(-1)


def _dequant(raw: bytes, ggml_type: int, n_elems: int) -> np.ndarray:
    if ggml_type == GGML_F32:
        return np.frombuffer(raw, np.float32, count=n_elems).copy()
    if ggml_type == GGML_F16:
        return np.frombuffer(raw, np.float16,
                             count=n_elems).astype(np.float32)
    if ggml_type == GGML_Q8_0:
        # blocks of [f16 scale][32 x i8]; value = scale * q
        n_blocks = n_elems // 32
        rec = np.frombuffer(
            raw, dtype=np.dtype([("d", "<f2"), ("q", "i1", (32,))]),
            count=n_blocks)
        return (rec["d"].astype(np.float32)[:, None]
                * rec["q"].astype(np.float32)).reshape(n_elems)
    if ggml_type == GGML_Q4_K:
        return _dequant_q4_k(raw, n_elems // QK_K)
    if ggml_type == GGML_Q5_K:
        return _dequant_q5_k(raw, n_elems // QK_K)
    if ggml_type == GGML_Q6_K:
        return _dequant_q6_k(raw, n_elems // QK_K)
    raise ValueError(
        f"unsupported ggml tensor type "
        f"{_TYPE_NAMES.get(ggml_type, ggml_type)}; supported: F32, F16, "
        "Q8_0, Q4_K, Q5_K, Q6_K")


class GgufFile:
    """Parsed GGUF: metadata dict + lazy tensor loading."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, Tuple[List[int], int, int]] = {}
        self._map: Optional[mmap.mmap] = None
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            (version,) = struct.unpack("<I", f.read(4))
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF v{version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            infos = []
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = list(struct.unpack(f"<{n_dims}Q",
                                          f.read(8 * n_dims)))
                ggml_type, offset = struct.unpack("<IQ", f.read(12))
                infos.append((name, dims, ggml_type, offset))
            align = int(self.metadata.get("general.alignment", 32))
            base = f.tell()
            base += (-base) % align
            self._data_base = base
            for name, dims, ggml_type, offset in infos:
                self.tensors[name] = (dims, ggml_type, base + offset)

    def tensor(self, name: str) -> np.ndarray:
        """Dequantised tensor as f32, numpy shape [ne_last, ..., ne0]
        (row-major view of GGML's fastest-first dims)."""
        dims, ggml_type, pos, n, nbytes = self._geometry(name)
        with open(self.path, "rb") as f:
            f.seek(pos)
            raw = f.read(nbytes)
        return _dequant(raw, ggml_type, n).reshape(list(reversed(dims)))

    def _geometry(self, name: str):
        """(dims, ggml type, file offset, elements, bytes) of a tensor."""
        if name not in self.tensors:
            raise KeyError(f"tensor {name!r} not in {self.path} "
                           f"(have e.g. {sorted(self.tensors)[:5]})")
        dims, ggml_type, pos = self.tensors[name]
        n = 1
        for d in dims:
            n *= d
        if ggml_type == GGML_F32:
            nbytes = 4 * n
        elif ggml_type == GGML_F16:
            nbytes = 2 * n
        elif ggml_type in _BLOCK_GEOM:
            block_bytes, block_elems = _BLOCK_GEOM[ggml_type]
            nbytes = (n // block_elems) * block_bytes
        else:
            raise ValueError(
                f"unsupported ggml tensor type "
                f"{_TYPE_NAMES.get(ggml_type, ggml_type)}")
        return dims, ggml_type, pos, n, nbytes

    def raw_device(self, name: str, device) -> Tuple[torch.Tensor, int, list]:
        """(the tensor's raw bytes as uint8 on `device`, ggml type, dims)."""
        dims, ggml_type, pos, _n, nbytes = self._geometry(name)
        if self._map is None:
            with open(self.path, "rb") as f:
                # Copy-on-write pages: writable for torch.frombuffer.
                self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=nbytes,
                               offset=pos)
        return raw.to(device), ggml_type, dims

    def tensor_device(self, name: str, device) -> torch.Tensor:
        """The dequantized tensor as float32 on `device`, dequantized
        there (`dequant_torch`); numpy shape convention as `tensor`."""
        raw, ggml_type, dims = self.raw_device(name, device)
        n = 1
        for d in dims:
            n *= d
        return dequant_torch(raw, ggml_type, n).reshape(
            list(reversed(dims)))

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None

    # -- tokenizer extraction (gguf_metadata.rs parity) --------------------

    def tokenizer(self) -> Optional[dict]:
        """The embedded tokenizer, or None: model kind, vocab (tokens +
        scores + types) and special token ids."""
        tokens = self.metadata.get("tokenizer.ggml.tokens")
        if tokens is None:
            return None
        out = {
            "model": self.metadata.get("tokenizer.ggml.model", "llama"),
            "tokens": list(tokens),
            "scores": list(self.metadata.get("tokenizer.ggml.scores", [])),
            "token_types": list(
                self.metadata.get("tokenizer.ggml.token_type", [])),
        }
        for k in ("bos", "eos", "unknown", "padding"):
            v = self.metadata.get(f"tokenizer.ggml.{k}_token_id")
            if v is not None:
                out[f"{k}_token_id"] = int(v)
        return out



# ---------------------------------------------------------------------------
# Dequantization with torch ops (on the device holding the raw bytes)


def _f16(col: torch.Tensor) -> torch.Tensor:
    """[B, 2] uint8 -> [B] float32 (little-endian f16)."""
    return col.contiguous().view(torch.float16).reshape(-1).float()


def _scale_min_k4_torch(scales: torch.Tensor):
    """`_scale_min_k4` on a [B, 12] uint8 tensor -> ([B, 8], [B, 8]) f32."""
    q = scales.to(torch.int32)
    lo_sc = q[:, 0:4] & 63
    lo_mn = q[:, 4:8] & 63
    hi_sc = (q[:, 8:12] & 0x0F) | ((q[:, 0:4] >> 6) << 4)
    hi_mn = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return (torch.cat([lo_sc, hi_sc], 1).float(),
            torch.cat([lo_mn, hi_mn], 1).float())


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[B, 4, 32] uint8 -> [B, 8, 32] int32: sub-block 2c the low nibbles
    of chunk c, 2c+1 the high ones."""
    q = qs.to(torch.int32)
    return torch.stack([q & 0x0F, q >> 4], 2).reshape(q.shape[0], 8, 32)


def dequant_torch(raw: torch.Tensor, ggml_type: int,
                  n_elems: int) -> torch.Tensor:
    """`_dequant`'s arithmetic with torch ops: `raw` (uint8, any device)
    -> [n_elems] float32 on the same device."""
    if ggml_type == GGML_F32:
        return raw.view(torch.float32)[:n_elems].clone()
    if ggml_type == GGML_F16:
        return raw.view(torch.float16)[:n_elems].float()
    if ggml_type in _BLOCK_GEOM:
        block_bytes, block_elems = _BLOCK_GEOM[ggml_type]
        rec = raw[:(n_elems // block_elems) * block_bytes].reshape(
            -1, block_bytes)
    if ggml_type == GGML_Q8_0:
        d = _f16(rec[:, 0:2])
        q = rec[:, 2:].contiguous().view(torch.int8).float()
        return (d[:, None] * q).reshape(n_elems)
    if ggml_type in (GGML_Q4_K, GGML_Q5_K):
        B = rec.shape[0]
        d = _f16(rec[:, 0:2])[:, None]
        dmin = _f16(rec[:, 2:4])[:, None]
        sc, mn = _scale_min_k4_torch(rec[:, 4:16])
        if ggml_type == GGML_Q4_K:
            q = _nibbles(rec[:, 16:144].reshape(B, 4, 32))
        else:
            q = _nibbles(rec[:, 48:176].reshape(B, 4, 32))
            qh = rec[:, 16:48].to(torch.int32)                # [B, 32]
            bits = torch.stack([(qh >> j) & 1 for j in range(8)], 1)
            q = q + 16 * bits                                 # [B, 8, 32]
        return ((d * sc)[:, :, None] * q.float()
                - (dmin * mn)[:, :, None]).reshape(-1)
    if ggml_type == GGML_Q6_K:
        B = rec.shape[0]
        ql = rec[:, 0:128].to(torch.int32)
        qh = rec[:, 128:192].to(torch.int32)
        sc = rec[:, 192:208].contiguous().view(torch.int8).float()
        d = _f16(rec[:, 208:210])
        halves = []
        for h in range(2):
            l = ql[:, 64 * h:64 * (h + 1)]
            hh = qh[:, 32 * h:32 * (h + 1)]
            rows = [(l[:, :32] & 0x0F) | (((hh >> 0) & 3) << 4),
                    (l[:, 32:] & 0x0F) | (((hh >> 2) & 3) << 4),
                    (l[:, :32] >> 4) | (((hh >> 4) & 3) << 4),
                    (l[:, 32:] >> 4) | (((hh >> 6) & 3) << 4)]
            q = torch.stack(rows, 1).float() - 32.0           # [B, 4, 32]
            # Row r's 16-element groups use scales[8h + 2r + l // 16].
            s = sc[:, 8 * h:8 * (h + 1)].reshape(B, 4, 2)
            s = s.repeat_interleave(16, dim=2)                 # [B, 4, 32]
            halves.append(q * s)
        out = torch.stack(halves, 1)                          # [B, 2, 4, 32]
        return (d[:, None, None, None] * out).reshape(-1)
    raise ValueError(
        f"unsupported ggml tensor type "
        f"{_TYPE_NAMES.get(ggml_type, ggml_type)}; supported: F32, F16, "
        "Q8_0, Q4_K, Q5_K, Q6_K")


def _unpermute(w, n_head: int):
    """Invert llama.cpp's rope permutation on an [out, in] q/k weight
    (numpy array or tensor): the converter reshapes [n_head, 2,
    out/head/2, in] and swaps axes 1 and 2; the inverse swaps from the
    permuted grouping [n_head, out/head/2, 2, in]."""
    out, in_ = w.shape
    w = w.reshape(n_head, out // n_head // 2, 2, in_)
    w = w.swapaxes(1, 2) if isinstance(w, np.ndarray) else w.transpose(1, 2)
    return w.reshape(out, in_)


def config_from_gguf(g: GgufFile, name: str = "") -> ModelConfig:
    md = g.metadata
    arch = md.get("general.architecture", "llama")

    def key(suffix, default=None):
        return md.get(f"{arch}.{suffix}", default)

    n_heads = int(key("attention.head_count"))
    emb = int(key("embedding_length"))
    head_dim = int(key("attention.key_length", emb // n_heads))
    vocab = md.get("tokenizer.ggml.tokens")
    vocab_size = int(key("vocab_size", len(vocab) if vocab else 0))
    return ModelConfig(
        name=name or md.get("general.name", "gguf-model"),
        vocab_size=vocab_size,
        hidden_size=emb,
        num_layers=int(key("block_count")),
        num_heads=n_heads,
        num_kv_heads=int(key("attention.head_count_kv", n_heads)),
        head_dim=head_dim,
        intermediate_size=int(key("feed_forward_length")),
        max_context=int(key("context_length", 8192)),
        rope_theta=float(key("rope.freq_base", 10_000.0)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        tie_embeddings="output.weight" not in g.tensors,
    )


GGUF_LINEAR = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
               "ffn_up", "ffn_down")


def load_gguf(path: str, device: Union[str, torch.device, None] = None,
              dtype: Optional[torch.dtype] = None,
              num_layers: Optional[int] = None
              ) -> Tuple[ModelConfig, State, Optional[dict]]:
    """A GGUF file as (config, state on `device`, tokenizer dict or None),
    each tensor dequantized on the device.  `num_layers` keeps the first
    N decoder layers."""
    device = resolve_device(device)
    g = GgufFile(path)
    cfg = config_from_gguf(g)
    if num_layers is not None:
        if not 1 <= num_layers <= cfg.num_layers:
            raise ValueError(f"--num-layers {num_layers} outside "
                             f"1..{cfg.num_layers} for {cfg.name}")
        cfg = cfg.replace(num_layers=num_layers)
    cfg.validate()
    dtype = dtype or cfg.dtype

    def lin(name: str, unpermute_heads: int = 0) -> torch.Tensor:
        w = g.tensor_device(name, device)                 # [out, in]
        if unpermute_heads:
            w = _unpermute(w, unpermute_heads)
        return w.t().to(dtype).contiguous()               # [in, out]

    def vec(name: str) -> torch.Tensor:
        return g.tensor_device(name, device).to(dtype)

    try:
        layers = []
        for i in range(cfg.num_layers):
            p = f"blk.{i}."
            layers.append({
                "attn": {
                    "wq": lin(p + "attn_q.weight", cfg.num_heads),
                    "wk": lin(p + "attn_k.weight", cfg.num_kv_heads),
                    "wv": lin(p + "attn_v.weight"),
                    "wo": lin(p + "attn_output.weight"),
                },
                "attn_norm": vec(p + "attn_norm.weight"),
                "mlp_norm": vec(p + "ffn_norm.weight"),
                "mlp": {
                    "w_gate": lin(p + "ffn_gate.weight"),
                    "w_up": lin(p + "ffn_up.weight"),
                    "w_down": lin(p + "ffn_down.weight"),
                },
            })
        state: State = {
            "embed": vec("token_embd.weight"),
            "final_norm": vec("output_norm.weight"),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            state["lm_head"] = lin("output.weight")
        return cfg, state, g.tokenizer()
    finally:
        g.close()
