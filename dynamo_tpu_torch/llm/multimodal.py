"""Multimodal pipeline: processor -> encode worker -> LLM engine (port of
`dynamo_tpu/llm/multimodal.py`).

- `StubVisionEncoder` — a deterministic image -> [n_tokens, hidden]
  embedding (a seeded normal of the image reference), standing in for a
  vision tower: distinct images give distinct embeddings, so tests can
  check that they steer generation.
- `EncodeWorker` — serves the `encode` RPC (`--role encode`).  For a
  puller that advertises a fabric this worker's device plane reaches
  (llm/block_manager/device_transfer.py), the embeddings are staged on
  the device as a short-TTL offer and only the descriptor rides the RPC;
  otherwise they ride it inline as float32 bytes.
- `MultimodalAttach` — the frontend's hook: the chat's `image_url` parts
  become embeddings (a local encoder in a single-process frontend, else
  the namespace's `encoder/encode` endpoint), placeholder tokens in front
  of the templated text and `prompt_embeds` on the request.
- `MultimodalProcessor` — the same layout built from raw message dicts.

The engine prefills a request with `prompt_embeds` through the packed
prefill step, its `input_embeds` / `embed_mask` pair taking those
positions in place of the token lookup (models/llama.py), and keeps the
request out of the prefix cache (placeholder ids are shared by every
image).  Plane choices are tallied as (`device` | `host`, `mm_embeds`).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.llm.block_manager.device_transfer import note_plane

logger = logging.getLogger(__name__)

ENCODE_ENDPOINT = "encode"
PLACEHOLDER_TOKEN = 0
# An offer nobody acks (this protocol has no kv_pulled) leaves the cap
# accounting after this long; a puller slower than that fails its pull.
EMBED_OFFER_TTL_S = 30.0
# How long a new encoder client waits for its watch to list instances.
FIRST_WATCH_S = 5.0


class StubVisionEncoder:
    """Deterministic image -> [n_tokens, hidden] float32 embeddings.

    `n_tokens` defaults to 64: the steering check needs the image span to
    carry real attention mass — at 16 tokens ahead of a ~107-token chat
    template the tiny random test model's greedy argmax never moved with
    the image."""

    def __init__(self, hidden_size: int, n_tokens: int = 64) -> None:
        self.hidden_size = hidden_size
        self.n_tokens = n_tokens

    def encode(self, image_ref: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.blake2b(image_ref.encode(), digest_size=4).digest(),
            "little")
        rng = np.random.default_rng(seed)
        return rng.standard_normal(
            (self.n_tokens, self.hidden_size)).astype(np.float32) * 0.02


class EncodeWorker:
    """Serves the `encode` RPC: image ref -> an embedding descriptor on
    the device plane, or inline bytes."""

    def __init__(self, encoder: StubVisionEncoder,
                 transfer_plane=None) -> None:
        self.encoder = encoder
        self.plane = transfer_plane
        self.encoded = 0
        self.offered = 0

    def make_handler(self):
        async def handler(payload: dict):
            image = payload.get("image", "")
            emb = self.encoder.encode(image)
            self.encoded += 1
            # A descriptor only for a puller that advertised a fabric
            # this plane can serve; anyone else gets inline bytes.
            peer = payload.get("fabric")
            if self.plane is not None and peer is not None:
                t = torch.from_numpy(emb).to(self.plane.device)
                meta = self.plane.stage({0: t}, [0], peer_fabric=peer,
                                        ttl_s=EMBED_OFFER_TTL_S)
                if meta is not None:
                    self.offered += 1
                    yield {"kind": "descriptor", "meta": meta}
                    return
            yield {"kind": "inline", "data": emb.tobytes(),
                   "shape": list(emb.shape), "dtype": "float32"}

        return handler


async def _decode_reply(reply: Optional[dict],
                        transfer_plane=None) -> np.ndarray:
    if reply is None:
        raise ConnectionError("encode worker returned nothing")
    if reply["kind"] == "descriptor":
        if transfer_plane is None:
            raise ValueError("encode worker offered a device descriptor "
                             "but this processor has no transfer plane")
        meta = reply["meta"]
        blocks = await transfer_plane.pull(meta)
        arr = blocks[0].float().cpu().numpy()
        await transfer_plane.release(meta["uuid"])
        note_plane("device", "mm_embeds")
        return arr
    arr = np.frombuffer(reply["data"], dtype=reply["dtype"])
    note_plane("host", "mm_embeds")
    return arr.reshape(reply["shape"]).copy()


def _encode_payload(image_ref: str, transfer_plane) -> dict:
    """The encode request: it carries the puller's fabric id so the worker
    offers a descriptor only when this processor can pull it."""
    payload = {"image": image_ref}
    if transfer_plane is not None:
        payload["fabric"] = transfer_plane.fabric
    return payload


async def fetch_embeddings(rpc_client, image_ref: str,
                           transfer_plane=None) -> np.ndarray:
    """Ask an encode worker for one image's embeddings, device to device
    when both sides run a plane on one fabric."""
    reply = None
    async for msg in rpc_client.call(
            ENCODE_ENDPOINT, _encode_payload(image_ref, transfer_plane)):
        reply = msg
    return await _decode_reply(reply, transfer_plane)


class MultimodalAttach:
    """The frontend's hook from `image_url` chat parts to the request.

    The chat template renders text parts only, so the preprocessed ids
    are image-free; `attach` prepends one placeholder per embedding row
    and hangs the embeddings on the request (LLaVA's prefix layout).
    `transfer_plane` may be a zero-argument callable that makes the plane
    at the first image (a frontend opens its device only then)."""

    def __init__(self, endpoint=None, local_encoder=None,
                 transfer_plane=None) -> None:
        if endpoint is None and local_encoder is None:
            raise ValueError("need an encoder endpoint or local encoder")
        self._endpoint = endpoint
        self._client = None
        self._local = local_encoder
        self._plane = transfer_plane

    @staticmethod
    def image_refs(messages) -> List[str]:
        refs: List[str] = []
        for m in messages:
            content = getattr(m, "content", None)
            if content is None and isinstance(m, dict):
                content = m.get("content")
            if not isinstance(content, list):
                continue
            for part in content:
                if not isinstance(part, dict):
                    continue
                if part.get("type") == "image_url":
                    url = part.get("image_url")
                    if isinstance(url, dict):
                        url = url.get("url", "")
                    refs.append(url or "")
        return refs

    def plane(self):
        if callable(self._plane):
            self._plane = self._plane()
        return self._plane

    async def _fetch(self, ref: str) -> np.ndarray:
        if self._local is not None:
            return self._local.encode(ref)
        if self._client is None:
            self._client = await self._endpoint.client()
            # A new client learns the live instances from its watch's
            # replay; give that a moment before the first pick.
            try:
                await self._client.wait_for_instances(FIRST_WATCH_S)
            except asyncio.TimeoutError:
                pass    # no encode worker: the pick below says so
        plane = self.plane()
        reply = None
        async for msg in self._client.generate(_encode_payload(ref, plane)):
            reply = msg
        return await _decode_reply(reply, plane)

    async def attach(self, messages, pre):
        """Puts the request's image embeddings on `pre` (placeholder ids
        in front, `prompt_embeds`); a chat without images is unchanged."""
        refs = self.image_refs(messages)
        if not refs:
            return pre
        embeds = [await self._fetch(ref) for ref in refs]
        emb = np.concatenate(embeds, axis=0)
        pre.token_ids = [PLACEHOLDER_TOKEN] * emb.shape[0] \
            + list(pre.token_ids)
        pre.prompt_embeds = emb
        return pre


class MultimodalProcessor:
    """A chat of raw message dicts with image parts -> (token_ids,
    prompt_embeds): every image's span first (placeholder ids), then the
    text tokens."""

    def __init__(self, tokenizer, rpc_client, transfer_plane=None) -> None:
        self.tokenizer = tokenizer
        self.rpc = rpc_client
        self.plane = transfer_plane

    @staticmethod
    def split_images(messages: List[dict]) -> Tuple[List[dict], List[str]]:
        """Extract image_url parts; returns (text-only messages, refs)."""
        images: List[str] = []
        out: List[dict] = []
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                texts = []
                for part in content:
                    if part.get("type") == "image_url":
                        url = part.get("image_url")
                        if isinstance(url, dict):
                            url = url.get("url", "")
                        images.append(url or "")
                    elif part.get("type") == "text":
                        texts.append(part.get("text", ""))
                out.append({**m, "content": " ".join(texts)})
            else:
                out.append(m)
        return out, images

    async def build(self, messages: List[dict]
                    ) -> Tuple[List[int], Optional[np.ndarray]]:
        text_msgs, images = self.split_images(messages)
        text = " ".join(m.get("content") or "" for m in text_msgs)
        text_tokens = self.tokenizer.encode(text)
        if not images:
            return text_tokens, None
        embeds = []
        for ref in images:
            embeds.append(await fetch_embeddings(self.rpc, ref, self.plane))
        emb = np.concatenate(embeds, axis=0)
        tokens = [PLACEHOLDER_TOKEN] * emb.shape[0] + list(text_tokens)
        return tokens, emb
