"""Model manager + the engine-client seam (port of
`dynamo_tpu/llm/service.py`).

`EngineClient` is the streaming contract the HTTP frontend talks to;
`LocalEngineClient` serves it from an in-process `InferenceEngine` (the
single-process frontend and each worker), `llm/discovery` and
`llm/kv_router` serve it over the RPC from workers, and `ModelManager`
is the frontend's model registry (models come and go as workers do).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Protocol

from dynamo_tpu_torch.engine.engine import InferenceEngine, TokenDelta
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import Tokenizer


class EngineClient(Protocol):
    """Streaming generate contract."""

    def generate(self, request: PreprocessedRequest
                 ) -> AsyncIterator[TokenDelta]: ...


class LocalEngineClient:
    """EngineClient over an in-process InferenceEngine."""

    def __init__(self, engine: InferenceEngine) -> None:
        self.engine = engine

    async def generate(self, request: PreprocessedRequest
                       ) -> AsyncIterator[TokenDelta]:
        async for delta in self.engine.generate(
                request.request_id, request.token_ids, request.sampling):
            yield delta

    async def embed(self, token_lists):
        """Last-token hidden-state embeddings, [n, hidden] f32 (the
        /v1/embeddings engine surface)."""
        return await self.engine.embed(token_lists)

    async def clear_kv_blocks(self) -> int:
        return await self.engine.clear_kv_blocks()


@dataclass
class ModelHandle:
    """Everything the frontend needs to serve one model."""

    name: str
    tokenizer: Tokenizer
    preprocessor: OpenAIPreprocessor
    client: EngineClient
    # Context ceiling: a prompt alone at or over it is a 400, and
    # max_tokens is clamped to fit.
    max_context: int = 8192


class ModelManager:
    def __init__(self) -> None:
        self._models: Dict[str, ModelHandle] = {}

    def register(self, handle: ModelHandle) -> None:
        self._models[handle.name] = handle

    def remove(self, name: str) -> None:
        self._models.pop(name, None)

    def get(self, name: str) -> Optional[ModelHandle]:
        return self._models.get(name)

    def names(self) -> List[str]:
        return sorted(self._models)

    def __len__(self) -> int:
        return len(self._models)
