"""Model Deployment Card (MDC) — what a worker publishes about its model
(port of `dynamo_tpu/llm/model_card.py`).

Role of the reference's `lib/llm/src/model_card.rs:90-120`
(ModelDeploymentCard: tokenizer / prompt-formatter / gen-config refs,
published to NATS object store + etcd entry): everything a frontend needs
to serve a model it has never seen locally — tokenizer construction,
chat template, context limits, KV geometry for routing.

Tokenizer specs: {"kind": "byte"}, the dependency-free byte tokenizer
the port's presets use.  The reference's "hf_file" / "hf_inline" specs
need `HFTokenizer`, which is not ported yet, and raise here.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer


@dataclass
class ModelDeploymentCard:
    name: str
    tokenizer_spec: dict = field(default_factory=lambda: {"kind": "byte"})
    chat_template: Optional[str] = None
    max_context: int = 8192
    kv_block_size: int = 64
    default_max_tokens: int = 512
    model_type: str = "backend"        # reference ModelType::Backend
    revision: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ModelDeploymentCard":
        return ModelDeploymentCard(**d)

    def build_tokenizer(self) -> Tokenizer:
        spec = self.tokenizer_spec
        kind = spec.get("kind", "byte")
        if kind == "byte":
            return ByteTokenizer()
        raise ValueError(f"tokenizer spec kind {kind!r} is not served by "
                         "this package (only 'byte')")
