"""Model Deployment Card (MDC) — what a worker publishes about its model
(port of `dynamo_tpu/llm/model_card.py`).

Role of the reference's `lib/llm/src/model_card.rs:90-120`
(ModelDeploymentCard: tokenizer / prompt-formatter / gen-config refs,
published to NATS object store + etcd entry): everything a frontend needs
to serve a model it has never seen locally — tokenizer construction,
chat template, context limits, KV geometry for routing.

Tokenizer specs:
- {"kind": "byte"} — the dependency-free byte tokenizer (presets, GGUF);
- {"kind": "hf_file", "path": ...} — a tokenizer.json on a shared
  filesystem;
- {"kind": "hf_inline", "json": <tokenizer.json contents>, "eos_token"?} —
  the artifact travels with the card, so a frontend that has never seen
  the checkpoint serves its tokenizer.
Both hf kinds build `HFTokenizer` (llm/tokenizer_json.py on the standard
library).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, HFTokenizer, Tokenizer


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
        if kind == "hf_file":
            return HFTokenizer(spec["path"],
                               eos_token_ids=spec.get("eos_token_ids"),
                               eos_token=spec.get("eos_token"))
        if kind == "hf_inline":
            return HFTokenizer.from_json(
                spec["json"],
                eos_token_ids=spec.get("eos_token_ids"),
                eos_token=spec.get("eos_token"))
        raise ValueError(f"unknown tokenizer spec kind {kind!r}")
