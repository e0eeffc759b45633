"""OpenAI request → internal engine request: chat template + tokenize
(port of `dynamo_tpu/llm/preprocessor.py`).

Chat templates are Jinja2 (the format HF ships in tokenizer_config.json);
a model card may carry its own, else the Llama-3 header/eot default.
Declared tools reach the template as `tools` (the variable HF templates
read), shaped by `tool_choice`: "none" hides them, a forced function
narrows them to it, and forcing a function the request does not declare
is a client error.  An assistant message's `tool_calls` reach it too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jinja2

from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer

DEFAULT_CHAT_TEMPLATE = (
    "{% if tools %}"
    "<|start_header_id|>system<|end_header_id|>\n\n"
    "You may call these tools; respond with a JSON object "
    '{"name": ..., "arguments": ...} to invoke one:\n'
    "{{ tools | tojson }}<|eot_id|>"
    "{% endif %}"
    "{% for message in messages %}"
    "<|start_header_id|>{{ message.role }}<|end_header_id|>\n\n"
    "{{ message.content }}"
    "{% if message.tool_calls %}"
    "{{ message.tool_calls | tojson }}"
    "{% endif %}"
    "<|eot_id|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n"
    "{% endif %}"
)


@dataclass
class PreprocessedRequest:
    """The internal request form handed to the engine."""

    request_id: str
    model: str
    token_ids: List[int]
    sampling: SamplingParams
    stop_sequences: List[str] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)
    # Multimodal: [n, hidden] float32 embeddings taking prompt positions
    # [0, n) (llm/multimodal.py); token_ids hold placeholders there.
    prompt_embeds: Optional[object] = None


def template_tools(request: ChatCompletionRequest) -> Optional[list]:
    """The tools the template sees under `tool_choice` (OpenAI's
    semantics); a forced function the request does not declare raises
    ValueError (a 400)."""
    tools = request.tools or None
    choice = request.tool_choice
    if choice == "none":
        return None
    if isinstance(choice, dict):
        forced = (choice.get("function") or {}).get("name")
        if forced and not tools:
            raise ValueError(f"tool_choice forces tool {forced!r} but the "
                             "request declares no tools")
        if forced:
            tools = [t for t in tools
                     if (t.get("function") or {}).get("name") == forced]
            if not tools:
                raise ValueError(f"tool_choice forces unknown tool "
                                 f"{forced!r}")
    return tools


class OpenAIPreprocessor:
    def __init__(self, tokenizer: Tokenizer,
                 chat_template: Optional[str] = None,
                 default_max_tokens: int = 512) -> None:
        self.tokenizer = tokenizer
        self.default_max_tokens = default_max_tokens
        env = jinja2.Environment(
            loader=jinja2.BaseLoader(), autoescape=False,
            trim_blocks=True, lstrip_blocks=True)
        self._template = env.from_string(chat_template or DEFAULT_CHAT_TEMPLATE)

    def render_chat(self, request: ChatCompletionRequest) -> str:
        messages = []
        for m in request.messages:
            msg = {"role": m.role, "content": m.text()}
            if m.tool_calls:
                msg["tool_calls"] = m.tool_calls
            messages.append(msg)
        return self._template.render(messages=messages,
                                     add_generation_prompt=True,
                                     tools=template_tools(request))

    def preprocess_chat(self, request: ChatCompletionRequest,
                        request_id: str) -> PreprocessedRequest:
        prompt = self.render_chat(request)
        return self._build(request, request_id, self.tokenizer.encode(prompt),
                           annotations={"formatted_prompt": prompt})

    def preprocess_completion(self, request: CompletionRequest,
                              request_id: str) -> PreprocessedRequest:
        prompt = request.prompt
        if isinstance(prompt, str):
            return self._build(request, request_id,
                               self.tokenizer.encode(prompt),
                               annotations={"formatted_prompt": prompt})
        return self._build(request, request_id, list(prompt), annotations={})

    def _build(self, request, request_id, token_ids, annotations):
        sampling = SamplingParams(
            # OpenAI's documented default is temperature=1.0 (stochastic);
            # clients opt in to greedy with temperature=0.
            temperature=(request.temperature
                         if request.temperature is not None else 1.0),
            top_k=request.top_k or 0,
            top_p=request.top_p if request.top_p is not None else 1.0,
            max_tokens=request.effective_max_tokens(self.default_max_tokens),
            stop_token_ids=tuple(self.tokenizer.eos_token_ids),
            seed=request.seed,
            logprobs=bool(request.logprobs),
        )
        return PreprocessedRequest(
            request_id=request_id, model=request.model, token_ids=token_ids,
            sampling=sampling, stop_sequences=request.stop_list(),
            annotations=annotations)
