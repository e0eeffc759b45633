"""PyTorch/CUDA port of dynamo_tpu for NVIDIA Hopper.

The package mirrors `dynamo_tpu`'s layout so each module has an obvious
counterpart: `models/`, `engine/`, `ops/` (plain PyTorch attention plus the
hand-written CUDA kernels under `ops/cuda/`, sources in `csrc/`), `llm/`
(tokenizer, OpenAI protocol, HTTP service) and `frontend/`.

It imports `torch` (and, in the frontend, the standard library and jinja2)
and never `jax` or `dynamo_tpu`.  Entry points run on `cuda` unless the
caller asks for the CPU (`device="cpu"`, `--device cpu`).
"""

from dynamo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
