"""Mock engine: a complete fake engine with authentic KV semantics (port
of `dynamo_tpu/llm/mocker/`; it runs no model and needs no device: a CPU
test backend for the planner, launcher and drain paths).

Role of the reference's `lib/llm/src/mocker/`: a
vLLM-semantics engine — block-level prefix caching with LRU eviction,
watermark admission, chunked prefill, simulated step timing — that emits
*real* KV events and load metrics, so routing / frontend / disaggregation /
planner tests run with zero accelerator time.  The CI workhorse.
"""

from dynamo_tpu_torch.llm.mocker.engine import MockEngine, MockEngineArgs

__all__ = ["MockEngine", "MockEngineArgs"]
