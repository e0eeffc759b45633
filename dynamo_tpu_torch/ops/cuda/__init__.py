"""Hand-written CUDA kernels (sources in `dynamo_tpu_torch/csrc/`), each
with its wrapper, its plain PyTorch version and a launch count.

| TPU kernel (dynamo_tpu/ops/pallas/)        | Port                          |
|--------------------------------------------|-------------------------------|
| paged_attention.py:paged_decode_attention  | paged_attention.py, paged_decode.cu  |
| paged_prefill.py:paged_prefill_attention   | paged_prefill.py, paged_prefill.cu   |
"""

from dynamo_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from dynamo_tpu_torch.ops.cuda.paged_prefill import (
    PACK_ALIGN,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

KERNELS = {
    "paged_decode_attention": paged_decode_attention,
    "paged_prefill_attention": paged_prefill_attention,
}


def launch_counts() -> dict:
    """Launches of each kernel since its count was last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "PACK_ALIGN", "launch_counts", "paged_decode_attention",
    "paged_decode_attention_plain", "paged_prefill_attention",
    "paged_prefill_attention_plain", "reset_launch_counts",
]
