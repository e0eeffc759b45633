"""Hand-written CUDA kernels (sources in `dynamo_tpu_torch/csrc/`), each
with its wrapper, its plain PyTorch version and a launch count.

| TPU kernel (dynamo_tpu/ops/pallas/)        | Port (bodies)                                  |
|--------------------------------------------|------------------------------------------------|
| paged_attention.py:paged_decode_attention  | paged_attention.py, paged_decode.cu (bf16, int8 cache)  |
| paged_prefill.py:paged_prefill_attention   | paged_prefill.py, paged_prefill.cu (bf16, int8 cache)   |
| moe_grouped.py:grouped_expert_ffn          | moe_grouped.py, moe_grouped.cu (bf16, int8 weights)     |
| ring_attention.py:ring_flash_attention     | ring_attention.py, ring_flash.cu (bf16, int8 K/V blocks) |

A wrapper with two cache bodies counts each under its own name, so a
window of launch counts shows which body ran.  The ring counts its fold
launches: one per rank and hop.
"""

from dynamo_tpu_torch.ops.cuda.moe_grouped import (
    DEFAULT_BLOCK_ROWS,
    dequantize_moe_params,
    grouped_expert_ffn,
    grouped_expert_ffn_plain,
    moe_grouped_geometry_ok,
    moe_params_quantized,
    quantize_moe_params,
)
from dynamo_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from dynamo_tpu_torch.ops.cuda.paged_prefill import (
    PACK_ALIGN,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from dynamo_tpu_torch.ops.cuda.ring_attention import (
    ring_flash_attention,
    ring_flash_fold,
    ring_geometry_ok,
    ring_kernel_supported,
)

# name -> (wrapper, the wrapper's attribute that counts that body)
KERNELS = {
    "paged_decode_attention": (paged_decode_attention, "launches"),
    "paged_decode_attention_int8": (paged_decode_attention, "launches_int8"),
    "paged_prefill_attention": (paged_prefill_attention, "launches"),
    "paged_prefill_attention_int8": (paged_prefill_attention,
                                     "launches_int8"),
    "moe_grouped": (grouped_expert_ffn, "launches"),
    "ring_flash_attention": (ring_flash_attention, "launches"),
    "ring_flash_attention_int8": (ring_flash_attention, "launches_int8"),
}


def launch_counts() -> dict:
    """Launches of each kernel body since its count was last reset."""
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


__all__ = [
    "DEFAULT_BLOCK_ROWS", "KERNELS", "PACK_ALIGN", "dequantize_moe_params",
    "grouped_expert_ffn", "grouped_expert_ffn_plain", "launch_counts",
    "moe_grouped_geometry_ok", "moe_params_quantized",
    "paged_decode_attention", "paged_decode_attention_plain",
    "paged_prefill_attention", "paged_prefill_attention_plain",
    "quantize_moe_params", "reset_launch_counts", "ring_flash_attention",
    "ring_flash_fold", "ring_geometry_ok", "ring_kernel_supported",
]
