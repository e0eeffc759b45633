// Shared pieces of the kernels: the warp width (flash_tile.cuh's kernels,
// paged_prefill.cu and ring_flash.cu) and the bf16 rounding of an f32
// value (moe_grouped.cu's epilogue).
//
// Cache layout (dynamo_tpu_torch/engine/kv_cache.py): one layer's K or V is
// a row-major [S, F] buffer, S = num_blocks * block_size slots and
// F = Hkv * D features, head-major.  One page of one kv head is therefore
// `bs` rows of a D-wide column band, each row D contiguous elements.  The
// cache is bf16, or int8 with per-token, per-head f32 scales in [S, Hkv]
// buffers beside it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr int kWarp = 32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace dtt
