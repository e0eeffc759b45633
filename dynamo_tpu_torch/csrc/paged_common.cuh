// Shared pieces of the attention kernels: the warp width (for
// flash_tile.cuh's kernels too, paged_prefill.cu and ring_flash.cu), and
// paged_decode.cu's page loaders, reductions and row dot product.
//
// Cache layout (dynamo_tpu_torch/engine/kv_cache.py): one layer's K or V is
// a row-major [S, F] buffer, S = num_blocks * block_size slots and
// F = Hkv * D features, head-major.  One page of one kv head is therefore
// `bs` rows of a D-wide column band, each row D contiguous elements.  The
// cache is bf16, or int8 with per-token, per-head f32 scales in [S, Hkv]
// buffers beside it; both loaders write the same padded bf16 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Row stride, in bf16x2 words, of a page tile in shared memory: D / 2
// words padded by one, so threads reading the same word index of
// consecutive rows fall in different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D / 2 + 1; }

// Copy one page of kv head `h` (rows [page * bs, page * bs + bs), columns
// [h * D, h * D + D)) of K and V into the padded shared tiles.  Global reads
// are 16-byte vectors (D % 8 == 0 and 16-byte aligned buffers, checked by
// the Python wrapper); the padded rows take them as four 4-byte stores.
__device__ __forceinline__ void load_page(
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    __nv_bfloat162* __restrict__ k_s, __nv_bfloat162* __restrict__ v_s,
    int page, int bs, int F, int h, int D) {
  const int vec_per_row = D / 8;
  const int W = tile_stride(D);
  const size_t base = (size_t)page * bs;
  for (int i = threadIdx.x; i < bs * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = i % vec_per_row;
    const size_t off = (base + r) * (size_t)F + (size_t)h * D + (size_t)c * 8;
    const uint4 kv = *reinterpret_cast<const uint4*>(kc + off);
    const uint4 vv = *reinterpret_cast<const uint4*>(vc + off);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kv);
    const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k_s[r * W + c * 4 + j] = kp[j];
      v_s[r * W + c * 4 + j] = vp[j];
    }
  }
}

// int8 variant of load_page: the page's K/V rows of head h arrive as
// 16-byte vectors of int8 (D % 16 == 0, checked by the Python wrapper),
// its `bs` scales of head h (Hkv floats apart in the [S, Hkv] buffers) are
// staged once in shared memory, and each element goes into the tile as
// round_bf16((float)q8 * scale): an f32 product, then round to nearest
// even, as kv_cache.dequantize_rows computes it.  Contains a barrier, so
// every thread of the block must call it.
__device__ __forceinline__ void load_page_int8(
    const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    __nv_bfloat162* __restrict__ k_s, __nv_bfloat162* __restrict__ v_s,
    float* __restrict__ ks_s, float* __restrict__ vs_s,
    int page, int bs, int Hkv, int h, int D) {
  const int F = Hkv * D;
  const int vec_per_row = D / 16;
  const int W = tile_stride(D);
  const size_t base = (size_t)page * bs;
  for (int r = threadIdx.x; r < bs; r += blockDim.x) {
    ks_s[r] = ksc[(base + r) * Hkv + h];
    vs_s[r] = vsc[(base + r) * Hkv + h];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bs * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = i % vec_per_row;
    const size_t off = (base + r) * (size_t)F + (size_t)h * D + (size_t)c * 16;
    const uint4 kv = *reinterpret_cast<const uint4*>(kc + off);
    const uint4 vv = *reinterpret_cast<const uint4*>(vc + off);
    const int8_t* kp = reinterpret_cast<const int8_t*>(&kv);
    const int8_t* vp = reinterpret_cast<const int8_t*>(&vv);
    const float ks = ks_s[r], vs = vs_s[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      k_s[r * W + c * 8 + j] = __floats2bfloat162_rn((float)kp[2 * j] * ks,
                                                     (float)kp[2 * j + 1] * ks);
      v_s[r * W + c * 8 + j] = __floats2bfloat162_rn((float)vp[2 * j] * vs,
                                                     (float)vp[2 * j + 1] * vs);
    }
  }
}

// q row (f32, already scaled and bf16-rounded) . k row of the tile.
__device__ __forceinline__ float dot_row(const float* __restrict__ q,
                                         const __nv_bfloat162* __restrict__ k,
                                         int D) {
  float a = 0.f;
  for (int w = 0; w < D / 2; ++w) {
    const float2 kf = __bfloat1622float2(k[w]);
    a = fmaf(q[2 * w], kf.x, a);
    a = fmaf(q[2 * w + 1], kf.y, a);
  }
  return a;
}

// Element (t, d) of a padded tile.
__device__ __forceinline__ float tile_at(const __nv_bfloat162* __restrict__ s,
                                         int t, int d, int W) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(s);
  return __bfloat162float(e[t * 2 * W + d]);
}

}  // namespace dtt
