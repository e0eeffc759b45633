// Paged decode attention for Hopper (sm_90a), bf16 cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/paged_attention.py:
// paged_decode_attention (body _decode_kernel): one decode query per row
// against one layer's paged cache, streaming only the ceil(seq_len / bs)
// live pages with an f32 online softmax; optional attention soft cap.
//
// What bounds it on this card: bytes.  A step reads every live K/V byte of
// the batch once and does ~2 flops per byte read (G = Hq / Hkv query heads
// per kv head), far under the H100's ~295 flops/byte ridge, so the floor
// is the K/V bytes over HBM bandwidth.
//
// What the design does about it: one CTA per (row b, kv head h) loads each
// page's [bs, D] K and V slice of head h exactly once into shared memory
// and contracts all G query heads of that kv head against it, so every
// cache byte crosses HBM once per step.  The TPU kernel's Hkv-fold banding
// (each query masked into its head's column band, Hkv x the flops) was a
// lane-width workaround and is dropped.  Rows with seq_len == 0 read no
// block-table entry and write zeros.  Loads are plain 16-byte vectors with
// no cp.async/TMA pipelining and B * Hkv CTAs (512 at b64 on Llama-3-1B);
// a flash-decoding split over pages and an async copy pipeline are later
// work.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOut = 8;  // outputs per thread: G * D <= kThreads * kMaxOut

__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, D]
    const __nv_bfloat16* __restrict__ kc,  // [S, F]
    const __nv_bfloat16* __restrict__ vc,  // [S, F]
    const int* __restrict__ block_tables,  // [B, P]
    const int* __restrict__ seq_lens,      // [B]
    __nv_bfloat16* __restrict__ out,       // [B, Hq, D]
    int Hq, int Hkv, int D, int P, int bs, float scale, float soft_cap) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv, F = Hkv * D, W = dtt::tile_stride(D);
  const int warp = tid / dtt::kWarp, lane = tid % dtt::kWarp;
  constexpr int kWarps = kThreads / dtt::kWarp;

  extern __shared__ float smem[];
  float* q_s = smem;                // [G, D] scaled, bf16-rounded query
  float* p_s = q_s + G * D;         // [G, bs] scores, then probabilities
  float* m_s = p_s + G * bs;        // [G] running max
  float* l_s = m_s + G;             // [G] running denominator
  float* a_s = l_s + G;             // [G] this page's rescale factor
  __nv_bfloat162* k_s = reinterpret_cast<__nv_bfloat162*>(a_s + G);
  __nv_bfloat162* v_s = k_s + bs * W;

  const int seq_len = seq_lens[b];
  const int n_pages = (seq_len + bs - 1) / bs;
  // The G query heads of kv head h are contiguous in q: h * G .. h * G + G.
  const size_t q_off = ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = dtt::round_bf16(__bfloat162float(q[q_off + i]) * scale);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) acc[k] = 0.f;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int page = block_tables[(size_t)b * P + p];
    dtt::load_page(kc, vc, k_s, v_s, page, bs, F, h, D);
    __syncthreads();
    const int valid = min(bs, seq_len - p * bs);
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i % bs;
      float s = -INFINITY;
      if (t < valid) {
        s = dtt::dot_row(q_s + g * D, k_s + t * W, D);
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < bs; t += dtt::kWarp) mx = fmaxf(mx, p_s[g * bs + t]);
      mx = dtt::warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: t = 0 is always live
      float sum = 0.f;
      for (int t = lane; t < bs; t += dtt::kWarp) {
        const float e = expf(p_s[g * bs + t] - m_new);
        sum += e;
        // The second product takes the probabilities in V's type (bf16),
        // the denominator sums them in f32 — as the TPU kernel does.
        p_s[g * bs + t] = dtt::round_bf16(e);
      }
      sum = dtt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* pg = p_s + g * bs;
        float a = acc[k] * a_s[g];
        for (int t = 0; t < valid; ++t) a = fmaf(pg[t], dtt::tile_at(v_s, t, d, W), a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < G * D) {
      const int g = idx / D;
      out[q_off + idx] = __float2bfloat16(acc[k] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

}  // namespace

extern "C" int dtt_paged_decode_max_out() { return kThreads * kMaxOut; }

extern "C" int dtt_paged_decode_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* seq_lens, void* out,
    int B, int Hq, int Hkv, int D, int P, int block_size, float scale,
    float soft_cap, void* stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * block_size + 3 * G) +
                      2 * sizeof(__nv_bfloat162) * (size_t)block_size * dtt::tile_stride(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<__nv_bfloat16*>(out), Hq, Hkv, D, P,
      block_size, scale, soft_cap);
  return (int)cudaGetLastError();
}
