// Packed ragged paged prefill attention for Hopper (sm_90a), bf16 cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/paged_prefill.py:
// paged_prefill_attention (body _prefill_kernel).  Several sequences'
// prefill chunks ride one flat [T] query axis ("segments", each with its
// own q_start, q_len, seq_len and block-table row).  A query of segment r
// at absolute position q_pos sees its own table's slots where
// kv_pos < seq_len AND kv_pos <= q_pos — cached prefix and in-chunk
// causality in one mask; the chunk's own K/V are already in the pool.
// Rows that no segment owns come back zero.
//
// What bounds it on this card: operations, at long chunks.  A chunk of L
// queries over L keys does ~2 * L * Hq * D * L flops on 2 * L * F * 2
// bytes of K/V; past a few dozen tokens the flops per byte pass the H100's
// ~295 ridge, so the floor is the causal flops over the tensor-core peak.
//
// What the design does about it: one CTA per (segment, q tile, kv head)
// holds M = 64 query rows (TQ = 64 / G tokens x the G query heads of the
// kv head, which share every K/V load), streams only the pages its tile
// can see (the sweep stops at the tile's causal bound, as the TPU kernel's
// kv_hi) through shared memory once, and keeps an f32 online softmax per
// row.  The products run on the CUDA cores in f32: this first version does
// not reach the tensor cores, so it sits well above its bound at long
// chunks; an mma.sync / wgmma tile version is later work.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;           // M: query rows (token x head) per CTA
constexpr float kNegInf = -1e30f;   // finite, as the TPU kernel's _NEG_INF

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [T, Hq, D]
    const __nv_bfloat16* __restrict__ kc,  // [S, F]
    const __nv_bfloat16* __restrict__ vc,  // [S, F]
    const int* __restrict__ block_tables,  // [R, P]
    const int* __restrict__ seq_lens,      // [R] context after this chunk
    const int* __restrict__ q_starts,      // [R] packed row of first query
    const int* __restrict__ q_lens,        // [R] query rows (0 = pad segment)
    __nv_bfloat16* __restrict__ out,       // [T, Hq, D]
    int T, int R, int Hq, int Hkv, int P, int bs, float scale, float soft_cap) {
  static_assert(kThreads % D == 0, "a thread keeps one column d of the output");
  constexpr int kOut = kRows * D / kThreads;  // outputs per thread
  constexpr int kRowStep = kThreads / D;      // rows between a thread's outputs
  const int r = blockIdx.x, qt = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv, TQ = kRows / G, F = Hkv * D, W = dtt::tile_stride(D);
  const int warp = tid / dtt::kWarp, lane = tid % dtt::kWarp;
  constexpr int kWarps = kThreads / dtt::kWarp;

  // Rows no segment owns are zeroed by segment 0's CTAs: tile qt of the
  // whole packed axis, this kv head's G query heads.
  if (r == 0) {
    for (int i = tid; i < TQ * G * D; i += kThreads) {
      const int row = qt * TQ + i / (G * D);
      if (row >= T) break;
      bool owned = false;
      for (int s = 0; s < R; ++s) {
        const int ql = q_lens[s], qs = q_starts[s];
        owned |= (ql > 0 && row >= qs && row < qs + ql);
      }
      if (!owned)
        out[((size_t)row * Hq + (size_t)h * G) * D + i % (G * D)] = __float2bfloat16(0.f);
    }
  }

  const int q_len = q_lens[r];
  const int row0 = qt * TQ;  // first query of this tile, within the segment
  if (q_len <= 0 || row0 >= q_len) return;
  const int seq_len = seq_lens[r], q_start = q_starts[r];
  const int chunk_start = seq_len - q_len;
  const int n_rows = min(TQ, q_len - row0);
  // Causality bounds the sweep: the tile's last query sees at most
  // position chunk_start + row0 + n_rows - 1.
  const int kv_hi = min(seq_len, chunk_start + row0 + n_rows);
  const int n_pages = (kv_hi + bs - 1) / bs;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [M, D], row m = token i * G + head g
  float* p_s = q_s + kRows * D;      // [M, bs]
  float* m_s = p_s + kRows * bs;     // [M]
  float* l_s = m_s + kRows;          // [M]
  float* a_s = l_s + kRows;          // [M]
  __nv_bfloat162* k_s = reinterpret_cast<__nv_bfloat162*>(a_s + kRows);
  __nv_bfloat162* v_s = k_s + bs * W;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int m = idx / D, d = idx % D, i = m / G, g = m % G;
    float x = 0.f;
    if (i < n_rows)
      x = __bfloat162float(
          q[((size_t)(q_start + row0 + i) * Hq + (size_t)h * G + g) * D + d]);
    q_s[idx] = dtt::round_bf16(x * scale);
  }
  for (int m = tid; m < kRows; m += kThreads) {
    m_s[m] = kNegInf;
    l_s[m] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;
  const int d_own = tid % D;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int page = block_tables[(size_t)r * P + p];
    dtt::load_page(kc, vc, k_s, v_s, page, bs, F, h, D);
    __syncthreads();
    for (int idx = tid; idx < kRows * bs; idx += kThreads) {
      const int m = idx / bs, t = idx % bs, i = m / G;
      const int kv_pos = p * bs + t, q_pos = chunk_start + row0 + i;
      float s = kNegInf;
      if (i < n_rows && kv_pos < seq_len && kv_pos <= q_pos) {
        s = dtt::dot_row(q_s + m * D, k_s + t * W, D);
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      }
      p_s[idx] = s;
    }
    __syncthreads();
    for (int m = warp; m < kRows; m += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < bs; t += dtt::kWarp) mx = fmaxf(mx, p_s[m * bs + t]);
      mx = dtt::warp_max(mx);
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += dtt::kWarp) {
        const float e = expf(p_s[m * bs + t] - m_new);
        sum += e;
        p_s[m * bs + t] = dtt::round_bf16(e);
      }
      sum = dtt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[m] = alpha;
        l_s[m] = l_s[m] * alpha + sum;
        m_s[m] = m_new;
      }
    }
    __syncthreads();
    // This thread's outputs are rows m_k = tid / D + k * kRowStep of one
    // column d_own, so each V element it reads serves all kOut rows.
#pragma unroll
    for (int k = 0; k < kOut; ++k) acc[k] *= a_s[tid / D + k * kRowStep];
    for (int t = 0; t < bs; ++t) {
      const float vt = dtt::tile_at(v_s, t, d_own, W);
#pragma unroll
      for (int k = 0; k < kOut; ++k)
        acc[k] = fmaf(p_s[(tid / D + k * kRowStep) * bs + t], vt, acc[k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int m = tid / D + k * kRowStep, i = m / G, g = m % G;
    if (i < n_rows)
      out[((size_t)(q_start + row0 + i) * Hq + (size_t)h * G + g) * D + d_own] =
          __float2bfloat16(acc[k] / fmaxf(l_s[m], 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* block_tables, const void* seq_lens, const void* q_starts,
           const void* q_lens, void* out, int T, int R, int Hq, int Hkv, int P,
           int block_size, float scale, float soft_cap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int TQ = kRows / G;
  const size_t smem = sizeof(float) * ((size_t)kRows * D + (size_t)kRows * block_size +
                                       3 * kRows) +
                      2 * sizeof(__nv_bfloat162) * (size_t)block_size * dtt::tile_stride(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(R, (T + TQ - 1) / TQ, Hkv);
  paged_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<const int*>(q_starts),
      static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out), T, R, Hq, Hkv, P,
      block_size, scale, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Query rows per CTA; the Python wrapper requires Hq / Hkv to divide it.
extern "C" int dtt_paged_prefill_rows() { return kRows; }

extern "C" int dtt_paged_prefill_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* block_tables,
    const void* seq_lens, const void* q_starts, const void* q_lens, void* out, int T,
    int R, int Hq, int Hkv, int D, int P, int block_size, float scale, float soft_cap,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k_cache, v_cache, block_tables, seq_lens, q_starts, q_lens, out,
                        T, R, Hq, Hkv, P, block_size, scale, soft_cap, s);
    case 64:
      return launch<64>(q, k_cache, v_cache, block_tables, seq_lens, q_starts, q_lens, out,
                        T, R, Hq, Hkv, P, block_size, scale, soft_cap, s);
    case 128:
      return launch<128>(q, k_cache, v_cache, block_tables, seq_lens, q_starts, q_lens, out,
                         T, R, Hq, Hkv, P, block_size, scale, soft_cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
