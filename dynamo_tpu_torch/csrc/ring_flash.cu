// Ring attention flash fold for Hopper (sm_90a), bf16 or int8 K/V blocks.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/ring_attention.py:
// ring_flash_attention (kernel _ring_kernel, fold _flash_fold).  There one
// program per sequence shard lives through all sp hops: it keeps its Q
// block and an online-softmax state (m, l, acc) in fast memory, folds the
// K/V block that is visiting it, and pulls the next hop's block from its
// neighbour with a remote copy started from inside the kernel.  A CUDA block
// cannot wait for a peer's copy, so here the hop loop is outside: one
// launch of this kernel is ONE fold of one shard (rank), the state lives in
// device memory between launches (m, l [B, Hq, Tq] and acc [B, Tq, Hq, D],
// f32), and the rotation is device-to-device copies on side streams
// (dynamo_tpu_torch/parallel/mesh.py).  The first hop's launch starts the
// state instead of reading it; the last hop's writes acc / max(l, 1e-30)
// in bf16 instead of storing it.
//
// Arithmetic, as the plain version (ops/ring_attention.py:ring_fold): q
// arrives scaled in f32; bf16 K/V widen to f32; int8 K/V become
// round_bf16((float)q8 * scale) and then widen; both products and the
// state are f32; soft_cap comes before the mask; masked scores are the
// finite -1e30, so a row that has seen no key yet adds exp(0) = 1 per
// masked key (padding rows: junk but finite) and exp(m - m_new) at
// m = m_new = -1e30 is 1.
//
// A kv tile is skipped only when that cannot change the result: every key
// of the tile lies after every query of the CTA (the tile is wholly
// masked) AND every row of the CTA already has a real maximum, so that the
// tile would add exp(-1e30 - m) = 0 to l and acc and leave m as it is.  A
// launch whose whole block is masked that way returns before it touches
// acc.
//
// What bounds it on this card: operations.  A fold of Tq queries over Tk
// keys does 4 * Tq * Tk * Hq * D flops on (Tq * Hq + 2 * Tk * Hkv) * D
// operand values plus the state; at Tq = Tk = 128 that is already ~50
// flops a byte and it grows with the shard, so the floor is the unmasked
// flops over the tensor-core peak.  What the design does about it: one CTA
// per (q tile, kv head, batch row) holds 64 query rows (64 / G tokens x
// the G query heads of the kv head, which share every K/V load), streams
// the visiting block through shared memory in 64-key tiles (K and V take
// turns in one tile buffer, so that several CTAs fit an SM), and computes
// both products as register tiles (4 x 8 scores, 4 x D/8 outputs per
// thread), so each shared-memory word read feeds 2.7 to 3.2 multiply-adds.
// The products run on the CUDA cores in f32: q is f32 by contract, so the
// bf16 tensor cores would change the arithmetic; an mma version (split-f32
// or bf16 q with an agreed tolerance) is later work.
#include "paged_common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;          // M: query rows (token x head) per CTA
constexpr int kKeys = 64;          // N: keys per kv tile
constexpr int kRowsPerThread = 4;  // a thread's rows: 4 * ty .. 4 * ty + 3
constexpr int kLanesPerRow = 8;    // threads sharing a row; columns tx + 8 * j
constexpr float kNeg = -1e30f;     // the mask fill, finite
constexpr float kReal = -1e29f;    // a running max above this has seen a key
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = dtt::kWarp / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = dtt::kWarp / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage 64 keys [t0, t0 + 64) of kv head h of batch row b into an f32 tile
// with row stride D + 1 (rows past Tk are zero).
template <int D, bool kInt8>
__device__ __forceinline__ void load_tile(const void* __restrict__ src,
                                          const float* __restrict__ scale,
                                          float* __restrict__ tile, int b, int h, int t0,
                                          int Tk, int Hkv) {
  constexpr int kVec = kInt8 ? 16 : 8;  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < kKeys * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    const int t = t0 + r;
    float* dst = tile + r * (D + 1) + c * kVec;
    if (t >= Tk) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
      continue;
    }
    const size_t row = (size_t)b * Tk + t;
    const size_t off = (row * Hkv + h) * D + (size_t)c * kVec;
    if constexpr (kInt8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(src) + off);
      const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
      const float s = scale[row * Hkv + h];
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = dtt::round_bf16((float)p[e] * s);
    } else {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(src) + off);
      const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = __bfloat162float(p[e]);
    }
  }
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads) ring_fold_kernel(
    const float* __restrict__ q,       // [B, Tq, Hq, D] f32, already scaled
    const int* __restrict__ q_pos,     // [B, Tq] absolute positions
    const void* __restrict__ k,        // [B, Tk, Hkv, D] bf16 or int8
    const void* __restrict__ v,        // [B, Tk, Hkv, D]
    const float* __restrict__ ksc,     // [B, Tk, Hkv] f32 (int8 only)
    const float* __restrict__ vsc,
    const int* __restrict__ kv_pos,    // [B, Tk]
    float* __restrict__ m_st,          // [B, Hq, Tq]
    float* __restrict__ l_st,          // [B, Hq, Tq]
    float* __restrict__ acc_st,        // [B, Tq, Hq, D]
    __nv_bfloat16* __restrict__ out,   // [B, Tq, Hq, D] (written when last)
    int Tq, int Tk, int Hq, int Hkv, float soft_cap, int first, int last) {
  constexpr int kCols = D / kLanesPerRow;  // a thread's output columns
  constexpr int QS = D + 1;                // row stride of the f32 tiles
  constexpr int PS = kKeys + 1;            // row stride of the score tile
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv, TQ = kRows / G;
  const int ty = tid / kLanesPerRow, tx = tid % kLanesPerRow;
  const int lane = tid % dtt::kWarp, warp = tid / dtt::kWarp;
  const int tok0 = qt * TQ;

  extern __shared__ float smem[];
  float* q_s = smem;                         // [64, D + 1]
  float* kv_s = q_s + kRows * QS;            // [64, D + 1]: the K tile, then V
  float* p_s = kv_s + kKeys * QS;            // [64, 65]
  int* qpos_s = reinterpret_cast<int*>(p_s + kRows * PS);  // [64]
  int* kpos_s = qpos_s + kRows;                            // [2, 64]
  int* red_s = kpos_s + 2 * kKeys;                         // [4]

  // Row m of the CTA is token tok0 + m / G, query head h * G + m % G.
  for (int m = tid; m < kRows; m += kThreads) {
    const int tok = tok0 + m / G;
    qpos_s[m] = tok < Tq ? q_pos[(size_t)b * Tq + tok] : INT_MIN;
  }
  // Smallest key position of the whole visiting block.
  int kmin = INT_MAX;
  for (int t = tid; t < Tk; t += kThreads) kmin = min(kmin, kv_pos[(size_t)b * Tk + t]);
  kmin = warp_min_int(kmin);
  if (lane == 0) red_s[warp] = kmin;

  // This thread's four rows and their running max and sum.
  int tok_r[kRowsPerThread], head_r[kRowsPerThread];
  float m_r[kRowsPerThread], l_r[kRowsPerThread];
  bool real = true;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = kRowsPerThread * ty + i;
    tok_r[i] = tok0 + m / G;
    head_r[i] = h * G + m % G;
    m_r[i] = kNeg;
    l_r[i] = 0.f;
    if (tok_r[i] < Tq) {
      if (!first) {
        const size_t s = ((size_t)b * Hq + head_r[i]) * Tq + tok_r[i];
        m_r[i] = m_st[s];
        l_r[i] = l_st[s];
      }
      real = real && m_r[i] > kReal;
    }
  }
  int all_real = __syncthreads_and(real);
  const int qmax = warp_max_int(max(qpos_s[lane], qpos_s[lane + dtt::kWarp]));
  kmin = min(min(red_s[0], red_s[1]), min(red_s[2], red_s[3]));
  // The whole block is masked for rows that all have a real max: the fold
  // changes nothing, and only the last hop still has to write its output.
  if (all_real && kmin > qmax && !last) return;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int m = idx / D, d = idx % D;
    const int tok = tok0 + m / G;
    q_s[m * QS + d] =
        tok < Tq ? q[(((size_t)b * Tq + tok) * Hq + h * G + m % G) * D + d] : 0.f;
  }
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const size_t base = (((size_t)b * Tq + tok_r[i]) * Hq + head_r[i]) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[i][j] = (!first && tok_r[i] < Tq) ? acc_st[base + tx + kLanesPerRow * j] : 0.f;
  }

  const int n_tiles = (Tk + kKeys - 1) / kKeys;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kKeys;
    int* kp = kpos_s + (tile & 1) * kKeys;
    if (tid < kKeys) kp[tid] = t0 + tid < Tk ? kv_pos[(size_t)b * Tk + t0 + tid] : INT_MAX;
    // Barrier: the positions are staged, and every warp is done with the
    // previous tile's kv_s and p_s.
    all_real = __syncthreads_and(real);
    const int tile_min = warp_min_int(min(kp[lane], kp[lane + dtt::kWarp]));
    if (all_real && tile_min > qmax) continue;

    load_tile<D, kInt8>(k, ksc, kv_s, b, h, t0, Tk, Hkv);
    __syncthreads();

    // Scores: rows 4 * ty + i, keys tx + 8 * j.
    float s[kRowsPerThread][kKeys / kLanesPerRow];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeys / kLanesPerRow; ++j) s[i][j] = 0.f;
    const float* q_row = q_s + kRowsPerThread * ty * QS;
    const float* k_row = kv_s + tx * QS;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kKeys / kLanesPerRow];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_row[i * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys / kLanesPerRow; ++j) kv[j] = k_row[j * kLanesPerRow * QS + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeys / kLanesPerRow; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax per row; the 8 threads of a row are 8 neighbouring
    // lanes of one warp.
    real = true;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qp = qpos_s[kRowsPerThread * ty + i];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys / kLanesPerRow; ++j) {
        float x = s[i][j];
        if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
        x = kp[tx + kLanesPerRow * j] <= qp ? x : kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / kLanesPerRow; ++j) {
        const int col = tx + kLanesPerRow * j;
        // A key past the end of the block is no key: it adds nothing,
        // whatever the row's state.
        const float p = t0 + col < Tk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(kRowsPerThread * ty + i) * PS + col] = p;
      }
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      if (tok_r[i] < Tq) real = real && m_new > kReal;
    }
    // The K tile is spent: V takes its place (one tile buffer keeps two
    // to four CTAs on an SM).  The barriers also publish p_s.
    __syncthreads();
    load_tile<D, kInt8>(v, vsc, kv_s, b, h, t0, Tk, Hkv);
    __syncthreads();

    // acc[rows 4 * ty + i][columns tx + 8 * j] += P . V
    const float* p_row = p_s + kRowsPerThread * ty * PS;
#pragma unroll 4
    for (int t = 0; t < kKeys; ++t) {
      float pv[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = p_row[i * PS + t];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kv_s[t * QS + tx + kLanesPerRow * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (tok_r[i] >= Tq) continue;
    const size_t base = (((size_t)b * Tq + tok_r[i]) * Hq + head_r[i]) * D;
    if (last) {
      const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[base + tx + kLanesPerRow * j] = __float2bfloat16(acc[i][j] * inv);
    } else {
      if (tx == 0) {
        const size_t s = ((size_t)b * Hq + head_r[i]) * Tq + tok_r[i];
        m_st[s] = m_r[i];
        l_st[s] = l_r[i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc_st[base + tx + kLanesPerRow * j] = acc[i][j];
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kRows + kKeys) * (D + 1) + (size_t)kRows * (kKeys + 1)) +
         sizeof(int) * (kRows + 2 * kKeys + 4);
}

template <int D, bool kInt8>
int launch(const void* q, const void* q_pos, const void* k, const void* v, const void* ksc,
           const void* vsc, const void* kv_pos, void* m, void* l, void* acc, void* out, int B,
           int Tq, int Tk, int Hq, int Hkv, float soft_cap, int first, int last,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    // The attribute belongs to the device: set it once on each.
    static bool done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices || !done[dev]) {
      e = cudaFuncSetAttribute(ring_fold_kernel<D, kInt8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) done[dev] = true;
    }
  }
  const int TQ = kRows / (Hq / Hkv);
  dim3 grid((Tq + TQ - 1) / TQ, Hkv, B);
  ring_fold_kernel<D, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(q_pos), k, v,
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(kv_pos), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), static_cast<__nv_bfloat16*>(out), Tq, Tk, Hq, Hkv, soft_cap,
      first, last);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* q, const void* q_pos, const void* k, const void* v, const void* ksc,
             const void* vsc, const void* kv_pos, void* m, void* l, void* acc, void* out,
             int B, int Tq, int Tk, int Hq, int Hkv, int D, float soft_cap, int first,
             int last, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv || kRows % (Hq / Hkv))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch<32, kInt8>(q, q_pos, k, v, ksc, vsc, kv_pos, m, l, acc, out, B, Tq, Tk,
                               Hq, Hkv, soft_cap, first, last, s);
    case 64:
      return launch<64, kInt8>(q, q_pos, k, v, ksc, vsc, kv_pos, m, l, acc, out, B, Tq, Tk,
                               Hq, Hkv, soft_cap, first, last, s);
    case 128:
      return launch<128, kInt8>(q, q_pos, k, v, ksc, vsc, kv_pos, m, l, acc, out, B, Tq, Tk,
                                Hq, Hkv, soft_cap, first, last, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Query rows per CTA; the Python wrapper requires Hq / Hkv to divide it.
extern "C" int dtt_ring_fold_rows() { return kRows; }

extern "C" int dtt_ring_fold_bf16(const void* q, const void* q_pos, const void* k,
                                  const void* v, const void* kv_pos, void* m, void* l,
                                  void* acc, void* out, int B, int Tq, int Tk, int Hq,
                                  int Hkv, int D, float soft_cap, int first, int last,
                                  void* stream) {
  return dispatch<false>(q, q_pos, k, v, nullptr, nullptr, kv_pos, m, l, acc, out, B, Tq, Tk,
                         Hq, Hkv, D, soft_cap, first, last, stream);
}

extern "C" int dtt_ring_fold_int8(const void* q, const void* q_pos, const void* k,
                                  const void* v, const void* k_scale, const void* v_scale,
                                  const void* kv_pos, void* m, void* l, void* acc, void* out,
                                  int B, int Tq, int Tk, int Hq, int Hkv, int D,
                                  float soft_cap, int first, int last, void* stream) {
  return dispatch<true>(q, q_pos, k, v, k_scale, v_scale, kv_pos, m, l, acc, out, B, Tq, Tk,
                        Hq, Hkv, D, soft_cap, first, last, stream);
}
