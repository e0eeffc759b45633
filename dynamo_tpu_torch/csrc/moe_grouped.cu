// Grouped MoE expert FFN (ragged grouped SwiGLU) for Hopper (sm_90a):
// bf16 activations, bf16 or int8 expert weights.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/moe_grouped.py:
// grouped_expert_ffn (body _ffn_kernel).  The rows of x_pad [S_pad, H] are
// (token, expert) assignments sorted by expert, each expert's group padded
// to 64-row tiles; row tile t runs expert tile_expert[t]'s
//     y = (silu(x Wg) * (x Wu)) Wd
// with f32 accumulation, h = x Wg and u = x Wu rounded to bf16, silu(h)
// and act = silu(h) * u rounded to bf16 (the TPU kernel materialises act
// behind an optimization barrier), and y rounded to bf16.  tile_rows[t] is
// the number of live rows of tile t (0 for tiles past the last expert's
// span): rows at or past it read nothing and come back as zeros.
//
// What bounds it on this card: bytes, at the main path's shapes.  A tile of
// at most 64 rows does 2 * 64 flops per weight value, 64 flops per bf16
// weight byte, under the H100's ~295 flops/byte ridge; so the floor is the
// live experts' weights over HBM bandwidth (Mixtral-8x7B: 2.82 GB a layer
// when all 8 experts have rows, 0.84 ms; half that in int8).
//
// What the design does about it: two kernels, one per product.
//  A (gate/up): one CTA per (tile, 64 columns of F) streams the tile's
//    [64, H] rows and its expert's two [H, 64] weight column blocks through
//    shared memory in 64-deep steps, holding the next step's loads in
//    registers while the tensor cores (WMMA bf16 fragments, f32
//    accumulators) work on the current one, and writes act [64, 64] bf16
//    into a scratch [S_pad, F] that the wrapper allocates.
//  B (down): one CTA per (tile, 64 columns of H) does the same over all of
//    F against Wd and writes the output tile.  The TPU kernel's F-blocked
//    accumulator, carried across grid steps, becomes this loop: CUDA
//    blocks run in no order.
// Every weight byte of a live expert is read once per tile of that expert
// (once per layer in decode), experts with no rows are never read, dead
// tiles return at once (B writes their zeros), and warps whose 16 rows are
// all dead skip their products.  int8 weights are dequantised into the
// shared tile with their per-column f32 scale and rounded to bf16, element
// for element as dequantize_moe_params does, so HBM weight bytes halve.
// The loads are synchronous 16-byte vectors, one step ahead; cp.async/TMA
// pipelines and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;      // 4 warps, 16 tile rows each
constexpr int kWarp = 32;
constexpr int kBM = 64;            // rows per tile (block_rows)
constexpr int kBN = 64;            // output columns per CTA
constexpr int kBK = 64;            // contraction depth per step
constexpr int kLdA = kBK + 8;      // padded shared row of the row tile (bf16)
constexpr int kLdB = kBN + 8;      // padded shared row of a weight tile (bf16)
constexpr int kLdC = kBN + 4;      // padded shared row of the f32 staging
constexpr int kFr = 16;            // WMMA fragment edge
constexpr int kNFr = kBN / kFr;    // accumulator fragments per matrix per warp

using FragA = wmma::fragment<wmma::matrix_a, kFr, kFr, kFr, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, kFr, kFr, kFr, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kFr, kFr, kFr, float>;

// Bytes of the shared buffer that holds NB weight tiles during the main loop
// and the f32 output staging after it.
__host__ __device__ constexpr int buf_bytes(int nb) {
  return nb * kBK * kLdB * 2 > kBM * kLdC * 4 ? nb * kBK * kLdB * 2 : kBM * kLdC * 4;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// [kBM, kBK] of the tile's rows, global -> registers -> shared.  Rows at or
// past n_rows read nothing and stage zeros.
struct RowTile {
  static constexpr int kVec = kBM * kBK / 8 / kThreads;  // 16-byte vectors a thread
  uint4 v[kVec];
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ a, size_t ld,
                                       int k0, int n_rows) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBK / 8), c = i % (kBK / 8);
      v[j] = r < n_rows
                 ? __ldg(reinterpret_cast<const uint4*>(a + (size_t)r * ld + k0 + c * 8))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBK / 8), c = i % (kBK / 8);
      *reinterpret_cast<uint4*>(s + r * kLdA + c * 8) = v[j];
    }
  }
};

// [kBK, kBN] of one expert weight matrix (w points at the CTA's first
// column of row 0), global -> registers -> shared bf16.
template <typename WT>
struct WeightTile;

template <>
struct WeightTile<__nv_bfloat16> {
  static constexpr int kVec = kBK * kBN / 8 / kThreads;
  uint4 v[kVec];
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ w, size_t ld, int k0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBN / 8), c = i % (kBN / 8);
      v[j] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ld + c * 8));
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* s, const float*) const {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBN / 8), c = i % (kBN / 8);
      *reinterpret_cast<uint4*>(s + r * kLdB + c * 8) = v[j];
    }
  }
};

template <>
struct WeightTile<int8_t> {
  static constexpr int kVec = kBK * kBN / 16 / kThreads;
  uint4 v[kVec];
  __device__ __forceinline__ void load(const int8_t* __restrict__ w, size_t ld, int k0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBN / 16), c = i % (kBN / 16);
      v[j] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ld + c * 16));
    }
  }
  // Dequantise as dequantize_moe_params: f32 value times its column's f32
  // scale, rounded to bf16.
  __device__ __forceinline__ void store(__nv_bfloat16* s, const float* scale) const {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (kBN / 16), c = i % (kBN / 16);
      const int8_t* q = reinterpret_cast<const int8_t*>(&v[j]);
      __align__(16) __nv_bfloat16 d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = __float2bfloat16((float)q[k] * scale[c * 16 + k]);
      uint4* dst = reinterpret_cast<uint4*>(s + r * kLdB + c * 16);
      dst[0] = reinterpret_cast<const uint4*>(d)[0];
      dst[1] = reinterpret_cast<const uint4*>(d)[1];
    }
  }
};

// acc[b][f] = rows(warp) of A[:, 0:K] . W_b[0:K, 16 f : 16 f + 16] for the
// NB weight matrices of one expert.  a: the tile's first row (row stride
// lda); w[b]: the CTA's first column of row 0 (row stride ldw); scale[b]:
// the CTA's column scales in shared memory (int8 weights only).
template <typename WT, int NB>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ a, size_t lda,
                                         int n_rows, const WT* const (&w)[NB], size_t ldw,
                                         int K, const float* const (&scale)[NB],
                                         __nv_bfloat16* a_s, __nv_bfloat16* b_s,
                                         FragC (&acc)[NB][kNFr]) {
  const int warp = threadIdx.x / kWarp;
  const bool live = warp * kFr < n_rows;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int f = 0; f < kNFr; ++f) wmma::fill_fragment(acc[b][f], 0.f);
  RowTile ra;
  WeightTile<WT> rb[NB];
  ra.load(a, lda, 0, n_rows);
#pragma unroll
  for (int b = 0; b < NB; ++b) rb[b].load(w[b], ldw, 0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    ra.store(a_s);
#pragma unroll
    for (int b = 0; b < NB; ++b) rb[b].store(b_s + b * kBK * kLdB, scale[b]);
    __syncthreads();
    if (k0 + kBK < K) {  // the next step's loads fly while this one computes
      ra.load(a, lda, k0 + kBK, n_rows);
#pragma unroll
      for (int b = 0; b < NB; ++b) rb[b].load(w[b], ldw, k0 + kBK);
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += kFr) {
        FragA fa;
        wmma::load_matrix_sync(fa, a_s + warp * kFr * kLdA + kk, kLdA);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int f = 0; f < kNFr; ++f) {
            FragB fb;
            wmma::load_matrix_sync(fb, b_s + b * kBK * kLdB + kk * kLdB + f * kFr, kLdB);
            wmma::mma_sync(acc[b][f], fa, fb, acc[b][f]);
          }
      }
    }
    __syncthreads();
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) moe_gate_up_kernel(
    const __nv_bfloat16* __restrict__ x,    // [S_pad, H]
    const int* __restrict__ tile_expert,    // [n_tiles]
    const int* __restrict__ tile_rows,      // [n_tiles]
    const WT* __restrict__ w_gate,          // [E, H, F]
    const WT* __restrict__ w_up,            // [E, H, F]
    const float* __restrict__ gate_scale,   // [E, F] (int8 weights) or null
    const float* __restrict__ up_scale,     // [E, F] or null
    __nv_bfloat16* __restrict__ act,        // [S_pad, F] scratch
    int H, int F) {
  const int t = blockIdx.x, n0 = blockIdx.y * kBN;
  const int n_rows = min(tile_rows[t], kBM);
  if (n_rows <= 0) return;  // dead tile: nothing reads its act rows
  const int e = tile_expert[t];
  __shared__ __align__(128) __nv_bfloat16 a_s[kBM * kLdA];
  __shared__ __align__(128) unsigned char buf[buf_bytes(2)];
  __shared__ float s_s[2][kBN];
  if (gate_scale != nullptr) {
    for (int c = threadIdx.x; c < kBN; c += kThreads) {
      s_s[0][c] = gate_scale[(size_t)e * F + n0 + c];
      s_s[1][c] = up_scale[(size_t)e * F + n0 + c];
    }
  }
  __syncthreads();
  const size_t wo = (size_t)e * H * F + n0;
  const WT* const w[2] = {w_gate + wo, w_up + wo};
  const float* const sc[2] = {s_s[0], s_s[1]};
  FragC acc[2][kNFr];
  mainloop<WT, 2>(x + (size_t)t * kBM * H, H, n_rows, w, F, H, sc, a_s,
                  reinterpret_cast<__nv_bfloat16*>(buf), acc);

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (warp * kFr >= n_rows) return;
  // act = round(round(silu(h)) * u) with h, u rounded first.  The gate and
  // up fragments have one type, so element i of each is the same (row,
  // column).  s * u of two bf16 values is exact in f32 before its rounding.
  float* c_s = reinterpret_cast<float*>(buf) + warp * kFr * kLdC;
#pragma unroll
  for (int f = 0; f < kNFr; ++f) {
#pragma unroll
    for (int i = 0; i < acc[0][f].num_elements; ++i) {
      const float h = round_bf16(acc[0][f].x[i]);
      const float u = round_bf16(acc[1][f].x[i]);
      const float s = round_bf16(h / (1.f + expf(-h)));
      acc[0][f].x[i] = round_bf16(s * u);
    }
    wmma::store_matrix_sync(c_s + f * kFr, acc[0][f], kLdC, wmma::mem_row_major);
  }
  __syncwarp();
  const int rows = min(kFr, n_rows - warp * kFr);
  for (int i = lane; i < rows * (kBN / 8); i += kWarp) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(c_s[r * kLdC + c + j]);
    *reinterpret_cast<uint4*>(act + ((size_t)t * kBM + warp * kFr + r) * F + n0 + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(
    const __nv_bfloat16* __restrict__ act,  // [S_pad, F]
    const int* __restrict__ tile_expert,    // [n_tiles]
    const int* __restrict__ tile_rows,      // [n_tiles]
    const WT* __restrict__ w_down,          // [E, F, H]
    const float* __restrict__ down_scale,   // [E, H] (int8 weights) or null
    __nv_bfloat16* __restrict__ out,        // [S_pad, H]
    int H, int F) {
  const int t = blockIdx.x, n0 = blockIdx.y * kBN;
  const int n_rows = max(0, min(tile_rows[t], kBM));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  __nv_bfloat16* o_tile = out + (size_t)t * kBM * H + n0;
  if (n_rows == 0) {  // dead tile: zeros, nothing read
    for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads)
      *reinterpret_cast<uint4*>(o_tile + (size_t)(i / (kBN / 8)) * H + (i % (kBN / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int e = tile_expert[t];
  __shared__ __align__(128) __nv_bfloat16 a_s[kBM * kLdA];
  __shared__ __align__(128) unsigned char buf[buf_bytes(1)];
  __shared__ float s_s[kBN];
  if (down_scale != nullptr)
    for (int c = threadIdx.x; c < kBN; c += kThreads) s_s[c] = down_scale[(size_t)e * H + n0 + c];
  __syncthreads();
  const WT* const w[1] = {w_down + (size_t)e * F * H + n0};
  const float* const sc[1] = {s_s};
  FragC acc[1][kNFr];
  mainloop<WT, 1>(act + (size_t)t * kBM * F, F, n_rows, w, H, F, sc, a_s,
                  reinterpret_cast<__nv_bfloat16*>(buf), acc);

  // Each warp writes its 16 rows: live rows rounded to bf16, dead ones zero.
  const int rows = max(0, min(kFr, n_rows - warp * kFr));
  float* c_s = reinterpret_cast<float*>(buf) + warp * kFr * kLdC;
  if (rows > 0) {
#pragma unroll
    for (int f = 0; f < kNFr; ++f)
      wmma::store_matrix_sync(c_s + f * kFr, acc[0][f], kLdC, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < kFr * (kBN / 8); i += kWarp) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __float2bfloat16(r < rows ? c_s[r * kLdC + c + j] : 0.f);
    *reinterpret_cast<uint4*>(o_tile + (size_t)(warp * kFr + r) * H + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename WT>
int launch(const void* x, const void* tile_expert, const void* tile_rows, const void* w_gate,
           const void* w_up, const void* w_down, const void* gate_scale, const void* up_scale,
           const void* down_scale, void* act, void* out, int n_tiles, int H, int F,
           cudaStream_t stream) {
  const int* te = static_cast<const int*>(tile_expert);
  const int* tr = static_cast<const int*>(tile_rows);
  moe_gate_up_kernel<WT><<<dim3(n_tiles, F / kBN), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), te, tr, static_cast<const WT*>(w_gate),
      static_cast<const WT*>(w_up), static_cast<const float*>(gate_scale),
      static_cast<const float*>(up_scale), static_cast<__nv_bfloat16*>(act), H, F);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moe_down_kernel<WT><<<dim3(n_tiles, H / kBN), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(act), te, tr, static_cast<const WT*>(w_down),
      static_cast<const float*>(down_scale), static_cast<__nv_bfloat16*>(out), H, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per tile and columns per CTA; the Python wrapper requires
// block_rows == rows and H, F multiples of cols.
extern "C" int dtt_moe_grouped_rows() { return kBM; }
extern "C" int dtt_moe_grouped_cols() { return kBN; }

// y[S_pad, H] = grouped SwiGLU of x[S_pad, H]; act[S_pad, F] is scratch.
// int8_weights selects int8 w_* with f32 scales ([E, F], [E, F], [E, H]);
// otherwise w_* are bf16 and the scales are null.
extern "C" int dtt_moe_grouped(const void* x, const void* tile_expert, const void* tile_rows,
                               const void* w_gate, const void* w_up, const void* w_down,
                               const void* gate_scale, const void* up_scale,
                               const void* down_scale, void* act, void* out, int n_tiles,
                               int H, int F, int int8_weights, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_weights)
    return launch<int8_t>(x, tile_expert, tile_rows, w_gate, w_up, w_down, gate_scale,
                          up_scale, down_scale, act, out, n_tiles, H, F, s);
  return launch<__nv_bfloat16>(x, tile_expert, tile_rows, w_gate, w_up, w_down, nullptr,
                               nullptr, nullptr, act, out, n_tiles, H, F, s);
}
