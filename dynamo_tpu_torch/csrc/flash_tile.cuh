// The flash-attention tile that the prefill-side attention kernels share on
// Hopper (sm_90a): ring_flash.cu (K4, the ring fold) and paged_prefill.cu
// (K2, packed ragged prefill over the paged cache).
//
// One warpgroup (128 threads, one CTA) owns 64 query rows: token-major x
// the G query heads of one kv head, so every K/V tile it loads serves all
// G heads.  A kv tile is 64 keys.  Per tile:
//   S = Q . K^T     wgmma m64n64k16, Q and K bf16 from shared memory;
//   soft cap, position mask, running max (reduced over the 4 lanes of a
//   quad that share a row) and running sum, all in registers;
//   O += P . V      wgmma m64nDk16, P from registers (the S accumulator's
//                   fragment is wgmma's register A fragment, so P never
//                   goes through shared memory), V from shared memory with
//                   the transposed-B flag (V is stored key-major).
// Both products accumulate in f32.  Split, each product runs twice, on
// the bf16 halves hi = bf16(x) and lo = bf16(x - hi) of its f32 operand
// (Q's halves staged in shared memory, kQLo; P's built in registers,
// kSplit): K and V are exactly bf16, so hi.K + lo.K misses the f32
// product q.K by about 2^-16 relative (the part of q that lo cannot hold)
// and the fold keeps the f32 arithmetic of its plain version within its
// limits, where one bf16 pass does not.
//
// Tiles in shared memory are the layouts wgmma's descriptors name: rows of
// min(2D, 128) bytes (a D of 128 is two column blocks of 64 elements), the
// 16-byte chunks of a row XOR-swizzled by the row (128-byte swizzle at
// D 64 / 128, 64-byte at D 32), every tile 1024-byte aligned.  Loads are
// 16-byte cp.async copies straight into that layout (zero-filled past the
// last key), issued one tile ahead into a ring of stages.  int8 K/V land
// as int8 rows plus their f32 scales in a staging ring and are widened to
// round_bf16(q8 * scale) into the bf16 tile just before the products.
#pragma once

#include "paged_common.cuh"

#include <limits.h>

namespace dtt {
namespace flash {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // M: query rows of a CTA (wgmma's m64)
constexpr int kKeys = 64;      // N: keys of a kv tile
constexpr float kNeg = -1e30f;  // the mask fill, finite
constexpr float kReal = -1e29f; // a running max above this has seen a key
constexpr int kMaxDevices = 64;
// CTAs an SM should hold (__launch_bounds__): four 64-row warpgroups at
// D <= 64 (registers capped at 128 a thread), two at D 128, where the
// shared memory of a third does not fit.
template <int D>
constexpr int kMinBlocks = D <= 64 ? 4 : 2;

// A swizzled 64-row bf16 tile of width D.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64, 128");
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;  // one column block's row
  static constexpr int kChunks = D / 8;                         // 16-byte chunks a row
  static constexpr uint32_t kBytes = kRows * D * 2;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: B128 / B64
  static constexpr uint32_t kSwizzle = kRowBytes / 16 - 1;
  // Byte offset of 16-byte chunk c of row r.
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    constexpr int per_block = kRowBytes / 16;
    const uint32_t off = (uint32_t)(c / per_block) * (kRows * kRowBytes) + r * kRowBytes +
                         (c % per_block) * 16;
    return off ^ (((off >> 7) & kSwizzle) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Descriptor of k-slice s (16 elements along D) of a K-major tile: Q as
// the A operand, K as the B operand of S = Q . K^T.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
  using L = Tile<D>;
  constexpr int per_block = L::kRowBytes / 32;
  return make_desc(tile + (s / per_block) * (kRows * L::kRowBytes) + (s % per_block) * 32, 16,
                   8 * L::kRowBytes, L::kLayout);
}

// Descriptor of k-slice s (keys 16 s .. 16 s + 15) of V, an MN-major B
// operand: 8-key groups SBO apart, column blocks LBO apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  using L = Tile<D>;
  return make_desc(tile + s * 16 * L::kRowBytes, kKeys * L::kRowBytes, 8 * L::kRowBytes,
                   L::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma's reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// a wgmma issue or wait (it does not see the asynchronous writes).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma (bf16 operands, f32 accumulator)

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers, B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32)
    wgmma_rs_n32(d, a, b);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n128(d, a, b);
}

// This thread's place in a 64 x N wgmma accumulator: element 4 j + v is
// row frag_row() + 8 (v / 2), column 8 j + frag_col() + v % 2.
__device__ __forceinline__ int frag_row() { return 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4; }
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x % 4); }

// Shared memory of one K/V stage: the bf16 tiles the products read, and
// for an int8 source the staging ring its copies land in.
template <int D, bool kInt8>
struct Stage {
  static constexpr uint32_t kTiles = 2 * Tile<D>::kBytes;          // K, V (bf16)
  static constexpr uint32_t kRaw = kInt8 ? 2 * kKeys * D : 0;       // K, V (int8)
  static constexpr uint32_t kScales = kInt8 ? 2 * kKeys * 4 : 0;    // K, V (f32)
};

// Issue the copies of one 64-key tile of kv head h of K and V into
// shared memory: bf16 rows into the swizzled tiles at k_dst / v_dst
// (v_dst = k_dst + Tile<D>::kBytes), or int8 rows ([64][D], row-major) and
// their scales into the staging buffer at raw_dst (K rows, V rows, K
// scales, V scales).  row(t) is key t's row of the [rows, Hkv, D] source,
// or -1 past the last key: such rows are zero-filled and read nothing.
// Commits one cp.async group.
template <int D, bool kInt8, class RowFn>
__device__ __forceinline__ void load_tile(const void* __restrict__ k, const void* __restrict__ v,
                                          const float* __restrict__ ksc,
                                          const float* __restrict__ vsc, int Hkv, int h,
                                          RowFn row, uint32_t k_dst, uint32_t raw_dst) {
  const int tid = threadIdx.x;
  if constexpr (!kInt8) {
    constexpr int kPer = kThreads / Tile<D>::kChunks;  // rows a pass
    const int c = tid % Tile<D>::kChunks;
#pragma unroll
    for (int r = tid / Tile<D>::kChunks; r < kKeys; r += kPer) {
      const int src = row(r);
      const size_t off = ((size_t)max(src, 0) * Hkv + h) * D + c * 8;
      const uint32_t dst = k_dst + Tile<D>::offset(r, c);
      cp_async16(dst, static_cast<const __nv_bfloat16*>(k) + off, src >= 0);
      cp_async16(dst + Tile<D>::kBytes, static_cast<const __nv_bfloat16*>(v) + off, src >= 0);
    }
  } else {
    constexpr int kChunks8 = D / 16;  // 16-byte chunks of an int8 row
    constexpr int kPer = kThreads / kChunks8;
    const int c = tid % kChunks8;
#pragma unroll
    for (int r = tid / kChunks8; r < kKeys; r += kPer) {
      const int src = row(r);
      const size_t off = ((size_t)max(src, 0) * Hkv + h) * D + c * 16;
      const uint32_t dst = raw_dst + r * D + c * 16;
      cp_async16(dst, static_cast<const int8_t*>(k) + off, src >= 0);
      cp_async16(dst + kKeys * D, static_cast<const int8_t*>(v) + off, src >= 0);
    }
    const int r = tid % kKeys;
    const int src = row(r);
    const float* sc = tid < kKeys ? ksc : vsc;
    cp_async4(raw_dst + 2 * kKeys * D + (tid / kKeys) * kKeys * 4 + r * 4,
              sc + (size_t)max(src, 0) * Hkv + h, src >= 0);
  }
  cp_async_commit();
}

// Widen the staged int8 K (kv = 0) or V (kv = 1) tile into its bf16 tile:
// round_bf16(q8 * scale), an f32 product rounded to nearest even, as
// kv_cache.dequantize_rows.  q8 reaches f32 exactly without the slow
// int-to-float unit: q8 + 128 is placed in the low mantissa bits of 2^23
// by one byte permute, and 2^23 + 128 is subtracted.
template <int D>
__device__ __forceinline__ void dequant_tile(const uint8_t* raw, uint8_t* tile, int kv) {
  constexpr int kChunks8 = D / 16;
  const float* scales = reinterpret_cast<const float*>(raw + 2 * kKeys * D) + kv * kKeys;
  raw += kv * kKeys * D;
  tile += kv * Tile<D>::kBytes;
  for (int i = threadIdx.x; i < kKeys * kChunks8; i += kThreads) {
    const int r = i / kChunks8, c = i % kChunks8;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + r * D + c * 16);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    const float s = scales[r];
    uint4 w[2];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = words[j] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f) * s;
      o[2 * j] = __floats2bfloat162_rn(f[0], f[1]);
      o[2 * j + 1] = __floats2bfloat162_rn(f[2], f[3]);
    }
    *reinterpret_cast<uint4*>(tile + Tile<D>::offset(r, 2 * c)) = w[0];
    *reinterpret_cast<uint4*>(tile + Tile<D>::offset(r, 2 * c + 1)) = w[1];
  }
}

// The running state of this thread's two rows and its part of O.
template <int D>
struct Rows {
  float o[D / 2];  // O fragment: rows frag_row() and frag_row() + 8
  float m[2];      // running max (the same in the 4 lanes of a quad)
  float l[2];      // this thread's part of the running sum (its 16 columns)
};

// Issue S = Q . K^T over one tile (scale_d = 0 on the first slice starts
// S at zero); with kQLo the lo half of Q adds a second pass.  kQLo is a
// template parameter, not a runtime flag: ptxas serializes every wgmma of
// a kernel (warning C7520) when a branch sits between the warpgroup
// arrive and the commit of one stage.  S is ready after wgmma_wait(); pin(s).
template <int D, bool kQLo>
__device__ __forceinline__ void scores_issue(float (&s)[32], uint32_t q_hi, uint32_t q_lo,
                                             uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wgmma_ss_n64(s, desc_k<D>(q_hi, j), desc_k<D>(k_tile, j), j > 0);
  if constexpr (kQLo) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(s, desc_k<D>(q_lo, j), desc_k<D>(k_tile, j), 1);
  }
  wgmma_commit();
}

// S of one tile: for a bf16 source the K/V stage is ready and S is simply
// computed; for an int8 one K is widened first, and V is widened while
// the tensor cores compute S.  raw: the stage's staging buffer (int8).
template <int D, bool kQLo, bool kInt8>
__device__ __forceinline__ void tile_scores(float (&s)[32], uint32_t q_hi, uint32_t q_lo,
                                            uint32_t k_tile, const uint8_t* raw,
                                            uint8_t* k_tile_ptr) {
  if constexpr (kInt8) {
    dequant_tile<D>(raw, k_tile_ptr, 0);
    fence_async_smem();
    __syncthreads();
  }
  scores_issue<D, kQLo>(s, q_hi, q_lo, k_tile);
  if constexpr (kInt8) {
    dequant_tile<D>(raw, k_tile_ptr, 1);
    fence_async_smem();
    __syncthreads();
  }
  wgmma_wait();
  pin(s);
}

// exp(x) as one multiply and the SFU's 2^x (relative error ~2^-22,
// under the bf16 halves' 2^-16).  x = s - m is formed first, so that a
// masked score against a row max that is still the mask fill gives
// exp(0) = 1 exactly, as the plain version's.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// One tile's online-softmax step on S: soft cap, then the mask
// key_pos(col) <= qp[row] (else the finite kNeg), the rows' new max over
// the quad, alpha = exp(m_old - m_new) applied to O and the sum, and
// p = exp(s - m_new) for columns < n_keys (0 past them: no key there).
// The sum takes p in f32; P leaves as wgmma A fragments, hi = bf16(p) and,
// with kSplit, lo = bf16(p - hi).
template <int D, bool kSplit, class KeyPos>
__device__ __forceinline__ void softmax_step(float (&s)[32], Rows<D>& st, const int (&qp)[2],
                                             KeyPos key_pos, int n_keys, float soft_cap,
                                             uint32_t (&p_hi)[4][4], uint32_t (&p_lo)[4][4]) {
  const int c0 = frag_col();
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float x = s[4 * j + v];
      if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
      x = key_pos(8 * j + c0 + (v & 1)) <= qp[v >> 1] ? x : kNeg;
      s[4 * j + v] = x;
      mx[v >> 1] = fmaxf(mx[v >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(st.m[i], mx[i]);
    alpha[i] = exp_sfu(st.m[i] - m_new);
    st.m[i] = m_new;
    st.l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float p =
          8 * j + c0 + (v & 1) < n_keys ? exp_sfu(s[4 * j + v] - st.m[v >> 1]) : 0.f;
      st.l[v >> 1] += p;
      s[4 * j + v] = p;
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) st.o[4 * j + v] *= alpha[v >> 1];
  // Slice kk of A (keys 16 kk .. 16 kk + 15) is S's elements 8 kk .. 8 kk + 7.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = s[8 * kk + 2 * t], b = s[8 * kk + 2 * t + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kk][t] = *reinterpret_cast<const uint32_t*>(&hi);
      if constexpr (kSplit) {
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, b - hf.y);
        p_lo[kk][t] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
}

// O += P . V over one tile (and P's lo half with kSplit).
template <int D, bool kSplit>
__device__ __forceinline__ void pv(Rows<D>& st, const uint32_t (&p_hi)[4][4],
                                   const uint32_t (&p_lo)[4][4], uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(st.o, p_hi[kk], desc_mn<D>(v_tile, kk));
  if constexpr (kSplit) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(st.o, p_lo[kk], desc_mn<D>(v_tile, kk));
  }
  wgmma_commit();
  wgmma_wait();
  pin(st.o);
}

// The sum of a row over its quad (each lane holds 16 of its 64 columns).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// Raise a kernel's dynamic shared-memory limit, once per device (`done`
// is the kernel's own flags).
inline int allow_smem(const void* kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

}  // namespace flash
}  // namespace dtt
