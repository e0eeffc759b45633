// Paged decode attention for Hopper (sm_90a), bf16 or int8 cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/paged_attention.py:
// paged_decode_attention (body _decode_kernel): one decode query per row
// against one layer's paged cache, streaming only the ceil(seq_len / bs)
// live pages with an f32 online softmax; optional attention soft cap.
// Arithmetic, as the TPU kernel's: q * scale rounded to bf16, bf16 K/V
// (int8 ones widened to round_bf16(q8 * scale)), scores, running max and
// sum in f32, the probabilities rounded to bf16 for P . V, which
// accumulates in f32.  Rows with seq_len == 0 read no block-table entry
// and write zeros.
//
// What bounds it on this card: bytes.  A step reads every live K/V byte of
// the batch once and does ~2 G flops per cached element (G = Hq / Hkv query
// heads per kv head), far under the H100's ~295 flops/byte ridge, so the
// floor is the K/V bytes over HBM bandwidth.
//
// What the design does about it:
//  - One CTA per (row, kv head), which loads each live page once for its
//    G query heads.  (A split over pages, for batches whose B x Hkv CTAs
//    under-fill the card, gained nothing at the served batch of 8: the
//    time there is latency, not parallelism.)
//  - A page ring.  64 keys make a tile (one page at block 64; any block
//    size works: each key row is its own 16-byte cp.async copy from its
//    slot); two tiles (three of int8) are in flight per CTA while one
//    computes, and the block-table entries of the next tile to copy are read
//    into registers a tile ahead (the first ones in a single round trip).
//  - One barrier a tile.  The kv head's G query heads are 16-row query
//    tiles (kQT of them, 1, 2 or 4, the last one zero-padded); the 4 warps
//    split (query tile, keys) so that each warp owns one query tile and
//    16 kQT keys of every tile, and keeps its own online-softmax state for
//    them: QK^T and P . V run on mma.sync (m16n8k16, bf16 in, f32
//    accumulators), P goes from the score accumulators to the A fragment
//    in registers, so no warp waits for another inside a tile, and every
//    warp holds the same registers whatever G is.  The warps of a query
//    tile merge their states at the end.  Past 64 query heads a kv head
//    (kQT 4), the grid adds a CTA for each further 64, which reads the
//    pages again.
//  - Any head dim that is a multiple of 16 from 16 to 256 divides into the
//    m16n8k16 tiles and the 16-byte copies; the build has 16, 32, 64, 80,
//    96, 128 and 256 (Phi-2's 80, Phi-3-mini's 96), whose padded row
//    strides (2 D + 16 bytes) keep ldmatrix free of bank conflicts.
//  - int8 pages land as int8 rows plus f32 scales; each warp widens 16
//    rows, without the int-to-float unit (q8 + 128 placed in the mantissa
//    of 2^23 by one byte permute): with one query tile the rows it reads
//    itself, so a __syncwarp covers it, with more a barrier.
#include "flash_tile.cuh"

namespace {

using dtt::flash::allow_smem;
using dtt::flash::cp_async16;
using dtt::flash::cp_async4;
using dtt::flash::cp_async_commit;
using dtt::flash::cp_async_wait;
using dtt::flash::kMaxDevices;
using dtt::flash::smem_addr;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;        // keys of a tile
constexpr int kSlice = kKeys / kWarps;  // keys of a tile a warp widens
constexpr int kRows = 16;        // query heads of a query tile: the mma's rows
constexpr int kMaxQT = 4;        // query tiles of a CTA
constexpr float kNeg = -1e30f;   // the mask fill, finite

template <int D, bool kInt8>
struct Smem {
  static constexpr int kLd = 2 * D + 16;             // bf16 row stride (bytes), padded
  // int8 stages are half the bytes, so the ring is one deeper.
  static constexpr int kStages = D >= 256 ? 2 : (kInt8 ? 4 : 3);
  static constexpr uint32_t kTiles = 2 * kKeys * kLd;  // K, V rows (bf16)
  static constexpr uint32_t kStage = kInt8 ? 2 * kKeys * D + 2 * kKeys * 4 : kTiles;
  static constexpr uint32_t kWide = kInt8 ? kTiles : 0;  // widened rows (int8)
  static constexpr uint32_t kRing = kStages * kStage + kWide;
  static constexpr uint32_t kMerge = kWarps * kRows * (D + 2) * 4;
  static constexpr size_t kBytes = (kRing > kMerge ? kRing : kMerge) + 128;
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hq, D]
  const void* kc;          // [S, F] bf16 or int8
  const void* vc;
  const float* ksc;        // [S, Hkv] f32 (int8 cache only)
  const float* vsc;
  const int* bt;           // [B, P]
  const int* seq_lens;     // [B]
  __nv_bfloat16* out;      // [B, Hq, D]
  int Hq, Hkv, P, bs;
  int n_qg;                // CTAs a (row, kv head): ceil(G / (16 kQT))
  int bs_log2;             // log2(bs) when bs is a power of two, else -1
  float scale, soft_cap;
};

// Page index and offset of key position pos: shifts for the engine's
// power-of-two block sizes, a division otherwise.
__device__ __forceinline__ int page_of(const Params& p, int pos) {
  return p.bs_log2 >= 0 ? pos >> p.bs_log2 : pos / p.bs;
}
__device__ __forceinline__ int offset_in_page(const Params& p, int pos) {
  return p.bs_log2 >= 0 ? pos & (p.bs - 1) : pos % p.bs;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The 16-byte chunks of one tile a thread copies, and the table entries
// (page ids, -1 past the row's last key) of their rows.
template <int D, bool kInt8>
struct Rows {
  static constexpr int kChunks = kInt8 ? D / 16 : D / 8;   // of one K or V row
  static constexpr int kIt = kInt8 ? 2 * kKeys * kChunks / kThreads : kKeys * kChunks / kThreads;
  int page[kIt];
  int page_s;  // int8: the row whose scale this thread copies (tid % 64)

  __device__ __forceinline__ static int row(int it) {
    const int c = threadIdx.x + it * kThreads;
    return kInt8 ? (c % (kKeys * kChunks)) / kChunks : c / kChunks;
  }
  __device__ __forceinline__ void read(const Params& p, int b, int pos0, int k_end) {
    const int* tab = p.bt + (size_t)b * p.P;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int pos = pos0 + row(it);
      page[it] = pos < k_end ? tab[page_of(p, pos)] : -1;
    }
    if constexpr (kInt8) {
      const int pos = pos0 + threadIdx.x % kKeys;
      page_s = pos < k_end ? tab[page_of(p, pos)] : -1;
    }
  }
  // Issue the copies of the tile at key pos0 into the stage at dst.
  __device__ __forceinline__ void issue(const Params& p, int h, int pos0, uint32_t dst) const {
    const int F = p.Hkv * D;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = row(it), pos = pos0 + r;
      const bool ok = page[it] >= 0;
      const size_t slot = ok ? (size_t)page[it] * p.bs + offset_in_page(p, pos) : 0;
      if constexpr (kInt8) {
        const int kv = c / (kKeys * kChunks), ch = c % kChunks;
        const int8_t* src = static_cast<const int8_t*>(kv ? p.vc : p.kc) + slot * F + h * D + ch * 16;
        cp_async16(dst + kv * kKeys * D + r * D + ch * 16, src, ok);
      } else {
        const int ch = c % kChunks;
        const size_t off = slot * F + h * D + ch * 8;
        const uint32_t d = dst + r * Smem<D, false>::kLd + ch * 16;
        cp_async16(d, static_cast<const __nv_bfloat16*>(p.kc) + off, ok);
        cp_async16(d + kKeys * Smem<D, false>::kLd, static_cast<const __nv_bfloat16*>(p.vc) + off,
                   ok);
      }
    }
    if constexpr (kInt8) {
      const int r = threadIdx.x % kKeys, pos = pos0 + r;
      const bool ok = page_s >= 0;
      const size_t slot = ok ? (size_t)page_s * p.bs + offset_in_page(p, pos) : 0;
      const float* sc = threadIdx.x < kKeys ? p.ksc : p.vsc;
      cp_async4(dst + 2 * kKeys * D + threadIdx.x * 4, sc + slot * p.Hkv + h, ok);
    }
  }
};

template <int D, bool kInt8, int kQT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const __grid_constant__ Params p) {
  using L = Smem<D, kInt8>;
  constexpr int kS = L::kStages;
  constexpr int kLd = L::kLd;
  constexpr int kWq = kWarps / kQT;      // warps of a query tile
  constexpr int kOwn = kKeys / kWq;      // keys of a tile a warp owns
  extern __shared__ __align__(128) uint8_t smem[];
  const int qg = blockIdx.x % p.n_qg, bh = blockIdx.x / p.n_qg;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int G = p.Hq / p.Hkv;
  // This CTA's query heads of kv head h: [g_first, g_first + Gc).
  const int g_first = qg * kRows * kQT, Gc = min(G - g_first, kRows * kQT);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = warp / kWq, key0 = kOwn * (warp % kWq);
  const int k_end = p.seq_lens[b];
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const uint32_t base = smem_addr(smem);

  // The query's A fragments (their loads fly with the table reads below):
  // rows g = 16 qt + lane / 4 (+ 8) of the CTA's heads (zero past Gc),
  // columns 16 kk + 2 (lane % 4) (+ 1, + 8, + 9), each q * scale rounded
  // to bf16.
  const int g0 = lane / 4, c0 = 2 * (lane % 4);
  uint32_t qf[D / 16][4];
  {
    const int gq = kRows * qt;
    const __nv_bfloat16* qrow = p.q + ((size_t)b * p.Hq + (size_t)h * G + g_first + gq) * D;
    const float scale = p.scale;
    const int Gq = Gc - gq;
    auto qs = [qrow, Gq, scale](int g, int d) {
      return g < Gq ? __bfloat162float(qrow[(size_t)g * D + d]) * scale : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d = 16 * kk + c0;
      qf[kk][0] = pack_bf16(qs(g0, d), qs(g0, d + 1));
      qf[kk][1] = pack_bf16(qs(g0 + 8, d), qs(g0 + 8, d + 1));
      qf[kk][2] = pack_bf16(qs(g0, d + 8), qs(g0, d + 9));
      qf[kk][3] = pack_bf16(qs(g0 + 8, d + 8), qs(g0 + 8, d + 9));
    }
  }

  Rows<D, kInt8> rows;
  {
    // The first kS tiles' table entries in one round trip, then their copies.
    Rows<D, kInt8> first[kS - 1];
#pragma unroll
    for (int j = 0; j < kS - 1; ++j)
      if (j < n_tiles) first[j].read(p, b, j * kKeys, k_end);
    if (kS - 1 < n_tiles) rows.read(p, b, (kS - 1) * kKeys, k_end);
#pragma unroll
    for (int j = 0; j < kS - 1; ++j) {
      if (j < n_tiles) first[j].issue(p, h, j * kKeys, base + j * L::kStage);
      cp_async_commit();
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[j][v] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  // ldmatrix row addresses of this lane inside a 16-key slice: K's x4
  // (keys 8 (lane / 16) + lane % 8, columns 8 (lane / 8 % 2)); V's
  // transposed x4 (keys 8 (lane / 8 % 2) + lane % 8, columns 8 (lane / 16)).
  const int kr = 8 * (lane / 16) + lane % 8, kc8 = 8 * (lane / 8 % 2);
  const int vr = 8 * (lane / 8 % 2) + lane % 8, vc8 = 8 * (lane / 16);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // tile i landed; tile i - 1's slot is free
    if (i + kS - 1 < n_tiles)
      rows.issue(p, h, (i + kS - 1) * kKeys, base + ((i + kS - 1) % kS) * L::kStage);
    cp_async_commit();
    if (i + kS < n_tiles) rows.read(p, b, (i + kS) * kKeys, k_end);
    const int pos0 = i * kKeys;
    uint32_t kt = base + (i % kS) * L::kStage;
    if constexpr (kInt8) {
      // Widen this warp's 16 K and V rows into the bf16 rows after the ring.
      const uint8_t* raw = smem + (i % kS) * L::kStage;
      const float* sc = reinterpret_cast<const float*>(raw + 2 * kKeys * D);
      uint8_t* wide = smem + kS * L::kStage;
      constexpr int kC = D / 16;
      for (int c = lane; c < 2 * kSlice * kC; c += 32) {
        const int kv = c / (kSlice * kC), r = kSlice * warp + (c / kC) % kSlice, ch = c % kC;
        const uint4 q = *reinterpret_cast<const uint4*>(raw + kv * kKeys * D + r * D + ch * 16);
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
        const float s = sc[kv * kKeys + r];
        uint4 w[2];
        uint32_t* w32 = reinterpret_cast<uint32_t*>(w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u = words[j] ^ 0x80808080u;
          float f[4];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            f[t] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + t)) - 8388736.f) * s;
          w32[2 * j] = pack_bf16(f[0], f[1]);
          w32[2 * j + 1] = pack_bf16(f[2], f[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>(wide + kv * kKeys * kLd + r * kLd + ch * 32);
        dst[0] = w[0];
        dst[1] = w[1];
      }
      // A warp reads its own widened rows only with one query tile.
      if constexpr (kQT == 1) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      kt = base + kS * L::kStage;
    }
    const uint32_t vt = kt + kKeys * kLd;

#pragma unroll
    for (int js = 0; js < kQT; ++js) {
      const int ks = key0 + kSlice * js;  // this slice's first key in the tile
      // S = Q . K^T over the slice's 16 keys: two n8 tiles.
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, kt + (ks + kr) * kLd + (16 * kk + kc8) * 2);
        mma16816(s[0], qf[kk], r[0], r[1]);
        mma16816(s[1], qf[kk], r[2], r[3]);
      }
      // Online softmax of rows g0 (v < 2) and g0 + 8 over the slice's keys.
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int pos = pos0 + ks + 8 * nt + c0 + (v & 1);
          float x = s[nt][v];
          if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
          x = pos < k_end ? x : kNeg;
          s[nt][v] = x;
          mx[v >> 1] = fmaxf(mx[v >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int pos = pos0 + ks + 8 * nt + c0 + (v & 1);
          const float e = pos < k_end ? __expf(s[nt][v] - m[v >> 1]) : 0.f;
          l[v >> 1] += e;  // the sum takes p in f32, P . V in bf16
          s[nt][v] = e;
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) o[j][v] *= alpha[v >> 1];
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // O += P . V: V's rows are the k dimension, two n8 column tiles a load.
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vt + (ks + vr) * kLd + (16 * dp + vc8) * 2);
        mma16816(o[2 * dp], pa, r[0], r[1]);
        mma16816(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the four warps' states now

  float* sm = reinterpret_cast<float*>(smem);  // [kWarps][kRows] running max
  float* sl = sm + kWarps * kRows;             // [kWarps][kRows] sum
  float* so = sl + kWarps * kRows;             // [kWarps][kRows][D] unnormalised output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = g0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (kRows * qt + g < Gc) {
      if (lane % 4 == 0) {
        sm[warp * kRows + g] = m[r];
        sl[warp * kRows + g] = lr;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float* dst = so + ((size_t)warp * kRows + g) * D + 8 * j + c0;
        dst[0] = o[j][2 * r];
        dst[1] = o[j][2 * r + 1];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < Gc * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    // The warps of g's query tile: kWq of them from warp w0.
    const int w0 = kWq * (g / kRows), gr = g % kRows;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWq; ++w) mm = fmaxf(mm, sm[(w0 + w) * kRows + gr]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWq; ++w) {
      const float f = __expf(sm[(w0 + w) * kRows + gr] - mm);
      ll += sl[(w0 + w) * kRows + gr] * f;
      oo += so[((size_t)(w0 + w) * kRows + gr) * D + d] * f;
    }
    p.out[((size_t)b * p.Hq + (size_t)h * G + g_first + g) * D + d] =
        __float2bfloat16(oo / fmaxf(ll, 1e-30f));
  }
}

template <int D, bool kInt8, int kQT>
int launch_q(const Params& p, int B, cudaStream_t stream) {
  using L = Smem<D, kInt8>;
  static bool done[kMaxDevices];
  const int e = allow_smem(reinterpret_cast<const void*>(paged_decode_kernel<D, kInt8, kQT>),
                           L::kBytes, done);
  if (e) return e;
  paged_decode_kernel<D, kInt8, kQT><<<B * p.Hkv * p.n_qg, kThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Query tiles: one up to 16 query heads a kv head, two up to 32, else
// four, with a CTA for each 64.
template <int D, bool kInt8>
int launch_d(Params p, int B, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const int qt = G <= kRows ? 1 : G <= 2 * kRows ? 2 : kMaxQT;
  p.n_qg = (G + kRows * qt - 1) / (kRows * qt);
  if (qt == 1) return launch_q<D, kInt8, 1>(p, B, stream);
  if (qt == 2) return launch_q<D, kInt8, 2>(p, B, stream);
  return launch_q<D, kInt8, kMaxQT>(p, B, stream);
}

template <bool kInt8>
int launch(Params p, int B, int D, cudaStream_t stream) {
  if (p.Hkv <= 0 || p.Hq % p.Hkv) return (int)cudaErrorInvalidValue;
  p.bs_log2 = -1;
  for (int k = 0; k < 31; ++k)
    if (p.bs == (1 << k)) p.bs_log2 = k;
  switch (D) {
    case 16: return launch_d<16, kInt8>(p, B, stream);
    case 32: return launch_d<32, kInt8>(p, B, stream);
    case 64: return launch_d<64, kInt8>(p, B, stream);
    case 80: return launch_d<80, kInt8>(p, B, stream);
    case 96: return launch_d<96, kInt8>(p, B, stream);
    case 128: return launch_d<128, kInt8>(p, B, stream);
    case 256: return launch_d<256, kInt8>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out[B, Hq, D] = decode attention.
extern "C" int dtt_paged_decode_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* seq_lens, void* out, int B, int Hq, int Hkv,
    int D, int P, int block_size, float scale, float soft_cap, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache, nullptr, nullptr,
           static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
           static_cast<__nv_bfloat16*>(out), Hq, Hkv, P, block_size, 1, -1, scale, soft_cap};
  return launch<false>(p, B, D, static_cast<cudaStream_t>(stream));
}

extern "C" int dtt_paged_decode_int8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* seq_lens, void* out,
    int B, int Hq, int Hkv, int D, int P, int block_size, float scale, float soft_cap,
    void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
           static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
           static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
           static_cast<__nv_bfloat16*>(out), Hq, Hkv, P, block_size, 1, -1, scale, soft_cap};
  return launch<true>(p, B, D, static_cast<cudaStream_t>(stream));
}
