// Packed ragged paged prefill attention for Hopper (sm_90a), bf16 or int8
// cache.
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
// Arithmetic, as the TPU kernel's: q * scale rounded to bf16, bf16 K/V
// (int8 ones widened to round_bf16(q8 * scale)), scores and the running
// max and sum in f32, the probabilities rounded to bf16 for P . V, which
// accumulates in f32.  Those are exactly the operands of bf16 wgmma with
// f32 accumulation, so only the order of the sums differs.
//
// What bounds it on this card: operations, at long chunks.  A chunk of L
// queries over L keys does ~2 * L * Hq * D * L flops on 2 * L * F * 2
// bytes of K/V; past a few dozen tokens the flops per byte pass the H100's
// ~295 ridge, so the floor is the causal flops over the tensor-core peak.
//
// What the design does about it: one CTA (one warpgroup) per (segment,
// q tile, kv head) holds M = 64 query rows (TQ = 64 / G tokens x the G
// query heads of the kv head, which share every K/V load) and sweeps the
// keys its tile can see (the sweep stops at the tile's causal bound, as
// the TPU kernel's kv_hi) in 64-key tiles through the tensor-core tile of
// flash_tile.cuh: S = Q . K^T and O += P . V on wgmma, the online softmax
// and P in registers, no split (bf16 operands, as the reference).  Each
// key row of a tile is one 16-byte-chunked cp.async copy from its slot
// (block_tables[r, pos / bs] * bs + pos % bs, so any block size works; a
// 64-key tile is one page at block 64), issued one tile ahead into a
// two-stage ring, so tile j + 1 is in flight while tile j multiplies;
// keys past the causal bound are zero-filled and never read.
//
// int8 cache (the TPU kernel's quant=True body): the tile's int8 rows and
// their per-token f32 scales land in a staging ring and are widened into
// the same bf16 tile just before the products, so a cached prefix costs
// F + 4 * Hkv bytes per token and layer to read in place of 2 * F.
#include "flash_tile.cuh"

namespace {

using namespace dtt::flash;

// Shared memory, from a 1024-byte aligned base: the Q tile, then two K/V
// stages (bf16 cache: the tiles themselves; int8 cache: one pair of bf16
// tiles and two staging buffers), then two tiles' key slots and the
// owned flags of the zeroing pass.
template <int D, bool kInt8>
struct Smem {
  using S = Stage<D, kInt8>;
  static constexpr uint32_t kQ = Tile<D>::kBytes;
  static constexpr uint32_t kStage = kInt8 ? S::kRaw + S::kScales : S::kTiles;
  static constexpr uint32_t kKv = kQ + (kInt8 ? S::kTiles : 0);  // first stage
  static constexpr uint32_t kSlots = kKv + 2 * kStage;
  static constexpr uint32_t kOwned = kSlots + 2 * kKeys * 4;
  static constexpr size_t kBytes = kOwned + kRows * 4 + 1024;  // + alignment slack
};

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [T, Hq, D]
    const void* __restrict__ kc,           // [S, F] bf16 or int8
    const void* __restrict__ vc,           // [S, F]
    const float* __restrict__ ksc,         // [S, Hkv] f32 (int8 cache only)
    const float* __restrict__ vsc,
    const int* __restrict__ block_tables,  // [R, P]
    const int* __restrict__ seq_lens,      // [R] context after this chunk
    const int* __restrict__ q_starts,      // [R] packed row of first query
    const int* __restrict__ q_lens,        // [R] query rows (0 = pad segment)
    __nv_bfloat16* __restrict__ out,       // [T, Hq, D]
    int T, int R, int Hq, int Hkv, int P, int bs, float scale, float soft_cap) {
  using L = Tile<D>;
  using M = Smem<D, kInt8>;
  const int r = blockIdx.x, qt = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv, TQ = kRows / G;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  int* slot_s = reinterpret_cast<int*>(smem + M::kSlots);  // [2][64]

  // Rows no segment owns are zeroed by segment 0's CTAs: tile qt of the
  // whole packed axis, this kv head's G query heads.
  if (r == 0) {
    int* owned_s = reinterpret_cast<int*>(smem + M::kOwned);
    if (tid < TQ) {
      const int row = qt * TQ + tid;
      bool owned = row >= T;
      for (int s = 0; s < R; ++s) {
        const int ql = q_lens[s], qs = q_starts[s];
        owned |= (ql > 0 && row >= qs && row < qs + ql);
      }
      owned_s[tid] = owned;
    }
    __syncthreads();
    constexpr int kVec = 8;  // bf16 values a 16-byte store
    for (int i = tid; i < TQ * G * D / kVec; i += kThreads) {
      const int t = i / (G * D / kVec);
      if (!owned_s[t])
        *reinterpret_cast<uint4*>(out + ((size_t)(qt * TQ + t) * Hq + (size_t)h * G) * D +
                                  i % (G * D / kVec) * kVec) = make_uint4(0, 0, 0, 0);
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
  const int n_tiles = (kv_hi + kKeys - 1) / kKeys;
  const int* table = block_tables + (size_t)r * P;
  // Key tid's slot in tile j (-1 past the causal bound), read a tile
  // before its copy is issued.
  auto slot = [&](int j) {
    const int pos = j * kKeys + tid;
    return tid < kKeys && pos < kv_hi ? table[pos / bs] * bs + pos % bs : -1;
  };
  int slot_next = slot(0);

  // Q * scale, rounded to bf16, in the swizzled A tile; row m is token
  // m / G, query head h * G + m % G.
  for (int i = tid; i < kRows * L::kChunks; i += kThreads) {
    const int m = i / L::kChunks, c = i % L::kChunks, t = m / G;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (t < n_rows) {
      w = *reinterpret_cast<const uint4*>(
          q + ((size_t)(q_start + row0 + t) * Hq + (size_t)h * G + m % G) * D + c * 8);
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(smem + L::offset(m, c)) = w;
  }
  Rows<D> st;
  int qp[2];
  const int c0 = frag_col();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = (frag_row() + 8 * i) / G;
    qp[i] = t < n_rows ? chunk_start + row0 + t : INT_MIN;  // padding rows see no key
    st.m[i] = kNeg;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) st.o[j] = 0.f;
  fence_async_smem();

  auto stage_at = [&](int s) { return base + M::kKv + s * M::kStage; };
  auto tile_at = [&](int s) { return kInt8 ? base + M::kQ : stage_at(s); };
  auto issue = [&](int s) {
    const int* sl = slot_s + s * kKeys;
    load_tile<D, kInt8>(kc, vc, ksc, vsc, Hkv, h, [&](int k) { return sl[k]; }, stage_at(s),
                        stage_at(s));
  };
  if (tid < kKeys) slot_s[tid] = slot_next;
  slot_next = slot(1);
  __syncthreads();
  issue(0);
  if (tid < kKeys) slot_s[kKeys + tid] = slot_next;
  slot_next = slot(2);

  float s[32];
  uint32_t p[4][4];
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    cp_async_wait<0>();
    fence_async_smem();
    // Tile j's copies are visible, every thread is done with tile j - 1
    // (whose stage the next copy reuses), and tile j + 1's slots are in
    // place.
    __syncthreads();
    if (j + 1 < n_tiles) issue(cur ^ 1);
    tile_scores<D, false, kInt8>(s, base, 0, tile_at(cur),
                                 smem + M::kKv + cur * M::kStage, smem + M::kQ);
    const int t0 = j * kKeys;
    softmax_step<D, false>(
        s, st, qp, [&](int c) { return t0 + c < seq_len ? t0 + c : INT_MAX; }, kKeys, soft_cap,
        p, p);
    pv<D, false>(st, p, p, tile_at(cur) + L::kBytes);
    // Tile j + 2's slots take tile j's place, read since tile j began.
    if (tid < kKeys) slot_s[cur * kKeys + tid] = slot_next;
    slot_next = slot(j + 3);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(st.l[i]);
    const int m = frag_row() + 8 * i, t = m / G;
    if (t >= n_rows) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* dst =
        out + ((size_t)(q_start + row0 + t) * Hq + (size_t)h * G + m % G) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv, st.o[4 * j + 2 * i + 1] * inv);
  }
}

template <int D, bool kInt8>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* block_tables, const void* seq_lens,
           const void* q_starts, const void* q_lens, void* out, int T, int R, int Hq,
           int Hkv, int P, int block_size, float scale, float soft_cap, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, kInt8>::kBytes;
  static bool done[kMaxDevices] = {};
  const int e = allow_smem(reinterpret_cast<const void*>(paged_prefill_kernel<D, kInt8>), smem, done);
  if (e) return e;
  const int TQ = kRows / (Hq / Hkv);
  dim3 grid(R, (T + TQ - 1) / TQ, Hkv);
  paged_prefill_kernel<D, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),
      static_cast<__nv_bfloat16*>(out), T, R, Hq, Hkv, P, block_size, scale, soft_cap);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const void* block_tables, const void* seq_lens,
             const void* q_starts, const void* q_lens, void* out, int T, int R, int Hq,
             int Hkv, int D, int P, int block_size, float scale, float soft_cap,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32, kInt8>(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                               q_starts, q_lens, out, T, R, Hq, Hkv, P, block_size, scale,
                               soft_cap, s);
    case 64:
      return launch<64, kInt8>(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                               q_starts, q_lens, out, T, R, Hq, Hkv, P, block_size, scale,
                               soft_cap, s);
    case 128:
      return launch<128, kInt8>(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                                q_starts, q_lens, out, T, R, Hq, Hkv, P, block_size, scale,
                                soft_cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Query rows per CTA; the Python wrapper requires Hq / Hkv to divide it.
extern "C" int dtt_paged_prefill_rows() { return kRows; }

extern "C" int dtt_paged_prefill_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* block_tables,
    const void* seq_lens, const void* q_starts, const void* q_lens, void* out, int T,
    int R, int Hq, int Hkv, int D, int P, int block_size, float scale, float soft_cap,
    void* stream) {
  return dispatch<false>(q, k_cache, v_cache, nullptr, nullptr, block_tables, seq_lens,
                         q_starts, q_lens, out, T, R, Hq, Hkv, D, P, block_size, scale,
                         soft_cap, stream);
}

extern "C" int dtt_paged_prefill_int8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    const void* q_starts, const void* q_lens, void* out, int T, int R, int Hq, int Hkv,
    int D, int P, int block_size, float scale, float soft_cap, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens,
                        q_starts, q_lens, out, T, R, Hq, Hkv, D, P, block_size, scale,
                        soft_cap, stream);
}
