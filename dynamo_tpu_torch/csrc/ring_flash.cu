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
// arrives scaled in f32; bf16 K/V are the operands as they are; int8 K/V
// become round_bf16((float)q8 * scale); both products and the state are
// f32; soft_cap comes before the mask; masked scores are the finite -1e30,
// so a row that has seen no key yet adds exp(0) = 1 per masked key
// (padding rows: junk but finite) and exp(m - m_new) at m = m_new = -1e30
// is 1.
//
// A kv tile is skipped only when that cannot change the result: every key
// of the tile lies after every query of the CTA (the tile is wholly
// masked) AND every row of the CTA already has a real maximum, so that the
// tile would add exp(-1e30 - m) = 0 to l and acc and leave m as it is.  A
// launch whose whole block is masked that way returns before it touches
// acc.  The decision for tile j + 1 is taken when tile j has landed, from
// the rows' state after tile j - 1: a row that is real stays real, so
// this skips a subset of what the rule allows, never more.
//
// What bounds it on this card: operations.  A fold of Tq queries over Tk
// keys does 4 * Tq * Tk * Hq * D flops on (Tq * Hq + 2 * Tk * Hkv) * D
// operand values plus the state; at Tq = Tk = 128 that is already ~50
// flops a byte and it grows with the shard, so the floor is the unmasked
// flops over the tensor-core peak.  What the design does about it: one CTA
// (one warpgroup) per (q tile, kv head, batch row) holds 64 query rows
// (64 / G tokens x the G query heads of the kv head, which share every K/V
// load) and runs both products on the bf16 tensor cores through the tile
// of flash_tile.cuh: wgmma with f32 accumulation, K and V in a two-stage
// cp.async ring (tile j + 1 loads while tile j multiplies), P kept in
// registers.  q is f32 by contract, so Q and P are split into bf16 hi and
// lo halves and each product runs twice (kQLo, kSplit); K and V are exactly
// bf16, so the split misses the f32 products by ~2^-16 relative where one
// bf16 pass misses them by ~2^-9 (tests/test_torch_flash_split.py models
// both).  Where q * scale is already bf16 (a bf16 q and a power-of-two
// scale, as at D 64) Q's lo half is zero: the CTA sees that and runs a
// copy of its tile loop whose QK^T is one pass.
#include "flash_tile.cuh"

#include <type_traits>

namespace {

using namespace dtt::flash;

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

// Shared memory, from a 1024-byte aligned base: Q hi, Q lo, then two K/V
// stages (bf16 blocks: the tiles themselves; int8 blocks: one pair of
// bf16 tiles and two staging buffers), then the stages' key positions
// and a reduction scratch.
template <int D, bool kInt8>
struct Smem {
  using S = Stage<D, kInt8>;
  static constexpr uint32_t kQ = 2 * Tile<D>::kBytes;
  static constexpr uint32_t kStage = kInt8 ? S::kRaw + S::kScales : S::kTiles;
  static constexpr uint32_t kKv = kQ + (kInt8 ? S::kTiles : 0);  // first stage
  static constexpr uint32_t kPos = kKv + 2 * kStage;
  static constexpr uint32_t kRed = kPos + 2 * kKeys * 4;
  static constexpr size_t kBytes = kRed + 8 * 4 + 1024;  // + alignment slack
};

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) ring_fold_kernel(
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
  using L = Tile<D>;
  using M = Smem<D, kInt8>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv, TQ = kRows / G;
  const int lane = tid % dtt::kWarp, warp = tid / dtt::kWarp;
  const int tok0 = qt * TQ, c0 = frag_col();

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  int* kpos_s = reinterpret_cast<int*>(smem + M::kPos);  // [2][64]
  int* red_s = reinterpret_cast<int*>(smem + M::kRed);   // [8]

  // This thread's rows: m = frag_row() + 8 i is token tok0 + m / G, query
  // head h * G + m % G.
  int tok[2], head[2], qp[2];
  Rows<D> st;
  bool real = true;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = frag_row() + 8 * i;
    tok[i] = tok0 + m / G;
    head[i] = h * G + m % G;
    qp[i] = tok[i] < Tq ? q_pos[(size_t)b * Tq + tok[i]] : INT_MIN;
    st.m[i] = kNeg;
    st.l[i] = 0.f;
    if (tok[i] < Tq) {
      if (!first) {
        const size_t idx = ((size_t)b * Hq + head[i]) * Tq + tok[i];
        st.m[i] = m_st[idx];
        st.l[i] = c0 == 0 ? l_st[idx] : 0.f;  // the quad's parts sum to l
      }
      real = real && st.m[i] > kReal;
    }
  }
  // Smallest key position of the whole visiting block, largest query.
  int kmin = INT_MAX;
  for (int t = tid; t < Tk; t += kThreads) kmin = min(kmin, kv_pos[(size_t)b * Tk + t]);
  kmin = warp_min_int(kmin);
  const int qmx = warp_max_int(max(qp[0], qp[1]));
  if (lane == 0) {
    red_s[warp] = kmin;
    red_s[4 + warp] = qmx;
  }
  if (__syncthreads_and(real)) {
    kmin = min(min(red_s[0], red_s[1]), min(red_s[2], red_s[3]));
    // The whole block is masked for rows that all have a real max: the
    // fold changes nothing, and only the last hop still has to write.
    if (kmin > max(max(red_s[4], red_s[5]), max(red_s[6], red_s[7])) && !last) return;
  }
  const int qmax = max(max(red_s[4], red_s[5]), max(red_s[6], red_s[7]));

  // Q, split into bf16 halves, in the swizzled A tiles.
  bool lo_any = false;
  for (int i = tid; i < kRows * L::kChunks; i += kThreads) {
    const int m = i / L::kChunks, c = i % L::kChunks, t = tok0 + m / G;
    float x[8] = {};
    if (t < Tq) {
      const float4* src = reinterpret_cast<const float4*>(
          q + (((size_t)b * Tq + t) * Hq + h * G + m % G) * D + c * 8);
      const float4 a = src[0], e = src[1];
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = e.x, x[5] = e.y, x[6] = e.z, x[7] = e.w;
    }
    uint4 hi, lo;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&hi);
    __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hp[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
      const float2 f = __bfloat1622float2(hp[j]);
      const float d0 = x[2 * j] - f.x, d1 = x[2 * j + 1] - f.y;
      lp[j] = __floats2bfloat162_rn(d0, d1);
      lo_any = lo_any || d0 != 0.f || d1 != 0.f;
    }
    *reinterpret_cast<uint4*>(smem + L::offset(m, c)) = hi;
    *reinterpret_cast<uint4*>(smem + L::kBytes + L::offset(m, c)) = lo;
  }
  // The state's part of O.
  const size_t row_base[2] = {(((size_t)b * Tq + tok[0]) * Hq + head[0]) * D,
                              (((size_t)b * Tq + tok[1]) * Hq + head[1]) * D};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 a = make_float2(0.f, 0.f);
      if (!first && tok[i] < Tq)
        a = *reinterpret_cast<const float2*>(acc_st + row_base[i] + 8 * j + c0);
      st.o[4 * j + 2 * i] = a.x;
      st.o[4 * j + 2 * i + 1] = a.y;
    }
  fence_async_smem();

  const int n_tiles = (Tk + kKeys - 1) / kKeys;
  const uint32_t q_hi = base, q_lo = base + L::kBytes;
  auto stage_at = [&](int s) { return base + M::kKv + s * M::kStage; };
  // bf16 blocks multiply the stage itself; int8 blocks its widened copy.
  auto tile_at = [&](int s) { return kInt8 ? base + M::kQ : stage_at(s); };
  auto issue = [&](int j, int s) {
    const int t0 = j * kKeys;
    load_tile<D, kInt8>(
        k, v, ksc, vsc, Hkv, h,
        [&](int r) { return t0 + r < Tk ? b * Tk + t0 + r : -1; }, stage_at(s), stage_at(s));
  };
  // Key tid of tile j (threads past the tile's keys: INT_MAX), read a
  // tile before the decision that needs it.
  auto key_pos = [&](int j) {
    const int t = j * kKeys + tid;
    return tid < kKeys && t < Tk ? kv_pos[(size_t)b * Tk + t] : INT_MAX;
  };
  // A tile is live unless every row is real and every key (kp: this
  // thread's) is past qmax.  The barrier also publishes Q (the first
  // tile) and retires every thread's reads of the stage the next copy
  // overwrites.
  auto decide = [&](int kp, int s) {
    const bool skip = __syncthreads_and(real && kp > qmax);
    if (tid < kKeys) kpos_s[s * kKeys + tid] = kp;
    return !skip;
  };
  bool live = decide(key_pos(0), 0);
  if (live) issue(0, 0);
  int kp_next = key_pos(1);

  // The tile loop, with or without Q's lo pass: one copy of it each, chosen
  // once here, so that no branch lies inside a wgmma stage.
  auto fold = [&](auto q_lo_live) {
    constexpr bool kQLo = decltype(q_lo_live)::value;
    float s[32];
    uint32_t p_hi[4][4], p_lo[4][4];
    for (int j = 0; j < n_tiles; ++j) {
      const int cur = j & 1;
      if (live) {
        cp_async_wait<0>();
        fence_async_smem();
      }
      // One barrier a tile (decide's): tile j's copies are visible, every
      // thread is done with tile j - 1, and tile j + 1 is decided and
      // issued into the stage tile j - 1 used.
      bool live_next = false;
      if (j + 1 < n_tiles) {
        live_next = decide(kp_next, cur ^ 1);
        kp_next = key_pos(j + 2);
        if (live_next) issue(j + 1, cur ^ 1);
      } else if (live) {
        __syncthreads();
      }
      if (!live) {
        live = live_next;
        continue;
      }
      tile_scores<D, kQLo, kInt8>(s, q_hi, q_lo, tile_at(cur), smem + M::kKv + cur * M::kStage,
                                  smem + M::kQ);
      const int* kp = kpos_s + cur * kKeys;
      softmax_step<D, true>(s, st, qp, [&](int c) { return kp[c]; }, Tk - j * kKeys, soft_cap,
                            p_hi, p_lo);
      pv<D, true>(st, p_hi, p_lo, tile_at(cur) + L::kBytes);
      real = true;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tok[i] < Tq) real = real && st.m[i] > kReal;
      live = live_next;
    }
  };
  if (__syncthreads_or(lo_any))
    fold(std::true_type{});
  else
    fold(std::false_type{});

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(st.l[i]);
    if (tok[i] >= Tq) continue;
    if (last) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + row_base[i] + 8 * j + c0) =
            __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv, st.o[4 * j + 2 * i + 1] * inv);
    } else {
      if (c0 == 0) {
        const size_t idx = ((size_t)b * Hq + head[i]) * Tq + tok[i];
        m_st[idx] = st.m[i];
        l_st[idx] = l;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(acc_st + row_base[i] + 8 * j + c0) =
            make_float2(st.o[4 * j + 2 * i], st.o[4 * j + 2 * i + 1]);
    }
  }
}

template <int D, bool kInt8>
int launch(const void* q, const void* q_pos, const void* k, const void* v, const void* ksc,
           const void* vsc, const void* kv_pos, void* m, void* l, void* acc, void* out, int B,
           int Tq, int Tk, int Hq, int Hkv, float soft_cap, int first, int last,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<D, kInt8>::kBytes;
  static bool done[kMaxDevices] = {};
  const int e = allow_smem(reinterpret_cast<const void*>(ring_fold_kernel<D, kInt8>), smem, done);
  if (e) return e;
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
