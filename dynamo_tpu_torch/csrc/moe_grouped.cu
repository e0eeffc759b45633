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
// span): rows at or past it read nothing and come back as exact zeros.
//
// What bounds it on this card: bytes, at the main path's shapes.  A group
// of at most a few hundred rows does 2 flops per weight value and row, under
// the H100's ~295 flops/byte ridge; so the floor is the live experts'
// weights over HBM bandwidth (Mixtral-8x7B: 2.82 GB a layer when all 8
// experts have rows, 0.84 ms; half that in int8).
//
// What the design does about it: every weight byte crosses HBM once per
// group of tiles, in a deep ring, into the tensor cores.
//  - Products on wgmma with the operands swapped: out^T = W^T . rows^T.
//    A weight tile (64 output columns x 64 deep, MN-major, the layout
//    flash_tile.cuh gives V) is the A operand from shared memory with the
//    transpose flag; the tile's rows (K-major, as Q) are the B operand, so
//    the rows are wgmma's N.  A group whose tiles hold at most 16 (32) live
//    rows runs n16 (n32): at the decode shape (8-64 tokens over 8 experts)
//    the padding rows cost no tensor-core work, no registers and no copies;
//    other groups run n64.  The choice is made once an item, into one of
//    three copies of the loop: a runtime branch inside a wgmma stage makes
//    ptxas serialize every wgmma of the kernel.
//  - An item is (group, columns) with two A tiles: gate and up at the same
//    64 columns, or 128 columns of down, so each row tile loaded serves
//    two weight tiles.
//  - A group is up to 4 consecutive tiles of one expert at prefill-size
//    calls (four warpgroups, a tile each, sharing each weight stage), so
//    a weight byte is read once per 256 rows; 1 tile (one warpgroup) at
//    decode-size calls.  The width is a pure function of the
//    call's shapes (the wrapper's moe_group_tiles), never of the routing.
//  - Weight streaming: a ring of 3-8 stages (as many as the CTA's shared
//    memory budget holds for the item's N) of 16-byte cp.async copies
//    written straight into wgmma's 128-byte swizzle, kept kS - 2 ahead; one
//    stage's products stay in flight while the next stage is waited for.
//  - A persistent grid, sized to the SMs by the occupancy of the kernel.
//    Each CTA walks tile_expert / tile_rows on the device (a warp ballot a
//    32 tiles) to find the groups, and takes every gridDim-th item in
//    group-major order: no host sync, no plan tensor.
//  - int8 weights land as int8 in the ring (half the bytes a stage) and
//    are widened once per item and stage into one of two sets of bf16
//    tiles while the tensor cores still read the other: q8 reaches f32
//    without the int-to-float unit (flash_tile.cuh's byte permute), times
//    its column's f32 scale, rounded to bf16 with the packed conversion:
//    element for element what dequantize_moe_params gives.
//  Two kernels, one per product: gate/up writes act [S_pad, F] bf16 (a
//  scratch the wrapper allocates; under 1% of the weight bytes), down
//  reads it.  The down kernel also zeroes every row that is not live
//  (padding rows and dead tiles), which no item reads.
#include "flash_tile.cuh"

namespace {

using namespace dtt::flash;
using dtt::round_bf16;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

constexpr int kBM = 64;                          // rows per tile (block_rows)
constexpr int kBN = 64;                          // columns of one A tile (wgmma M)
constexpr int kBK = 64;                          // contraction depth of a stage
constexpr int kA = 2;                            // A tiles an item: gate and up, or 2 of down
constexpr int kWgThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kWt = kBK * kBN * 2;          // one bf16 A tile, 8 KB

// Shared memory of an item whose warpgroups take N rows each: a ring of
// stages (the A tiles, raw for int8, then each warpgroup's rows), two sets
// of widened bf16 A tiles (int8: stage i is widened while the tensor cores
// still read stage i - 1's), the f32 column scales.  The ring holds as many
// stages as the CTA's budget allows for that N (3 to 8); the kernel's
// dynamic size is the largest over its N.
template <typename WT, int kWG, int N>
struct Smem {
  static constexpr bool kQ = sizeof(WT) == 1;
  static constexpr uint32_t kW = kBK * kBN * sizeof(WT);          // one raw A tile
  static constexpr uint32_t kRows = N * kBK * 2;                  // one warpgroup's rows
  static constexpr uint32_t kStage = kA * kW + kWG * kRows;       // multiples of 1024
  static constexpr uint32_t kWide = kQ ? 2 * kA * kWt : 0;
  static constexpr int kBudget = (kWG == 1 ? 108 : 200) * 1024 - (int)kWide;
  static constexpr int kFit = kBudget / (int)kStage;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 8 ? 8 : kFit);
  static constexpr uint32_t kScales = kStages * kStage + kWide;   // f32 [kA][kBN]
  static constexpr size_t kBytes = kScales + kA * kBN * 4;
};

template <typename WT, int kWG>
constexpr size_t kSmemBytes = 1024 + cmax(cmax(Smem<WT, kWG, 16>::kBytes,
                                               Smem<WT, kWG, 32>::kBytes),
                                          Smem<WT, kWG, 64>::kBytes);

// Byte offset of 16-byte chunk c (8 elements deep) of row n in an N-row,
// K-major B tile: N rows x 128 bytes, the chunks XOR-swizzled by the row
// (the 128-byte swizzle of flash_tile.cuh's tiles).
__device__ __forceinline__ uint32_t rows_offset(int n, int c) {
  const uint32_t off = n * 128 + c * 16;
  return off ^ (((off >> 7) & 7) << 4);
}

// Descriptor of k-slice s (16 deep) of that tile.
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int s) {
  return make_desc(tile + s * 32, 16, 1024, 1);
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N]: A (weights) MN-major from shared
// memory (transpose flag), B (rows) K-major from shared memory.
__device__ __forceinline__ void wgmma_tn(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tn(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tn(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

struct Args {
  const __nv_bfloat16* rows;  // [S_pad, K] the B operand's rows (x or act)
  const void* w[2];           // [E, K, ldw] weights (gate, up) or (down, null)
  const float* scale[2];      // [E, ldw] f32 column scales (int8) or null
  __nv_bfloat16* out;         // [S_pad, ldw] act or y
  const int* tile_expert;
  const int* tile_rows;
  int n_tiles, K, ldw;
};

// A tile m of an item: gate/up take matrix m at the item's columns; down
// takes its one matrix at columns 64 m further (an item of 128 columns, so
// each row of act is read half as often).
template <int NB>
__device__ __forceinline__ int a_matrix(int m) { return NB == 2 ? m : 0; }
template <int NB>
__device__ __forceinline__ int a_col(int m) { return NB == 2 ? 0 : kBN * m; }
template <int NB>
constexpr int kItemCols = NB == 2 ? kBN : kA * kBN;

// One item: the group's kWG tiles from row0 (rows[w] live rows each;
// warpgroup w takes tile w, N rows) of expert e, the item's columns from
// col0, the whole contraction depth K.
template <typename WT, int NB, int kWG, int N>
__device__ __forceinline__ void run_item(const Args& a, int e, int row0, const int (&rows)[kWG],
                                         int col0, uint8_t* smem) {
  using L = Smem<WT, kWG, N>;
  constexpr bool kQ = L::kQ;
  constexpr int kThreads = kWgThreads * kWG;
  constexpr int kS = L::kStages;
  const int tid = threadIdx.x, wg = tid / kWgThreads, ltid = tid % kWgThreads;
  const uint32_t base = smem_addr(smem);
  float* scales = reinterpret_cast<float*>(smem + L::kScales);
  const WT* wsrc[kA];
  bool wok[kA];  // a down item's second A tile may lie past the last column
#pragma unroll
  for (int m = 0; m < kA; ++m) {
    wok[m] = col0 + a_col<NB>(m) < a.ldw;
    wsrc[m] = static_cast<const WT*>(a.w[a_matrix<NB>(m)]) + (size_t)e * a.K * a.ldw + col0 +
              (wok[m] ? a_col<NB>(m) : 0);
  }
  const int nk = a.K / kBK;
  const int wrow0 = row0 + wg * kBM;

  // Copies of stage (depth step) i into ring slot i % kS; one group each.
  auto issue = [&](int i) {
    const uint32_t st = base + (i % kS) * L::kStage;
    const int k0 = i * kBK;
    constexpr int kWChunks = L::kW / 16;                       // of one A tile
    constexpr int kRowChunks = kBN * (int)sizeof(WT) / 16;     // of one weight row
#pragma unroll
    for (int m = 0; m < kA; ++m)
#pragma unroll 1
      for (int c = tid; c < kWChunks; c += kThreads) {
        const int r = c / kRowChunks, ch = c % kRowChunks;
        const WT* src = wsrc[m] + (size_t)(k0 + r) * a.ldw + ch * (16 / sizeof(WT));
        const uint32_t dst = st + m * L::kW +
                             (kQ ? (uint32_t)(r * kBN + ch * 16) : Tile<64>::offset(r, ch));
        cp_async16(dst, src, wok[m]);
      }
    // This warpgroup's rows: N of them, 8 16-byte chunks a row.
#pragma unroll 1
    for (int c = ltid; c < N * 8; c += kWgThreads) {
      const int n = c / 8, ch = c % 8;
      const bool live = n < rows[wg];
      const __nv_bfloat16* src = live ? a.rows + (size_t)(wrow0 + n) * a.K + k0 + ch * 8 : a.rows;
      cp_async16(st + kA * L::kW + wg * L::kRows + rows_offset(n, ch), src, live);
    }
  };

  float acc[kA][N / 2];
#pragma unroll
  for (int m = 0; m < kA; ++m)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[m][j] = 0.f;

  __syncthreads();  // the previous item is done with the ring and the scales
  if constexpr (kQ) {
    for (int i = tid; i < kA * kBN; i += kThreads) {
      const int m = i / kBN, col = col0 + a_col<NB>(m) + i % kBN;
      scales[i] = col < a.ldw ? a.scale[a_matrix<NB>(m)][(size_t)e * a.ldw + col] : 0.f;
    }
  }
  // kS - 2 stages ahead: stage i's copies land while the tensor cores still
  // run stage i - 1, whose slot (and widened tiles) stay untouched until
  // every warpgroup has waited for it.
#pragma unroll
  for (int i = 0; i < kS - 2; ++i) {
    if (i < nk) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kS - 3>();
    fence_async_smem();
    __syncthreads();  // stage i landed; stage i - 2's products are done
    if (i + kS - 2 < nk) issue(i + kS - 2);
    cp_async_commit();
    const uint32_t st = base + (i % kS) * L::kStage;
    uint32_t wt = st;
    if constexpr (kQ) {
      // Widen stage i's int8 weights into the bf16 tiles of parity i.
      const uint8_t* raw = smem + (i % kS) * L::kStage;
      uint8_t* wide = smem + kS * L::kStage + (i & 1) * kA * kWt;
      for (int c = tid; c < kA * kBK * 4; c += kThreads) {
        const int m = c / (kBK * 4), r = (c / 4) % kBK, ch = c % 4;
        const uint4 q = *reinterpret_cast<const uint4*>(raw + m * L::kW + r * kBN + ch * 16);
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
        const float4* sc4 = reinterpret_cast<const float4*>(scales + m * kBN + ch * 16);
        uint4 o[2];
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 sc = sc4[j];
          const uint32_t u = words[j] ^ 0x80808080u;
          float f[4];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f;
          o2[2 * j] = __floats2bfloat162_rn(f[0] * sc.x, f[1] * sc.y);
          o2[2 * j + 1] = __floats2bfloat162_rn(f[2] * sc.z, f[3] * sc.w);
        }
        uint8_t* dst = wide + m * kWt;
        *reinterpret_cast<uint4*>(dst + Tile<64>::offset(r, 2 * ch)) = o[0];
        *reinterpret_cast<uint4*>(dst + Tile<64>::offset(r, 2 * ch + 1)) = o[1];
      }
      fence_async_smem();
      __syncthreads();
      wt = base + kS * L::kStage + (i & 1) * kA * kWt;
    }
    const uint32_t rt = st + kA * L::kW + wg * L::kRows;
    constexpr uint32_t kWs = kQ ? kWt : L::kW;  // A tile stride where wgmma reads
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
#pragma unroll
      for (int m = 0; m < kA; ++m)
        wgmma_tn(acc[m], desc_mn<64>(wt + m * kWs, s), desc_rows(rt, s));
    wgmma_commit();
    wgmma_wait1();  // stage i - 1's products are done; stage i's may run on
  }
  wgmma_wait();
#pragma unroll
  for (int m = 0; m < kA; ++m) pin(acc[m]);
  cp_async_wait<0>();

  // Epilogue: element 4 j + v of an accumulator is column
  // 16 (warp) + lane / 4 + 8 (v / 2) of its A tile and row 8 j + 2 (lane % 4)
  // + v % 2 of this warpgroup's rows.  Only live rows are written.
  const int wr = 16 * (ltid / 32) + (ltid % 32) / 4, wc = 2 * (ltid % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = 8 * j + wc + (v & 1), col = col0 + wr + 8 * (v >> 1);
      if (n >= rows[wg]) continue;
      __nv_bfloat16* o = a.out + (size_t)(wrow0 + n) * a.ldw;
      if constexpr (NB == 2) {
        // act = round(round(silu(h)) * u), h and u rounded first; s * u of
        // two bf16 values is exact in f32 before its rounding.
        const float h = round_bf16(acc[0][4 * j + v]);
        const float u = round_bf16(acc[1][4 * j + v]);
        const float s = round_bf16(h / (1.f + expf(-h)));
        o[col] = __float2bfloat16(s * u);
      } else {
#pragma unroll
        for (int m = 0; m < kA; ++m)
          if (wok[m]) o[col + a_col<NB>(m)] = __float2bfloat16(acc[m][4 * j + v]);
      }
    }
}

// Walk the tiles for groups: runs of consecutive live tiles of one expert,
// cut every kWG tiles from the run's first.  Every warp computes the
// same ballots, so control flow stays uniform over the CTA.  Items are
// (group, kItemCols columns) in group-major order; this CTA takes every
// gridDim.x-th, in the smallest loop copy whose N holds every warpgroup's
// live rows.
template <typename WT, int NB, int kWG>
__device__ __forceinline__ void run_groups(const Args& a, uint8_t* smem) {
  const int lane = threadIdx.x % 32;
  const int ncb = (a.ldw + kItemCols<NB> - 1) / kItemCols<NB>;
  int run_first = 0, prev_e = -1, prev_r = 0;
  long long g = 0;
  for (int base = 0; base < a.n_tiles; base += 32) {
    const int t = base + lane;
    const int e = t < a.n_tiles ? a.tile_expert[t] : -1;
    const int r = t < a.n_tiles ? min(a.tile_rows[t], kBM) : 0;
    int e_up = __shfl_up_sync(kFull, e, 1), r_up = __shfl_up_sync(kFull, r, 1);
    if (lane == 0) {
      e_up = prev_e;
      r_up = prev_r;
    }
    const bool live = r > 0;
    const unsigned starts = __ballot_sync(kFull, live && (r_up <= 0 || e_up != e));
    const unsigned upto = starts & (kFull >> (31 - lane));
    const int first = upto ? base + 31 - __clz(upto) : run_first;
    const unsigned leads = __ballot_sync(kFull, live && (t - first) % kWG == 0);
    run_first = __shfl_sync(kFull, first, 31);
    prev_e = __shfl_sync(kFull, e, 31);
    prev_r = __shfl_sync(kFull, r, 31);
    for (unsigned m = leads; m; m &= m - 1, ++g) {
      const int lead = base + __ffs(m) - 1;
      const long long item0 = g * ncb;
      int c = (int)(((long long)blockIdx.x - item0 % gridDim.x + gridDim.x) % gridDim.x);
      if (c >= ncb) continue;
      const int ex = a.tile_expert[lead];
      int rows[kWG];
      int widest = 0;  // the most live rows of one of the group's tiles
      bool same = true;
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
        const int tw = lead + w;
        same = same && tw < a.n_tiles && a.tile_expert[tw] == ex && a.tile_rows[tw] > 0;
        rows[w] = same ? min(a.tile_rows[tw], kBM) : 0;
        widest = max(widest, rows[w]);
      }
      for (; c < ncb; c += gridDim.x) {
        const int col0 = c * kItemCols<NB>;
        if (widest <= 16)
          run_item<WT, NB, kWG, 16>(a, ex, lead * kBM, rows, col0, smem);
        else if (widest <= 32)
          run_item<WT, NB, kWG, 32>(a, ex, lead * kBM, rows, col0, smem);
        else
          run_item<WT, NB, kWG, 64>(a, ex, lead * kBM, rows, col0, smem);
      }
    }
  }
}

template <typename WT, int NB, int kWG>
__global__ void __launch_bounds__(kWgThreads * kWG, 1)
    moe_grouped_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  if constexpr (NB == 1) {
    // Zero the rows no item writes: padding rows of live tiles and every
    // row of a dead tile, a warp a row.
    const int warps = gridDim.x * (blockDim.x / 32), lane = threadIdx.x % 32;
    for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < a.n_tiles * kBM;
         row += warps) {
      if (row % kBM < min(a.tile_rows[row / kBM], kBM)) continue;
      uint4* dst = reinterpret_cast<uint4*>(a.out + (size_t)row * a.ldw);
      for (int c = lane; c < a.ldw / 8; c += 32) dst[c] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  run_groups<WT, NB, kWG>(a, smem);
}

// Persistent grid: the SMs times the CTAs an SM holds, at most one a
// possible item.  Attributes and occupancy are read once per device.
template <typename WT, int NB, int kWG>
int launch_one(const Args& a, cudaStream_t stream) {
  constexpr size_t kBytes = kSmemBytes<WT, kWG>;
  static bool done[kMaxDevices];
  static int grid_of[kMaxDevices];
  const void* fn = reinterpret_cast<const void*>(moe_grouped_kernel<WT, NB, kWG>);
  int e = allow_smem(fn, kBytes, done);
  if (e) return e;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int grid = dev < kMaxDevices ? grid_of[dev] : 0;
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, moe_grouped_kernel<WT, NB, kWG>, kWgThreads * kWG, kBytes);
    if (err != cudaSuccess) return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) grid_of[dev] = grid;
  }
  const long long items =
      (long long)a.n_tiles * ((a.ldw + kItemCols<NB> - 1) / kItemCols<NB>);
  if (items < grid) grid = (int)items;
  if (a.n_tiles > 0)
    moe_grouped_kernel<WT, NB, kWG><<<grid, kWgThreads * kWG, kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// kWG warpgroups, a tile each: 1 at decode-size calls, 4 at prefill-size
// ones.
template <typename WT, int kWG>
int launch(const void* x, const int* te, const int* tr, const void* w_gate, const void* w_up,
           const void* w_down, const float* gate_scale, const float* up_scale,
           const float* down_scale, void* act, void* out, int n_tiles, int H, int F,
           cudaStream_t stream) {
  Args g{static_cast<const __nv_bfloat16*>(x), {w_gate, w_up}, {gate_scale, up_scale},
         static_cast<__nv_bfloat16*>(act), te, tr, n_tiles, H, F};
  int e = launch_one<WT, 2, kWG>(g, stream);
  if (e) return e;
  Args d{static_cast<const __nv_bfloat16*>(act), {w_down, nullptr}, {down_scale, nullptr},
         static_cast<__nv_bfloat16*>(out), te, tr, n_tiles, F, H};
  return launch_one<WT, 1, kWG>(d, stream);
}

template <typename WT>
int launch_wt(int group_tiles, const void* x, const int* te, const int* tr, const void* w_gate,
              const void* w_up, const void* w_down, const float* gs, const float* us,
              const float* ds, void* act, void* out, int n_tiles, int H, int F,
              cudaStream_t stream) {
  if (group_tiles == 1)
    return launch<WT, 1>(x, te, tr, w_gate, w_up, w_down, gs, us, ds, act, out, n_tiles, H,
                            F, stream);
  if (group_tiles == 4)
    return launch<WT, 4>(x, te, tr, w_gate, w_up, w_down, gs, us, ds, act, out, n_tiles, H,
                            F, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rows per tile and columns per item; the Python wrapper requires
// block_rows == rows and H, F multiples of cols.
extern "C" int dtt_moe_grouped_rows() { return kBM; }
extern "C" int dtt_moe_grouped_cols() { return kBN; }

// y[S_pad, H] = grouped SwiGLU of x[S_pad, H]; act[S_pad, F] is scratch.
// int8_weights selects int8 w_* with f32 scales ([E, F], [E, F], [E, H]);
// otherwise w_* are bf16 and the scales are null.  group_tiles (1 or 4)
// is the most tiles of one expert a CTA takes at once.  n_tiles 0
// launches nothing.
extern "C" int dtt_moe_grouped(const void* x, const void* tile_expert, const void* tile_rows,
                               const void* w_gate, const void* w_up, const void* w_down,
                               const void* gate_scale, const void* up_scale,
                               const void* down_scale, void* act, void* out, int n_tiles,
                               int H, int F, int int8_weights, int group_tiles,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  const int* tr = static_cast<const int*>(tile_rows);
  if (int8_weights)
    return launch_wt<int8_t>(group_tiles, x, te, tr, w_gate, w_up, w_down,
                             static_cast<const float*>(gate_scale),
                             static_cast<const float*>(up_scale),
                             static_cast<const float*>(down_scale), act, out, n_tiles, H, F, s);
  return launch_wt<__nv_bfloat16>(group_tiles, x, te, tr, w_gate, w_up, w_down, nullptr, nullptr,
                                  nullptr, act, out, n_tiles, H, F, s);
}
