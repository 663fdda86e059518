// K1: the TimeFloats block-aligned int8 MAC, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/timefloats_matmul.py (called from
// `timefloats_matmul_quantized`). It computes, bit for bit, the chunk-ordered
// spec `matmul_from_quantized` (core/timefloats.py):
//
//     acc = 0;  for c = 0..C-1:  acc = acc + f(int32(qx[c] @ qw[c])) * sx[c,:,None] * sw[c,None,:]
//
// qx (C,M,64) int8 in [-31,31], sx (C,M) f32, qw (C,64,N) int8, sw (C,N) f32;
// f is the identity or the fixed-range ADC round(p/fs*L)*(fs/L).
//
// What may run in parallel. Only the f32 additions must be in chunk order:
// a chunk's integer dot is exact (|p| <= 61504 < 2^24), the ADC rounds per
// chunk, and (pf*sx)*sw is exact for power-of-two scales. So any warp or
// block may compute a chunk's term t[c]; the owner of an output element
// adds the terms in order, starting from 0. The epilogue keeps the spec's
// roundings: __fmul_rn(__fmul_rn(pf, sx), sw), then __fadd_rn, never an
// FMA and never a pre-multiplied sx*sw (either changes bits at extreme
// scales).
//
// Tensor cores. Each chunk's dot is two mma.sync.m16n8k32 s8 x s8 -> s32
// steps. The weight is the A operand (its columns are the mma's rows) and
// the activations the B operand (tokens are its columns), so a decode
// tile of 8 tokens fills the n8 side. int8 mma takes both operands K-major;
// qx (C,M,64) is (B comes straight from shared memory by ldmatrix), qw
// (C,64,N) is not: each thread reads four k-rows of four columns of the
// staged tile and transposes the 4x4 bytes in registers (__byte_perm),
// reading the rows in a per-thread order that keeps every read free of
// bank conflicts under the TMA swizzle. The four columns become rows g,
// g+8 of two m16 tiles, so a thread's accumulators cover 4 consecutive
// columns. The int32 accumulator restarts every chunk at 0x4B400000 (the
// bits of 1.5*2^23): the result's bits, read as a float, are 1.5*2^23 + p
// exactly, and one exact subtraction gives p as a float without an
// int->float conversion.
//
// Staging. A producer warp lands each chunk's tiles in a ring of shared-
// memory stages with TMA (qw as a BN x 64 box, qx as a 64 x BM box, both
// swizzled; sx and sw as 1-D boxes), completing on mbarriers; the
// out-of-range part of an edge tile arrives as zeros and is never stored.
// Consumer warps, each owning 32 columns by 8*NT tokens, release a stage
// (one arrival a warp) as soon as they have read it, so the loads of later
// chunks overlap the products and the epilogue.
//
// Experts. An MoE layer multiplies E experts' planes at once (the
// reference's jax.vmap over `timefloats_matmul_quantized`): qx (E,C,M,64),
// sx (E,C,M), qw (E,C,64,N), sw (E,C,N), out (E,M,N). The tensor maps carry
// the expert as their outermost dim and the grid's x index folds it above
// the row tiles (x = e * row tiles + row tile), so each block computes one
// expert's tile exactly as the 2-D launch does; the 2-D launch is E = 1.
//
// Two regimes (the wrapper's `k1_plan` picks the tile and the split):
// - Decode and prefill (M <= 256): bytes-bound at decode, the weight's
//   planes streamed once, and too few output tiles to fill the card. From
//   32 chunks on, a tile's chunks are split over the S <= 8 blocks of one
//   thread-block cluster; block r takes chunks [r*C/S, (r+1)*C/S). Block 0
//   sums its own chunks in order in registers; every other block keeps its
//   chunks' exact terms in shared memory. Then each block owns a slice of
//   the tile's outputs and, over distributed shared memory, continues
//   block 0's sums with the terms of blocks 1..S-1 in chunk order. One
//   launch, no workspace, no atomics.
// - Training and large prefill (M >= 512): operations-bound; 64 x 128 or
//   64 x 64 tiles, unsplit (a split's terms would not fit), every block
//   walks all C chunks in order with its f32 sums in registers. Per
//   chunk and warp the latency of the chain (shared-memory reads, the
//   transposing permutes, two dependent mma, four f32 operations per
//   output) rather than any one unit's rate sets the pace: deeper rings,
//   larger tiles and narrower warp tiles measured no faster (PERF.md).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 64;                  // chunk length (crossbar height)
constexpr int kMagic = 0x4B400000;      // bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.0f;  // 1.5 * 2^23
constexpr int kMaxSplits = 8;           // a tile's splits form one cluster
constexpr int kSmemLimit = 232448;      // 227 KB a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int x, int y, int z, int w,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(z), "r"(w), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// d += A B on one m16n8k32 s8 tile; A from four packed registers (rows g
// and g+8, k 4t..4t+3 and 16+4t..), B from two (column g, the same k).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset of (row, byte) in a TMA tile of `rowbytes`-byte rows landed
// with the swizzle of the same span (32, 64 or 128 bytes): the 16-byte
// group index is XORed with the address bits above the span's 128-byte
// line, as CU_TENSOR_MAP_SWIZZLE_{32,64,128}B write it (the tile's base is
// aligned to the swizzle's period, 256, 512 or 1024 bytes).
template <int kRowBytes>
__device__ __forceinline__ int swz(int row, int byte) {
  constexpr int kMask = kRowBytes / 16 - 1;   // 1, 3 or 7
  const int a = row * kRowBytes + byte;
  return a ^ (((a >> 7) & kMask) << 4);
}

// One chunk's term from the biased int32 dot d: the spec's roundings,
// __fmul_rn(__fmul_rn(pf, sx), sw) with pf = p (or its ADC reading).
template <bool kAdc>
__device__ __forceinline__ float chunk_term(int d, float sxv, float swv,
                                            float fs, float levels,
                                            float step) {
  float pf = __fsub_rn(__int_as_float(d), kMagicF);
  if (kAdc) pf = __fmul_rn(rintf(__fmul_rn(__fdiv_rn(pf, fs), levels)), step);
  return __fmul_rn(__fmul_rn(pf, sxv), swv);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The tile configurations; kernels/timefloats_matmul.py's CONFIGS mirrors
// this table (index, NT, WM, WN, STAGES).
//   NT      n8 token tiles per consumer warp (8*NT tokens)
//   WM, WN  consumer warps along tokens and along columns (32 each)
//   STAGES  depth of the ring
template <int NT, int WM, int WN, int STAGES>
struct Cfg {
  static constexpr int kBM = 8 * NT * WM;          // tokens per tile
  static constexpr int kBN = 32 * WN;              // columns per tile
  static constexpr int kConsumers = 32 * WM * WN;  // consumer threads
  static constexpr int kThreads = kConsumers + 32; // + the producer warp
  // Blocks an SM should hold: caps the registers at 65536 / (kThreads *
  // kMinBlocks) a thread, so that small tiles keep 16 or more warps busy.
  static constexpr int kMinBlocks = kThreads <= 160 ? 4 : kThreads <= 288 ? 2 : 1;
  static constexpr int kQw = kB * kBN;             // bytes of one qw stage
  static constexpr int kQx = kBM * kB;             // one qx stage
  static constexpr int kSx = ((4 * kBM + 127) / 128) * 128;
  static constexpr int kSw = ((4 * kBN + 127) / 128) * 128;
  static constexpr int kTx = kQw + kQx + 4 * kBM + 4 * kBN;  // bytes landed
  static constexpr int kRing = STAGES * (kQw + kQx + kSx + kSw);
  static constexpr int kBars = 2 * STAGES * 8;     // full and empty barriers
  // Dynamic shared memory for a launch keeping `terms` chunks of terms.
  static int smem_bytes(int terms) {
    return 1024 + kRing + kBars + terms * kBM * kBN * 4;
  }
};

// The consumers' walk over chunks [c_lo, c_hi). Per chunk: wait for its
// stage; transpose the warp's A fragments and read its columns' scales;
// then, one n8 token tile at a time, read the B fragments (one ldmatrix)
// and the tokens' scales, run the two k32 products of both m16 tiles and
// the epilogue; release the stage after the last read. kKeep: leave each
// chunk's terms in `terms` (a split block past the first) instead of
// summing them into acc.
template <int NT, int WM, int WN, int STAGES, bool kAdc, bool kKeep>
__device__ __forceinline__ void walk(
    float (&acc)[2][NT][4], const uint8_t* qw_s, const uint8_t* qx_s,
    const float* sx_s, const float* sw_s, uint64_t* full, uint64_t* empty,
    float* terms, const int (&a_off)[4], uint32_t sel0, uint32_t sel1,
    int b_ld, int c_lo, int c_hi, int tb, int cb, int g, int t, float fs,
    float levels, float step) {
  using K = Cfg<NT, WM, WN, STAGES>;
  constexpr int BM = K::kBM, BN = K::kBN;
  for (int c = c_lo; c < c_hi; ++c) {
    const int j = c - c_lo, st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint8_t* qws = qw_s + st * K::kQw;
    // W[h][u]: column cb + 4g + u, k = 16h + 4t .. +3, packed. R[i] holds
    // row 16h + 4t + (i ^ x) (see a_off); the second permute level puts
    // the rows back in order with this thread's selectors.
    uint32_t W[4][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint8_t* rows = qws + 16 * h * BN;
      uint32_t R[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        R[i] = *reinterpret_cast<const uint32_t*>(rows + a_off[i]);
      const uint32_t xa = __byte_perm(R[0], R[2], 0x5140);  // bytes 0, 1
      const uint32_t ya = __byte_perm(R[1], R[3], 0x5140);
      const uint32_t xb = __byte_perm(R[0], R[2], 0x7362);  // bytes 2, 3
      const uint32_t yb = __byte_perm(R[1], R[3], 0x7362);
      W[h][0] = __byte_perm(xa, ya, sel0);
      W[h][1] = __byte_perm(xa, ya, sel1);
      W[h][2] = __byte_perm(xb, yb, sel0);
      W[h][3] = __byte_perm(xb, yb, sel1);
    }
    const float4 swv = *reinterpret_cast<const float4*>(
        reinterpret_cast<const uint8_t*>(sw_s) + st * K::kSw + 4 * (cb + 4 * g));
    const float sws[4] = {swv.x, swv.y, swv.z, swv.w};
    const uint32_t qxa = smem_u32(qx_s + st * K::kQx) + b_ld;
    const float* sxs = reinterpret_cast<const float*>(
        reinterpret_cast<const uint8_t*>(sx_s) + st * K::kSx);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // Bf[q]: token tb + 8nt + g, k = 16q + 4t .. +3.
      uint32_t Bf[4];
      ldsm_x4(Bf, qxa + 8 * nt * kB);
      const float2 sxv =
          *reinterpret_cast<const float2*>(sxs + tb + 8 * nt + 2 * t);
      if (nt == NT - 1) {  // the stage is read: one arrival per warp
        __syncwarp();
        if (g == 0 && t == 0) mbar_arrive(&empty[st]);
      }
#pragma unroll
      for (int jm = 0; jm < 2; ++jm) {
        int d[4] = {kMagic, kMagic, kMagic, kMagic};
        mma_s8(d, W[0][2 * jm], W[0][2 * jm + 1], W[1][2 * jm],
               W[1][2 * jm + 1], Bf[0], Bf[1]);
        mma_s8(d, W[2][2 * jm], W[2][2 * jm + 1], W[3][2 * jm],
               W[3][2 * jm + 1], Bf[2], Bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float tv = chunk_term<kAdc>(d[e], (e & 1) ? sxv.y : sxv.x,
                                            sws[2 * jm + (e >> 1)], fs,
                                            levels, step);
          acc[jm][nt][e] = kKeep ? tv : __fadd_rn(acc[jm][nt][e], tv);
        }
      }
    }
    if (kKeep) {
      // This chunk's terms, [token][column], for the owners to sum.
      float* tout = terms + static_cast<size_t>(j) * BM * BN;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(
              tout + (tb + 8 * nt + 2 * t + e) * BN + cb + 4 * g) =
              make_float4(acc[0][nt][e], acc[0][nt][e + 2], acc[1][nt][e],
                          acc[1][nt][e + 2]);
    }
  }
}

template <int NT, int WM, int WN, int STAGES, bool kAdc>
__global__ void __launch_bounds__(Cfg<NT, WM, WN, STAGES>::kThreads,
                                  Cfg<NT, WM, WN, STAGES>::kMinBlocks)
tf_mma_kernel(const __grid_constant__ CUtensorMap qx_map,
              const __grid_constant__ CUtensorMap qw_map,
              const __grid_constant__ CUtensorMap sx_map,
              const __grid_constant__ CUtensorMap sw_map,
              float* __restrict__ out, int C, int M, int N, float fs,
              float levels, float step) {
  using K = Cfg<NT, WM, WN, STAGES>;
  constexpr int BM = K::kBM, BN = K::kBN;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned for the swizzled tiles; offset from smem_raw itself
  // so that the compiler keeps shared-memory (not generic) accesses.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qw_s = smem;                              // STAGES x kQw
  uint8_t* qx_s = qw_s + STAGES * K::kQw;            // STAGES x kQx
  float* sx_s = reinterpret_cast<float*>(qx_s + STAGES * K::kQx);
  float* sw_s = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(sx_s) + STAGES * K::kSx);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sw_s) + STAGES * K::kSw);
  uint64_t* empty = full + STAGES;
  float* terms = reinterpret_cast<float*>(empty + STAGES);

  // Row tiles vary fastest, so the blocks running together share column
  // tiles and a weight tile is fetched from device memory about once. The
  // expert lies above the row tiles.
  const int m_tiles = (M + BM - 1) / BM;
  const int ex = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * BM, n0 = blockIdx.y * BN;
  out += static_cast<size_t>(ex) * M * N;
  const int S = gridDim.z, split = blockIdx.z;
  const int c_lo = static_cast<int>(static_cast<long long>(split) * C / S);
  const int c_hi = static_cast<int>(static_cast<long long>(split + 1) * C / S);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], K::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == K::kConsumers / 32) {
    // Producer: lane 0 lands one stage per chunk, in order.
    if (lane == 0) {
      prefetch_map(&qw_map);
      prefetch_map(&qx_map);
      prefetch_map(&sx_map);
      prefetch_map(&sw_map);
      for (int c = c_lo; c < c_hi; ++c) {
        const int j = c - c_lo, st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], K::kTx);
        tma_4d(qw_s + st * K::kQw, &qw_map, n0, 0, c, ex, &full[st]);
        tma_4d(qx_s + st * K::kQx, &qx_map, 0, m0, c, ex, &full[st]);
        tma_3d(reinterpret_cast<uint8_t*>(sx_s) + st * K::kSx, &sx_map, m0,
               c, ex, &full[st]);
        tma_3d(reinterpret_cast<uint8_t*>(sw_s) + st * K::kSw, &sw_map, n0,
               c, ex, &full[st]);
      }
    }
    if (S > 1) {  // the consumers' two cluster barriers below
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  // Consumers. Warp (wm, wn) owns tokens tb + [0, 8*NT) and columns
  // cb + [0, 32) of the tile; lane (g, t) = (lane / 4, lane % 4).
  const int wm = warp / WN, wn = warp % WN;
  const int tb = wm * 8 * NT, cb = wn * 32;
  const int g = lane / 4, t = lane % 4;
  // A: rows 16h + 4t + i (h = 0..3, i = 0..3), bytes cb + 4g .. +3. The
  // i-th read takes row 16h + 4t + (i ^ x), x = t ^ (t >> 1), so that the
  // four rows a warp reads at once fall in distinct banks under every
  // swizzle; the swizzle bits of these rows do not depend on h, so row
  // 16h + r lies 16h rows past row r. Row i is then R[i ^ x], byte u of
  // R[k] sits at byte (0, 4, 1, 5)[k] + 2u of the (xa, ya) pair, and sel0,
  // sel1 gather bytes 0 and 1 of rows 0..3 in order.
  const int x = t ^ (t >> 1);
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a_off[i] = swz<BN>(4 * t + (i ^ x), cb + 4 * g);
  const uint32_t sel0 = x == 0 ? 0x5140u : x == 1 ? 0x1504u
                        : x == 3 ? 0x0415u : 0x4051u;
  const uint32_t sel1 = sel0 + 0x2222u;
  // B: ldmatrix row address of this lane: matrix q = lane / 8 holds bytes
  // [16q, 16q+16) of tokens tb + 8nt + [0, 8); row lane % 8. The swizzle
  // bits of these rows do not depend on nt.
  const int b_ld = swz<kB>(tb + lane % 8, 16 * (lane / 8));

  // acc[jm][nt][e]: column cb + 4g + 2jm + (e >> 1), token tb + 8nt + 2t +
  // (e & 1).
  float acc[2][NT][4];
#pragma unroll
  for (int jm = 0; jm < 2; ++jm)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jm][nt][e] = 0.0f;

  if (S > 1 && split > 0) {
    walk<NT, WM, WN, STAGES, kAdc, true>(
        acc, qw_s, qx_s, sx_s, sw_s, full, empty, terms, a_off, sel0, sel1,
        b_ld, c_lo, c_hi, tb, cb, g, t, fs, levels, step);
  } else {
    walk<NT, WM, WN, STAGES, kAdc, false>(
        acc, qw_s, qx_s, sx_s, sw_s, full, empty, terms, a_off, sel0, sel1,
        b_ld, c_lo, c_hi, tb, cb, g, t, fs, levels, step);
  }

  if (S == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + tb + 8 * nt + 2 * t + e;
        const int col = n0 + cb + 4 * g;
        if (row < M && col < N)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col) =
              make_float4(acc[0][nt][e], acc[0][nt][e + 2], acc[1][nt][e],
                          acc[1][nt][e + 2]);
      }
    return;
  }

  // The split tile. Block 0 leaves its in-order sums at terms[0]; then each
  // block owns elements [r*E/S, (r+1)*E/S) of the tile ([token][column]) and
  // adds to block 0's sums the terms of blocks 1..S-1, chunk by chunk.
  cg::cluster_group cluster = cg::this_cluster();
  if (split == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(
            terms + (tb + 8 * nt + 2 * t + e) * BN + cb + 4 * g) =
            make_float4(acc[0][nt][e], acc[0][nt][e + 2], acc[1][nt][e],
                        acc[1][nt][e + 2]);
  }
  cluster.sync();
  constexpr int E = BM * BN;
  const int e_lo = split * E / S, e_hi = (split + 1) * E / S;
  const float* base0 = cluster.map_shared_rank(terms, 0);
  for (int e = e_lo + static_cast<int>(threadIdx.x); e < e_hi;
       e += K::kConsumers) {
    float s = base0[e];
    for (int r = 1; r < S; ++r) {
      const float* tr = cluster.map_shared_rank(terms, r);
      const int n_r = static_cast<int>(static_cast<long long>(r + 1) * C / S) -
                      static_cast<int>(static_cast<long long>(r) * C / S);
      int jj = 0;
      for (; jj + 8 <= n_r; jj += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = tr[(jj + u) * E + e];
#pragma unroll
        for (int u = 0; u < 8; ++u) s = __fadd_rn(s, v[u]);
      }
      for (; jj < n_r; ++jj) s = __fadd_rn(s, tr[jj * E + e]);
    }
    const int row = m0 + e / BN, col = n0 + e % BN;
    if (row < M && col < N) out[static_cast<size_t>(row) * N + col] = s;
  }
  cluster.sync();  // keep every block's terms until their owners have read
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  return encode;
}

bool encode(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type,
            int rank, const void* ptr, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, int WM, int WN, int STAGES, bool kAdc>
int launch(const void* qx, const void* sx, const void* qw, const void* sw,
           void* out, int E, int C, int M, int N, int splits, float fs,
           float levels, float step, cudaStream_t st) {
  using K = Cfg<NT, WM, WN, STAGES>;
  constexpr int BM = K::kBM, BN = K::kBN;
  const int chunks_max = splits > 1 ? (C + splits - 1) / splits : 0;
  const int smem = K::smem_bytes(chunks_max);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qx_map, qw_map, sx_map, sw_map;
  const cuuint64_t e64 = static_cast<cuuint64_t>(E);
  const cuuint64_t c64 = static_cast<cuuint64_t>(C);
  const cuuint64_t m64 = static_cast<cuuint64_t>(M);
  const cuuint64_t n64 = static_cast<cuuint64_t>(N);
  {  // qx as (64, M, C, E) bytes; one box is BM rows of one chunk
    const cuuint64_t dims[4] = {kB, m64, c64, e64};
    const cuuint64_t strides[3] = {kB, kB * m64, kB * m64 * c64};
    const cuuint32_t box[4] = {kB, BM, 1, 1};
    if (!encode(enc, &qx_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, qx, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  }
  {  // qw as (N, 64, C, E) bytes; one box is BN columns of one chunk
    const cuuint64_t dims[4] = {n64, kB, c64, e64};
    const cuuint64_t strides[3] = {n64, kB * n64, kB * n64 * c64};
    const cuuint32_t box[4] = {BN, kB, 1, 1};
    const CUtensorMapSwizzle sw = BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : BN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode(enc, &qw_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, qw, dims,
                strides, box, sw))
      return (int)cudaErrorInvalidValue;
  }
  {  // sx as (M, C, E) f32, sw as (N, C, E) f32
    const cuuint64_t dx[3] = {m64, c64, e64}, dw[3] = {n64, c64, e64};
    const cuuint64_t sxs[2] = {4 * m64, 4 * m64 * c64};
    const cuuint64_t sws[2] = {4 * n64, 4 * n64 * c64};
    const cuuint32_t bx[3] = {BM, 1, 1}, bw[3] = {BN, 1, 1};
    if (!encode(enc, &sx_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, sx, dx, sxs,
                bx, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode(enc, &sw_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, sw, dw, sws,
                bw, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = tf_mma_kernel<NT, WM, WN, STAGES, kAdc>;
  static int attr_bytes = 0;  // the largest dynamic size granted so far
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  cudaLaunchConfig_t cfg = {};
  const long long x_blocks = static_cast<long long>(E) * ((M + BM - 1) / BM);
  if (x_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(static_cast<unsigned>(x_blocks), (N + BN - 1) / BN,
                     splits);
  cfg.blockDim = dim3(K::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // an unsplit tile needs no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, qx_map, qw_map, sx_map, sw_map, static_cast<float*>(out),
      C, M, N, fs, levels, step);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// E experts (E = 1: one (C,M,64) x (C,64,N) product) of contiguous
// (E,C,M,64), (E,C,M), (E,C,64,N), (E,C,N) operands into (E,M,N). M must be
// a multiple of 8, N of 16, 1 <= splits <= min(C, 8), every pointer 16-byte
// aligned, `config` an index of the table below (mirrored by CONFIGS in
// kernels/timefloats_matmul.py) and the split's terms must fit in shared
// memory. The Python wrapper pads and checks all of it.
extern "C" int tf_matmul_experts(const void* qx, const void* sx,
                                 const void* qw, const void* sw, void* out,
                                 int E, int C, int M, int N, int config,
                                 int splits, int adc, float fs, float levels,
                                 float step, void* stream) {
  if (E <= 0 || C <= 0 || M <= 0 || M % 8 != 0 || N <= 0 || N % 16 != 0 ||
      splits < 1 || splits > kMaxSplits || splits > C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_CASE(id, NT, WM, WN, STAGES)                                    \
  case id:                                                                 \
    return adc ? launch<NT, WM, WN, STAGES, true>(                         \
                     qx, sx, qw, sw, out, E, C, M, N, splits, fs, levels,  \
                     step, st)                                             \
               : launch<NT, WM, WN, STAGES, false>(                        \
                     qx, sx, qw, sw, out, E, C, M, N, splits, fs, levels,  \
                     step, st);
  switch (config) {
    K1_CASE(0, 1, 1, 1, 16)   //   8 x  32: decode
    K1_CASE(1, 1, 1, 4, 6)    //   8 x 128
    K1_CASE(2, 4, 1, 1, 10)   //  32 x  32: prefill
    K1_CASE(3, 4, 1, 2, 8)    //  32 x  64
    K1_CASE(4, 4, 1, 4, 5)    //  32 x 128
    K1_CASE(5, 4, 2, 4, 4)    //  64 x 128: training
    K1_CASE(6, 4, 2, 2, 5)    //  64 x  64
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K1_CASE
}
