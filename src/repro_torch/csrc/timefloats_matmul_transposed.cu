// K2: the TimeFloats transposed read dx = g @ W^T, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel_transposed` of
// src/repro/kernels/timefloats_matmul.py (called from
// `timefloats_matmul_transposed_quantized`). It computes
//
//     out(M, C*64) f32,  out[m, c*64+k] = sum_n (qg*sg)[m,n] * (qw*sw)[c,k,n]
//
// qg (D,M,64) int8 is the streamed gradient quantized along its own
// contraction dim N = D*64, sg (D,M) f32; qw (C,64,N) int8 and sw (C,N) f32
// are the weight planes exactly as the forward kernel K1 read them. Both
// operands are contiguous along the contraction axis n, so no transposed
// copy of W is ever made: the stored planes are read as they are
// (DESIGN.md §3). The read is ADC-free.
//
// Bound. 2*M*N*K flops on operands of 1.06 bytes per element: at the
// training shapes (M = 1024) far above the card's ridge, so the least time
// is the flops at the bf16 tensor-core rate. bf16 is exact here: every
// dequantized value is a code |q| <= 31 times a power-of-two scale, so a
// bf16 product is the f32 product and the only rounding left is the f32
// sum, as in the reference, which promises that sum but not its order. The
// kernel is held to its plain version within N * 2^-24 * (|gd| @ |wd|^T).
//
// Design. One block owns a 128 x 128 output tile (rows of g, two weight
// planes) and a contiguous run of whole 64-chunks of N; a grid of (C/2,
// M/128, splits). Warp 8 is the producer: per chunk it lands the tile's
// int8 codes and f32 scales in a ring of kStages shared-memory stages with
// asynchronous copies completing on an mbarrier: qg's 128 rows are one
// 8 KB run, sg one 512 B run and sw two 256 B runs, each a cp.async.bulk,
// and qw's 128 rows of 64 B one box of a 2-D tensor map (TMA); as 128
// separate 64-byte bulk copies they made the copy engine the bound. Warps
// 0-7, two consumer warpgroups, dequantize each arrived stage into bf16 A
// (qg*sg) and B (qw*sw) tiles in the 128-byte-swizzled K-major layout that
// the wgmma descriptors name, two codes at a time: a byte permute puts
// c + 64 under a bf16 exponent and one bf16x2 FMA removes the offset and
// applies the scales, exactly. They release the stage and issue four
// wgmma.m64n128k16 per chunk on their 64 rows, with f32 accumulators in
// registers. The bf16 tiles rotate over three buffers and each warpgroup
// keeps one wgmma group in flight (wait_group 1), so the next chunk's
// dequantize overlaps the tensor cores; one named barrier per chunk orders
// the two warpgroups (a buffer is rewritten only after both have waited
// out the group that read it). The dequantize is the largest part of a
// chunk's time, then the copies (17 KB a chunk per block, from L2): the
// kernel is well short of the tensor-core bound, and a register-A wgmma or
// a 128 x 256 tile would cut both per flop.
//
// Splits. At M = 1024 the tiles number only 64 (K = 1024), 128 (2048) or
// 192 (3072), so N is cut into `splits` contiguous runs of whole chunks,
// split s taking chunks [s*D/splits, (s+1)*D/splits) (`split_plan` in
// kernels/timefloats_matmul.py mirrors this; the wrapper picks the count).
// A tile's splits are one thread-block cluster: after the main loop each
// block but rank 0 leaves its partial tile in its shared memory, and rank 0
// adds them to its own through distributed shared memory in rank order and
// writes the tile. One launch, no workspace, no atomics: the same inputs
// give the same bits on every run.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 64;                 // chunk length (crossbar height)
constexpr int kBM = 128;               // output rows per block
constexpr int kBK = 128;               // output columns per block: 2 planes
constexpr int kStages = 4;             // int8 stages in flight
constexpr int kBufs = 3;               // bf16 tile buffers
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kMaxSplits = 8;          // a split's blocks form one cluster
constexpr int kThreads = kConsumers + 32;  // + the producer warp

constexpr int kQgBytes = kBM * kB;     // one stage: qg rows,
constexpr int kQwBytes = kBK * kB;     // qw rows,
constexpr int kSgBytes = kBM * 4;      // sg,
constexpr int kSwBytes = 2 * kB * 4;   // sw of both planes
constexpr int kStageBytes = kQgBytes + kQwBytes + kSgBytes + kSwBytes;
constexpr int kTileBytes = kBM * kB * 2;   // one bf16 tile (A or B)
constexpr int kBufBytes = 2 * kTileBytes;
constexpr int kSmemBytes =
    1024 + kBufs * kBufBytes + kStages * kStageBytes + 2 * kStages * 8;

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

// Global -> shared bulk copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A 2-D tensor-map copy of one box (TMA), completing on `bar`.
__device__ __forceinline__ void tma_g2s_2d(void* dst, const CUtensorMap* map,
                                           int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 tile with 128-byte
// swizzle: 128-byte rows, 8-row groups 1024 bytes apart (SBO); the leading
// offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d = A B (accumulate = 0) or d += A B: one m64n128k16 bf16 product with
// both operands read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Four int8 codes |c| <= 63 -> the four bytes c + 64: the XOR makes each
// byte c + 128 >= 64, so the word-wide subtract borrows across no byte.
__device__ __forceinline__ uint32_t plus64(uint32_t codes) {
  return (codes ^ 0x80808080u) - 0x40404040u;
}

// d = a * b + c on bf16 pairs, rounded once (exact where the result is).
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The top halves of two f32 values exact in bf16, as one bf16 pair.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// Dequantize the 16 codes of row r at columns [16q, 16q+16) into a bf16
// tile with the 128-byte swizzle (16-byte group g of row r sits at group
// g ^ (r % 8)). Each pair of biased bytes u = c + 64 < 128 under the bf16
// exponent byte 0x43 is the pair 192 + c exactly; one bf16 FMA with the
// pair's scales s and bias -192 s gives c * s exactly (s a power of two).
// kPerCol: a scale pair per column pair (B), else one pair for the row (A).
template <bool kPerCol>
__device__ __forceinline__ void put16(uint8_t* tile, int r, int q,
                                      int4 codes, const uint32_t* s2,
                                      const uint32_t* b2) {
  const uint32_t w[4] = {plus64(static_cast<uint32_t>(codes.x)),
                         plus64(static_cast<uint32_t>(codes.y)),
                         plus64(static_cast<uint32_t>(codes.z)),
                         plus64(static_cast<uint32_t>(codes.w))};
  uint32_t p[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t x = __byte_perm(w[e / 2], 0x43434343u,
                                   (e % 2) ? 0x4342u : 0x4140u);
    p[e] = fma_bf16x2(x, s2[kPerCol ? e : 0], b2[kPerCol ? e : 0]);
  }
  uint8_t* row = tile + r * 128;
  const int x = r & 7;
  *reinterpret_cast<uint4*>(row + (((2 * q) ^ x) * 16)) =
      make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ x) * 16)) =
      make_uint4(p[4], p[5], p[6], p[7]);
}

__global__ void __launch_bounds__(kThreads, 1)
tf_matmul_t_kernel(const int8_t* __restrict__ qg, const float* __restrict__ sg,
                   const __grid_constant__ CUtensorMap qw_map,
                   const float* __restrict__ sw, float* __restrict__ out,
                   int D, int M, int C) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned for the swizzled tiles; offset from smem_raw itself
  // so that the compiler keeps shared-memory (not generic) accesses.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bufs = smem;                          // kBufs x (A tile, B tile)
  uint8_t* stages = smem + kBufs * kBufBytes;    // kStages x int8 stage
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int N = D * kB, K = C * kB;
  const int c0 = blockIdx.x * (kBK / kB), k0 = blockIdx.x * kBK;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z, S = gridDim.z;
  const int d_lo = static_cast<int>(static_cast<long long>(split) * D / S);
  const int d_hi = static_cast<int>(static_cast<long long>(split + 1) * D / S);
  const int chunks = d_hi - d_lo;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // Producer: one stage per chunk, in order.
    for (int j = 0; j < chunks; ++j) {
      const int st = j % kStages;
      mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      uint8_t* sb = stages + st * kStageBytes;
      if (lane == 0) mbar_expect_tx(&full[st], kStageBytes);
      __syncwarp();
      const size_t d = static_cast<size_t>(d_lo + j);
      if (lane == 0)
        bulk_g2s(sb, qg + (d * M + m0) * kB, kQgBytes, &full[st]);
      if (lane == 1)
        bulk_g2s(sb + kQgBytes + kQwBytes, sg + d * M + m0, kSgBytes,
                 &full[st]);
      if (lane == 2 || lane == 3) {
        const int pl = lane - 2;
        bulk_g2s(sb + kQgBytes + kQwBytes + kSgBytes + pl * kB * 4,
                 sw + static_cast<size_t>(c0 + pl) * N + d * kB, kB * 4,
                 &full[st]);
      }
      if (lane == 4)
        tma_g2s_2d(sb + kQgBytes, &qw_map, static_cast<int>(d) * kB, c0 * kB,
                   &full[st]);
    }
    if (S > 1) {  // the consumers' two cluster barriers below
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  // Consumers. Warp w dequantizes rows 16w + lane/4 and 16w + 8 + lane/4 of
  // both tiles, columns [16q, 16q+16) with q = lane % 4 (16-byte reads, and
  // swizzled 16-byte writes free of bank conflicts); warpgroup wg then
  // multiplies its 64 rows of A by all 128 rows of B.
  const int wg = warp / 4;
  const int r1 = warp * 16 + lane / 4, r2 = r1 + 8, q = lane % 4;
  const int plane = r1 / kB;   // r1 and r2 lie in the same plane
  float acc[64];  // the first product overwrites it (accumulate = 0)

  for (int j = 0; j < chunks; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    const uint8_t* sb = stages + st * kStageBytes;
    uint8_t* ta = bufs + (j % kBufs) * kBufBytes;
    uint8_t* tb = ta + kTileBytes;

    const float* sgs = reinterpret_cast<const float*>(sb + kQgBytes + kQwBytes);
    const float g1 = sgs[r1], g2 = sgs[r2];
    const uint32_t gs1 = bf16_pair(g1, g1), gs2 = bf16_pair(g2, g2);
    const uint32_t gb1 = bf16_pair(-192.0f * g1, -192.0f * g1);
    const uint32_t gb2 = bf16_pair(-192.0f * g2, -192.0f * g2);
    put16<false>(ta, r1, q, *reinterpret_cast<const int4*>(sb + r1 * kB + q * 16),
                 &gs1, &gb1);
    put16<false>(ta, r2, q, *reinterpret_cast<const int4*>(sb + r2 * kB + q * 16),
                 &gs2, &gb2);

    const float4* sws = reinterpret_cast<const float4*>(
        sb + kQgBytes + kQwBytes + kSgBytes + plane * kB * 4 + q * 64);
    uint32_t ws2[8], wb2[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = sws[i];
      ws2[2 * i] = bf16_pair(v.x, v.y);
      ws2[2 * i + 1] = bf16_pair(v.z, v.w);
      wb2[2 * i] = bf16_pair(-192.0f * v.x, -192.0f * v.y);
      wb2[2 * i + 1] = bf16_pair(-192.0f * v.z, -192.0f * v.w);
    }
    const uint8_t* qws = sb + kQgBytes;
    put16<true>(tb, r1, q, *reinterpret_cast<const int4*>(qws + r1 * kB + q * 16),
                ws2, wb2);
    put16<true>(tb, r2, q, *reinterpret_cast<const int4*>(qws + r2 * kB + q * 16),
                ws2, wb2);

    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&empty[st]);
    asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");

    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t a0 = smem_u32(ta) + wg * 64 * 128, b0 = smem_u32(tb);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk)
      wgmma_m64n128k16(acc, sw128_desc(a0 + kk * 32), sw128_desc(b0 + kk * 32),
                       j > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  if (S > 1) {
    // The tile's splits are one cluster. Each block but rank 0 leaves its
    // partial in its own shared memory (over the bf16 tiles, once both
    // warpgroups are done with them), register i of consumer thread t at
    // float i*256 + t; rank 0 adds the partials to its own in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    float* part = reinterpret_cast<float*>(bufs);
    const int t = threadIdx.x;
    asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i * kConsumers + t] = acc[i];
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < S; ++r) {
        const float* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += other[i * kConsumers + t];
      }
    }
    cluster.sync();  // keep every partial until rank 0 has read it
    if (rank != 0) return;
  }

  // The accumulator fragment: register 4j + 2h + e holds row
  // 16*(warp%4) + lane/4 + 8h, column 8j + 2*(lane%4) + e of the warpgroup's
  // 64 x 128 tile.
  float* base = out;
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = k0 + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(base + static_cast<size_t>(row) * K + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(base + static_cast<size_t>(row + 8) * K + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// M must be a multiple of 128, C of 2, qw's N must equal D*64, every
// pointer 16-byte aligned, and 1 <= splits <= min(D, 8). The Python
// wrapper pads and checks all of it.
extern "C" int tf_matmul_t(const void* qg, const void* sg, const void* qw,
                           const void* sw, void* out, int D, int M, int C,
                           int splits, void* stream) {
  if (D <= 0 || M <= 0 || M % kBM != 0 || M / kBM > 65535 || C <= 0 ||
      C % (kBK / kB) != 0 || splits < 1 || splits > D || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        encode == nullptr) {
      encode = nullptr;
      return (int)cudaErrorSymbolNotFound;
    }
  }
  // qw as a (C*64, N) int8 matrix; one box is two planes' 128 rows by one
  // chunk's 64 columns, landed row after row (64 bytes each, no swizzle).
  CUtensorMap qw_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D) * kB,
                              static_cast<cuuint64_t>(C) * kB};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * kB};
  const cuuint32_t box[2] = {kB, kBK};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&qw_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tf_matmul_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / (kBK / kB), M / kBM, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tf_matmul_t_kernel,
                         static_cast<const int8_t*>(qg),
                         static_cast<const float*>(sg), qw_map,
                         static_cast<const float*>(sw),
                         static_cast<float*>(out), D, M, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
