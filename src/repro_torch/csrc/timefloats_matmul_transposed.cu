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
// Design. One block owns one (64 x 128) output tile: 64 rows of g and two
// weight planes. It walks n in stages of 32 (half a 64-chunk), in order.
// Each stage stages qg*sg (32 x 64) and qw*sw (32 x 128) in shared memory
// as f32, n-major, so the inner loop reads one float4 of g and two of w per
// n and does 32 FMAs per thread (4 rows x 8 columns). The products q*s are
// exact in f32 (a 5-bit significand times a power of two), so the only
// rounding is the f32 sum, as in the reference, which promises nothing
// about its order: the kernel is held to its plain version within
// N * 2^-24 * (|gd| @ |wd|^T), not bitwise. The next stage's global loads
// are issued into registers before the current stage's FMAs, so their
// latency hides behind the arithmetic.
//
// Bound. The work is 2*M*N*K flops on operands of 1.06 bytes per element.
// At the training shapes (M = 1024) it is far above the card's ridge: the
// least time is the flops at the bf16 tensor-core rate (the dequantized
// products are exact in bf16). This first version uses f32 FMAs on the
// CUDA cores, 1/15 of that rate at best; mma/wgmma on bf16 tiles is later
// work (ROADMAP). The tied head's dx is the slowest call: its output is
// only (M, 1024), so 128 blocks each walk all 2374 chunks of N = 151936.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;          // chunk length (crossbar height)
constexpr int kBM = 64;         // output rows per block
constexpr int kBK = 128;        // output columns per block: two planes
constexpr int kBN = 32;         // contraction steps per stage
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 8 outputs each

struct Stage {
  int4 g;        // 16 int8 of one g row (threads 0..127 only)
  float gs;      // that row's chunk scale
  int4 w;        // 16 int8 of one plane row
  float4 s[4];   // the 16 column scales of those w bytes
};

__device__ __forceinline__ void load_stage(Stage& st, int s, int tid,
                                           const int8_t* __restrict__ qg,
                                           const float* __restrict__ sg,
                                           const int8_t* __restrict__ qw,
                                           const float* __restrict__ sw,
                                           int M, int N, int m0, int k0) {
  const int d = s / (kB / kBN), nn0 = (s % (kB / kBN)) * kBN;
  if (tid < 2 * kBM) {
    const int m = tid % kBM, part = tid / kBM;
    st.g = *reinterpret_cast<const int4*>(
        qg + ((size_t)d * M + m0 + m) * kB + nn0 + part * 16);
    st.gs = sg[(size_t)d * M + m0 + m];
  }
  const int r = tid % kBK, part = tid / kBK;
  const int n = d * kB + nn0 + part * 16;
  st.w = *reinterpret_cast<const int4*>(qw + (size_t)(k0 + r) * N + n);
  const float4* sp = reinterpret_cast<const float4*>(
      sw + (size_t)((k0 + r) / kB) * N + n);
#pragma unroll
  for (int q = 0; q < 4; ++q) st.s[q] = sp[q];
}

__global__ void __launch_bounds__(kThreads)
tf_matmul_t_kernel(const int8_t* __restrict__ qg, const float* __restrict__ sg,
                   const int8_t* __restrict__ qw, const float* __restrict__ sw,
                   float* __restrict__ out, int D, int M, int C) {
  __shared__ __align__(16) float gsm[kBN][kBM];
  __shared__ __align__(16) float wsm[kBN][kBK];
  const int N = D * kB, K = C * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, k0 = blockIdx.x * kBK;
  const int stages = D * (kB / kBN);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  Stage st;
  load_stage(st, 0, tid, qg, sg, qw, sw, M, N, m0, k0);
  for (int s = 0; s < stages; ++s) {
    // Registers -> shared, as f32 values, n-major (conflict-free: the lanes
    // of a warp write consecutive rows m or r of one n).
    if (tid < 2 * kBM) {
      const int m = tid % kBM, part = tid / kBM;
      const int8_t* b = reinterpret_cast<const int8_t*>(&st.g);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        gsm[part * 16 + j][m] = __fmul_rn((float)b[j], st.gs);
    }
    {
      const int r = tid % kBK, part = tid / kBK;
      const int8_t* b = reinterpret_cast<const int8_t*>(&st.w);
      const float* sv = reinterpret_cast<const float*>(st.s);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        wsm[part * 16 + j][r] = __fmul_rn((float)b[j], sv[j]);
    }
    __syncthreads();
    if (s + 1 < stages)
      load_stage(st, s + 1, tid, qg, sg, qw, sw, M, N, m0, k0);
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&gsm[n][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&wsm[n][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&wsm[n][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = out + (size_t)(m0 + ty * 4 + i) * K + k0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// M must be a multiple of 64 and C of 2; qw's N must equal D*64. The Python
// wrapper pads to those and checks every shape before the call.
extern "C" int tf_matmul_t(const void* qg, const void* sg, const void* qw,
                           const void* sw, void* out, int D, int M, int C,
                           void* stream) {
  if (D <= 0 || M <= 0 || M % kBM != 0 || C <= 0 || C % (kBK / kB) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(C / (kBK / kB), M / kBM);
  tf_matmul_t_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qg), static_cast<const float*>(sg),
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      static_cast<float*>(out), D, M, C);
  return (int)cudaGetLastError();
}
