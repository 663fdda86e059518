// K1: the TimeFloats block-aligned int8 MAC, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/timefloats_matmul.py (called from
// `timefloats_matmul_quantized`). It computes, bit for bit, the chunk-ordered
// spec `matmul_from_quantized` (core/timefloats.py):
//
//     out(M,N) f32 = sum_c f(int32(qx[c] @ qw[c])) * sx[c,:,None] * sw[c,None,:]
//
// qx (C,M,64) int8 in [-31,31], sx (C,M) f32, qw (C,64,N) int8, sw (C,N) f32;
// f is the identity or the fixed-range ADC round(p/fs*L)*(fs/L).
//
// Design. One block owns one (BM x 128) output tile and walks the chunks
// c = 0..C-1 in order (no split-K: the f32 sum must be taken chunk by chunk,
// in order, to be bitwise). Per chunk it stages qx[c] (BM x 64) and qw[c]
// (64 x 128) in shared memory; qw is K-major along rows, so the staging
// transposes each 4x4 byte block in registers (__byte_perm) to pack four
// consecutive k of one column into one 32-bit word for __dp4a. The integer
// dot of a chunk is exact; the epilogue then applies
// acc = acc + (p*sx)*sw with __fmul_rn/__fadd_rn, so the compiler can never
// contract it into an FMA. p*sx*sw is exact (|p| <= 61504 < 2^24, scales are
// powers of two), so only the add rounds, as in the spec.
//
// Bound. At decode (M = 4 slots) the kernel must read the int8 planes and
// f32 scales of the weight, about 1.06*K*N bytes: for the tied head
// (K=1024, N=151936) 165 MB, about 49 us at 3.35 TB/s. The operations
// (2*M*K*N int8) are far below the tensor-core line there. This first
// version uses dp4a and a plain load-then-compute loop; wgmma, TMA and a
// multi-stage pipeline are later work (ROADMAP).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;          // crossbar height: bytes of one chunk row
constexpr int kBN = 128;        // output columns per block
constexpr int kKW = kB / 4;     // 32-bit words per chunk row
constexpr int kThreads = 256;

// XOR swizzle of the word index within a packed qw row: conflict-free reads
// for consecutive columns, 4-way at most for the transposing writes.
__device__ __forceinline__ int swz(int n, int kq) { return kq ^ ((n >> 1) & 15); }

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
tf_matmul_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                 const int8_t* __restrict__ qw, const float* __restrict__ sw,
                 float* __restrict__ out, int C, int M, int N, int adc,
                 float fs, float levels, float step) {
  constexpr int TX = kBN / TN;   // threads along n
  constexpr int TY = BM / TM;    // threads along m
  static_assert(TX * TY == kThreads, "thread tile must cover the block");
  __shared__ int xs[BM][kKW];
  __shared__ int ws[kBN][kKW];
  __shared__ float sxs[BM];
  __shared__ float sws[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int c = 0; c < C; ++c) {
    // qx[c, m0:m0+BM, :]: rows are contiguous 64-byte runs.
    const int* gx = reinterpret_cast<const int*>(qx + ((size_t)c * M + m0) * kB);
    for (int i = tid; i < BM * kKW; i += kThreads) xs[i / kKW][i % kKW] = gx[i];
    // qw[c, :, n0:n0+128], transposed 4x4 bytes at a time.
    const int8_t* gw = qw + (size_t)c * kB * N + n0;
    for (int u = tid; u < kKW * (kBN / 4); u += kThreads) {
      const int kq = u / (kBN / 4), nq = u % (kBN / 4);
      const int8_t* p = gw + (size_t)(4 * kq) * N + 4 * nq;
      const unsigned r0 = *reinterpret_cast<const unsigned*>(p);
      const unsigned r1 = *reinterpret_cast<const unsigned*>(p + N);
      const unsigned r2 = *reinterpret_cast<const unsigned*>(p + 2 * (size_t)N);
      const unsigned r3 = *reinterpret_cast<const unsigned*>(p + 3 * (size_t)N);
      const unsigned a = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
      const unsigned b = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
      const unsigned c2 = __byte_perm(r0, r1, 0x7362); // r0.2 r1.2 r0.3 r1.3
      const unsigned d2 = __byte_perm(r2, r3, 0x7362); // r2.2 r3.2 r2.3 r3.3
      const int n = 4 * nq;
      ws[n + 0][swz(n + 0, kq)] = (int)__byte_perm(a, b, 0x5410);
      ws[n + 1][swz(n + 1, kq)] = (int)__byte_perm(a, b, 0x7632);
      ws[n + 2][swz(n + 2, kq)] = (int)__byte_perm(c2, d2, 0x5410);
      ws[n + 3][swz(n + 3, kq)] = (int)__byte_perm(c2, d2, 0x7632);
    }
    for (int i = tid; i < BM; i += kThreads) sxs[i] = sx[(size_t)c * M + m0 + i];
    for (int j = tid; j < kBN; j += kThreads) sws[j] = sw[(size_t)c * N + n0 + j];
    __syncthreads();

    int p[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) p[i][j] = 0;
#pragma unroll
    for (int kq = 0; kq < kKW; ++kq) {
      int xa[TM], wb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xa[i] = xs[ty + i * TY][kq];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tx + j * TX;
        wb[j] = ws[n][swz(n, kq)];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) p[i][j] = __dp4a(xa[i], wb[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float sxv = sxs[ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float pf = __int2float_rn(p[i][j]);
        if (adc) pf = __fmul_rn(rintf(__fmul_rn(__fdiv_rn(pf, fs), levels)), step);
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__fmul_rn(pf, sxv), sws[tx + j * TX]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)(m0 + ty + i * TY) * N + n0 + tx + j * TX] = acc[i][j];
}

}  // namespace

// M must be 8 (decode tile) or a multiple of 64; N a multiple of 128. The
// Python wrapper pads to those and checks every shape before the call.
extern "C" int tf_matmul(const void* qx, const void* sx, const void* qw,
                         const void* sw, void* out, int C, int M, int N,
                         int adc, float fs, float levels, float step,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qxp = static_cast<const int8_t*>(qx);
  const float* sxp = static_cast<const float*>(sx);
  const int8_t* qwp = static_cast<const int8_t*>(qw);
  const float* swp = static_cast<const float*>(sw);
  float* op = static_cast<float*>(out);
  if (N % kBN != 0 || N <= 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (M == 8) {
    dim3 grid(N / kBN, 1);
    tf_matmul_kernel<8, 1, 4><<<grid, kThreads, 0, st>>>(
        qxp, sxp, qwp, swp, op, C, M, N, adc, fs, levels, step);
  } else if (M > 0 && M % 64 == 0) {
    dim3 grid(N / kBN, M / 64);
    tf_matmul_kernel<64, 4, 8><<<grid, kThreads, 0, st>>>(
        qxp, sxp, qwp, swp, op, C, M, N, adc, fs, levels, step);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
