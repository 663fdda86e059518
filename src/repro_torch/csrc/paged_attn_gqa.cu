// K4: split-K flash-decoding of GQA attention over the paged KV pool, by
// hand for Hopper.
//
// Replaces the Pallas TPU kernel `_gqa_kernel` of
// src/repro/kernels/paged_attn.py (called from `_gqa_pallas`) and its
// `_combine`. For row b, kv-head k, query head h = k*G + g and split s of
// the page table (ts = T / S entries each, positions
// [s*ts*page, (s+1)*ts*page)):
//
//     score[j] = (q[b,h] . K[j,k]) * scale          over the split's j
//     m = max_j score,  p[j] = exp(score[j] - m),  l = sum_j p[j],
//     acc = sum_j p[j] * V[j,k]                      (the split state)
//
// where only positions j < lengths[b] count; then the combine over splits:
//
//     m* = max_s m_s,  a_s = exp(m_s - m*),  l* = sum_s l_s a_s,
//     out = (sum_s acc_s a_s) / max(l*, 1e-30).
//
// Every sum (the score dots, l, acc and the combine's sums over splits)
// is accumulated in double from exact products of float values and
// rounded once to float, as the plain version in kernels/paged_attn.py
// does: the two then agree bitwise whatever order each sums in. The
// exponentials and elementwise steps are the plain version's float
// operations (expf, round-to-nearest products, sums and the division).
//
// A split with no live position keeps m = NEG = -0.7*FLT_MAX, l = 0 and
// acc = 0, exactly the reference's masked state, so its a_s is exp(NEG -
// m*) = 0 beside a live split and a length-0 row comes out as exact zeros
// (0 / 1e-30). The reference zeroes masked lanes with where(valid, ...);
// this kernel never computes them.
//
// Masked positions are SKIPPED, not loaded: pages past lengths[b] (the
// trash page 0 of a freed or short row included) are never read. The
// reference loads them and multiplies their p = 0 by V, so a NaN stored in
// a masked page would poison its output and not this kernel's; for finite
// pools the two agree. Skipping also makes a page-table prefix that covers
// every row's length (the engine's kv_cap) neutral: the same live
// positions are visited in the same order.
//
// Design. Kernel 1: one block per (split, kv-head, row), 128 threads; the
// G query heads of the group sit in shared memory as f32. Pass 1: each warp
// takes a position, its lanes stride over the head dim and a shuffle
// reduction gives one dot per query head; the scores of the split's live
// positions are kept in shared memory (G * ts*page floats). Then a block
// max per head, p = exp(score - m) in place, l as a block sum, and pass 2:
// each thread owns one or two of the Dv features and walks the live
// positions in order, reading V rows coalesced. No fast-math. Kernel 2
// (the combine): one block per (row, head), one thread per feature.
//
// Bound. Bytes: the live K and V rows read once, q read once, out written
// once (the split state is scratch). At the decode shape (4 rows, 8
// kv-heads of 128 bf16, 16-token pages) a 128-token extent is about 2 MiB,
// 0.6 us at 3.35 TB/s; the launch latency of two small kernels sets the
// time at this size.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 256;  // Dk, Dv <= kMaxDim
constexpr float kNeg = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max and sum of one value per thread; every thread gets the
// result. `red` holds kWarps doubles.
__device__ float block_max(float v, double* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_max(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = (float)red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, (float)red[w]);
  return r;
}

__device__ double block_sum(double v, double* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

// Page id of position j of split s in row b (clamped into the pool).
__device__ __forceinline__ int page_of(const int32_t* pt_row, int s, int ts,
                                       int page, int j, int P) {
  int pid = pt_row[s * ts + j / page];
  return pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
}

template <int MAXG, typename T>
__global__ void __launch_bounds__(kThreads)
gqa_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int32_t* __restrict__ pt,
                 const int32_t* __restrict__ lengths, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out,
                 int H, int Hkv, int G, int Dk, int Dv, int P, int page,
                 int ts, int S, long long pt_stride, float scale) {
  const int s = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int span = ts * page;               // positions of one split
  const int start = s * span;
  const int live = min(max(lengths[b] - start, 0), span);

  extern __shared__ double smem[];
  double* red = smem;                       // kWarps
  float* q_s = reinterpret_cast<float*>(red + kWarps);  // G * Dk
  float* sc = q_s + G * Dk;                 // G * span scores, then p
  float* mg = sc + G * span;                // G maxima

  const long long so = ((long long)b * S + s) * H + (long long)k * G;
  if (live == 0) {  // no live position: the reference's masked state
    for (int g = 0; g < G; ++g) {
      if (tid == 0) { m_out[so + g] = kNeg; l_out[so + g] = 0.0f; }
      for (int d = tid; d < Dv; d += kThreads)
        acc_out[(so + g) * Dv + d] = 0.0f;
    }
    return;
  }
  for (int i = tid; i < G * Dk; i += kThreads)
    q_s[i] = q[((long long)b * H + (long long)k * G) * Dk + i];
  __syncthreads();

  // Pass 1: scores of the live positions, one warp per position.
  const int32_t* pt_row = pt + (long long)b * pt_stride;
  constexpr int kPer = kMaxDim / 32;
  for (int j = warp; j < live; j += kWarps) {
    const int pid = page_of(pt_row, s, ts, page, j, P);
    const T* krow = kp + (((long long)pid * page + j % page) * Hkv + k) * Dk;
    float kv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < Dk ? to_f32(krow[d]) : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        double dot = 0.0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          if (d < Dk) dot += (double)q_s[g * Dk + d] * (double)kv[i];
        }
        dot = warp_sum(dot);
        if (lane == 0)
          sc[g * span + j] = __fmul_rn(__double2float_rn(dot), scale);
      }
    }
  }
  __syncthreads();

  // The split's max per head, then p = exp(score - m) in place and l.
  for (int g = 0; g < G; ++g) {
    float v = kNeg;
    for (int j = tid; j < live; j += kThreads) v = fmaxf(v, sc[g * span + j]);
    v = block_max(v, red);
    if (tid == 0) mg[g] = v;
  }
  __syncthreads();
  double lsum[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    lsum[g] = 0.0;
    if (g < G) {
      const float m = mg[g];
      for (int j = tid; j < live; j += kThreads) {
        const float p = expf(__fsub_rn(sc[g * span + j], m));
        sc[g * span + j] = p;
        lsum[g] += (double)p;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) {
      const double l = block_sum(lsum[g], red);
      if (tid == 0) {
        m_out[so + g] = mg[g];
        l_out[so + g] = __double2float_rn(l);
      }
    }
  __syncthreads();

  // Pass 2: acc = sum_j p[j] * V[j], positions in order, one or two
  // features per thread.
  constexpr int kDPer = kMaxDim / kThreads;
  double acc[MAXG][kDPer];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < kDPer; ++i) acc[g][i] = 0.0;
  for (int j = 0; j < live; ++j) {
    const int pid = page_of(pt_row, s, ts, page, j, P);
    const T* vrow = vp + (((long long)pid * page + j % page) * Hkv + k) * Dv;
#pragma unroll
    for (int i = 0; i < kDPer; ++i) {
      const int d = tid + kThreads * i;
      if (d < Dv) {
        const double v = (double)to_f32(vrow[d]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g][i] += (double)sc[g * span + j] * v;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < kDPer; ++i) {
        const int d = tid + kThreads * i;
        if (d < Dv) acc_out[(so + g) * Dv + d] = __double2float_rn(acc[g][i]);
      }
}

__global__ void __launch_bounds__(kThreads)
gqa_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ acc, float* __restrict__ out,
                   int H, int S, int Dv) {
  const int h = blockIdx.x, b = blockIdx.y;
  float m_star = kNeg;
  for (int s = 0; s < S; ++s)
    m_star = fmaxf(m_star, m[((long long)b * S + s) * H + h]);
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    double l_star = 0.0, a_star = 0.0;
    for (int s = 0; s < S; ++s) {
      const long long i = ((long long)b * S + s) * H + h;
      const double alpha = (double)expf(__fsub_rn(m[i], m_star));
      l_star += (double)l[i] * alpha;
      a_star += (double)acc[i * Dv + d] * alpha;
    }
    out[((long long)b * H + h) * Dv + d] =
        __fdiv_rn(__double2float_rn(a_star),
                  fmaxf(__double2float_rn(l_star), 1e-30f));
  }
}

template <int MAXG, typename T>
int launch_split(const float* q, const void* kp, const void* vp,
                 const int32_t* pt, const int32_t* lengths, float* m, float* l,
                 float* acc, int B, int H, int Hkv, int Dk, int Dv, int P,
                 int page, int ts, int S, long long pt_stride, float scale,
                 size_t smem, cudaStream_t stream) {
  auto kernel = gqa_split_kernel<MAXG, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)S, (unsigned)Hkv, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), pt, lengths,
      m, l, acc, H, Hkv, H / Hkv, Dk, Dv, P, page, ts, S, pt_stride, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_g(int G, const float* q, const void* kp, const void* vp,
                   const int32_t* pt, const int32_t* lengths, float* m,
                   float* l, float* acc, int B, int H, int Hkv, int Dk, int Dv,
                   int P, int page, int ts, int S, long long pt_stride,
                   float scale, size_t smem, cudaStream_t st) {
#define REPRO_SPLIT(MG)                                                     \
  return launch_split<MG, T>(q, kp, vp, pt, lengths, m, l, acc, B, H, Hkv, \
                             Dk, Dv, P, page, ts, S, pt_stride, scale, smem, \
                             st)
  if (G <= 1) REPRO_SPLIT(1);
  if (G <= 2) REPRO_SPLIT(2);
  if (G <= 4) REPRO_SPLIT(4);
  if (G <= 8) REPRO_SPLIT(8);
  REPRO_SPLIT(16);
#undef REPRO_SPLIT
}

}  // namespace

// Bytes of shared memory the split kernel needs for G heads of Dk and
// `span` = ts*page positions per split (saturating at INT_MAX); the
// wrapper checks it against the card's limit.
extern "C" int paged_attn_gqa_smem(int G, int Dk, int span) {
  const long long n =
      8LL * kWarps + 4LL * ((long long)G * Dk + (long long)G * span + G);
  return n > INT_MAX ? INT_MAX : (int)n;
}

// q (B,H,Dk) f32; pools (P,page,Hkv,Dk|Dv) of `pool_bf16` ? bf16 : f32;
// pt (B, >= S*ts) int32 with row stride pt_stride; lengths (B,) int32;
// scratch m, l (B,S,H) and acc (B,S,H,Dv) f32; out (B,H,Dv) f32.
extern "C" int paged_attn_gqa(const void* q, const void* kp, const void* vp,
                              const void* pt, const void* lengths, void* m,
                              void* l, void* acc, void* out, int B, int H,
                              int Hkv, int Dk, int Dv, int P, int page, int ts,
                              int S, long long pt_stride, float scale,
                              int pool_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 16 || Dk <= 0 ||
      Dk > kMaxDim || Dv <= 0 || Dv > kMaxDim || P <= 0 || page <= 0 ||
      ts <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const size_t smem = (size_t)paged_attn_gqa_smem(G, Dk, ts * page);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int32_t* ptv = static_cast<const int32_t*>(pt);
  const int32_t* lv = static_cast<const int32_t*>(lengths);
  float *mf = static_cast<float*>(m), *lf = static_cast<float*>(l),
        *af = static_cast<float*>(acc);
  const int err =
      pool_bf16
          ? launch_split_g<__nv_bfloat16>(G, qf, kp, vp, ptv, lv, mf, lf, af,
                                          B, H, Hkv, Dk, Dv, P, page, ts, S,
                                          pt_stride, scale, smem, st)
          : launch_split_g<float>(G, qf, kp, vp, ptv, lv, mf, lf, af, B, H,
                                  Hkv, Dk, Dv, P, page, ts, S, pt_stride,
                                  scale, smem, st);
  if (err != 0) return err;
  gqa_combine_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, 0, st>>>(
      mf, lf, af, static_cast<float*>(out), H, S, Dv);
  return (int)cudaGetLastError();
}
