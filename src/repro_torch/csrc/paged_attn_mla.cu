// K5: split-K absorbed-MLA decode over the paged latent pools, by hand for
// Hopper.
//
// Replaces the Pallas TPU kernel `_mla_kernel` of
// src/repro/kernels/paged_attn.py (called from `_mla_pallas`) and its
// `_combine`. MLA decode in the absorbed form is single-group MQA in the
// latent space: every query head h of row b reads the same cached rows,
// the latent c_kv[j] (C wide) and the rope key k_rope[j] (R wide). For
// split s of the row's page table (ts = T / S entries, positions
// [s*ts*page, (s+1)*ts*page)):
//
//     score[h,j] = (q_lat[h] . c_kv[j] + q_rope[h] . k_rope[j]) * scale
//     m = max_j score,  p[j] = exp(score[j] - m),  l = sum_j p[j],
//     acc = sum_j p[j] * c_kv[j]                    (the split state)
//
// over the live positions j < lengths[b]; then the combine over splits
//
//     m* = max_s m_s,  a_s = exp(m_s - m*),  l* = sum_s l_s a_s,
//     out = (sum_s acc_s a_s) / max(l*, 1e-30).
//
// The score is ONE dot over the C+R concatenated features, as the
// reference's `_attend_block_mla` runs it. Every sum (the C+R-term score
// dots, l, acc and the combine's sums over splits) is accumulated in
// double from exact products of float values and rounded once to float,
// as the plain version in kernels/paged_attn.py does: the two agree
// bitwise whatever order each sums in. The exponentials and elementwise
// steps are the plain version's float operations (expf, round-to-nearest
// products, differences and the division). No fast-math.
//
// A split with no live position writes the reference's masked state
// (m = NEG = -0.7*FLT_MAX, l = 0, acc = 0), so a length-0 row comes out
// as exact zeros. Masked positions are SKIPPED, not loaded: pages past
// lengths[b] (the trash page 0 included) are never read, which also makes
// a page-table prefix covering every row's length (the engine's kv_cap)
// neutral.
//
// Design. Kernel 1: one block per (split, group of 16 heads, row), 256
// threads. The group's queries sit in shared memory as f32 (16 x (C+R)).
// Pass 1: each warp takes a live position, its lanes stride over the
// C+R features of the position's latent and rope rows (read once per
// block, coalesced), and a shuffle reduction per head gives the 16 dots;
// the split's scores stay in shared memory (16 x ts*page floats). Then a
// block max per head, p = exp(score - m) in place, l as a block sum, and
// pass 2: each thread owns two latent features for all 16 heads and walks
// the live positions in order, reading the latent rows coalesced, so the
// latents are read twice per block and the rope rows once. Kernel 2 (the
// combine): one block per (row, head), one thread per feature.
//
// Bound. At the serving decode shape (4 rows, 128 heads, C = 512,
// R = 64, 16-token bf16 pages) the function must read the live latent and
// rope rows (1152 bytes a position), q (1.18 MB in f32) and write out
// (1.05 MB), and do 2*H*(C+R+C) flops a position. At ~260 live positions
// the flops at the f32 rate (~1.1 us) bind over the bytes (~0.76 us); the
// float64 sums run at half the f32 rate, and the combine's traffic
// (n_splits x 1 MB of acc per row group) is the price of splitting.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHG = 16;           // query heads per block
constexpr int kMaxC = 512;        // latent width C <= kMaxC
constexpr int kMaxR = 128;        // rope width R <= kMaxR
constexpr int kPer = (kMaxC + kMaxR) / 32;   // features per lane, pass 1
constexpr int kDPer = kMaxC / kThreads;      // features per thread, pass 2
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

// Row offset (in elements of one pool row) of position j of split s.
__device__ __forceinline__ long long row_of(const int32_t* pt_row, int s,
                                            int ts, int page, int j, int P) {
  int pid = pt_row[s * ts + j / page];
  pid = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  return (long long)pid * page + j % page;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_split_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_rope, const T* __restrict__ cp,
                 const T* __restrict__ rp, const int32_t* __restrict__ pt,
                 const int32_t* __restrict__ lengths, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out, int H,
                 int C, int R, int P, int page, int ts, int S,
                 long long pt_stride, float scale) {
  const int s = blockIdx.x, h0 = blockIdx.y * kHG, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = min(kHG, H - h0);           // heads of this block
  const int D = C + R;
  const int span = ts * page;               // positions of one split
  const int start = s * span;
  const int live = min(max(lengths[b] - start, 0), span);

  extern __shared__ double smem[];
  double* red = smem;                       // kWarps
  float* q_s = reinterpret_cast<float*>(red + kWarps);  // kHG * D
  float* sc = q_s + kHG * D;                // kHG * span scores, then p
  float* mg = sc + kHG * span;              // kHG maxima

  const long long so = ((long long)b * S + s) * H + h0;
  if (live == 0) {  // no live position: the reference's masked state
    for (int g = 0; g < G; ++g) {
      if (tid == 0) { m_out[so + g] = kNeg; l_out[so + g] = 0.0f; }
      for (int d = tid; d < C; d += kThreads)
        acc_out[(so + g) * C + d] = 0.0f;
    }
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const long long h = (long long)b * H + h0 + g;
    q_s[i] = d < C ? q_lat[h * C + d] : q_rope[h * R + d - C];
  }
  __syncthreads();

  // Pass 1: scores of the live positions, one warp per position.
  const int32_t* pt_row = pt + (long long)b * pt_stride;
  for (int j = warp; j < live; j += kWarps) {
    const long long row = row_of(pt_row, s, ts, page, j, P);
    const T* crow = cp + row * C;
    const T* rrow = rp + row * R;
    float kv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < C ? to_f32(crow[d]) : (d < D ? to_f32(rrow[d - C]) : 0.0f);
    }
#pragma unroll
    for (int g = 0; g < kHG; ++g) {
      if (g < G) {
        double dot = 0.0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          if (d < D) dot += (double)q_s[g * D + d] * (double)kv[i];
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
  double lsum[kHG];
#pragma unroll
  for (int g = 0; g < kHG; ++g) {
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
  for (int g = 0; g < kHG; ++g)
    if (g < G) {
      const double l = block_sum(lsum[g], red);
      if (tid == 0) {
        m_out[so + g] = mg[g];
        l_out[so + g] = __double2float_rn(l);
      }
    }
  __syncthreads();

  // Pass 2: acc = sum_j p[j] * c_kv[j], positions in order, two latent
  // features per thread for every head of the group.
  double acc[kHG][kDPer];
#pragma unroll
  for (int g = 0; g < kHG; ++g)
#pragma unroll
    for (int i = 0; i < kDPer; ++i) acc[g][i] = 0.0;
  for (int j = 0; j < live; ++j) {
    const T* crow = cp + row_of(pt_row, s, ts, page, j, P) * C;
#pragma unroll
    for (int i = 0; i < kDPer; ++i) {
      const int d = tid + kThreads * i;
      if (d < C) {
        const double v = (double)to_f32(crow[d]);
#pragma unroll
        for (int g = 0; g < kHG; ++g)
          if (g < G) acc[g][i] += (double)sc[g * span + j] * v;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kHG; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < kDPer; ++i) {
        const int d = tid + kThreads * i;
        if (d < C) acc_out[(so + g) * C + d] = __double2float_rn(acc[g][i]);
      }
}

__global__ void __launch_bounds__(kThreads)
mla_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ acc, float* __restrict__ out,
                   int H, int S, int C) {
  const int h = blockIdx.x, b = blockIdx.y;
  float m_star = kNeg;
  for (int s = 0; s < S; ++s)
    m_star = fmaxf(m_star, m[((long long)b * S + s) * H + h]);
  for (int d = threadIdx.x; d < C; d += kThreads) {
    double l_star = 0.0, a_star = 0.0;
    for (int s = 0; s < S; ++s) {
      const long long i = ((long long)b * S + s) * H + h;
      const double alpha = (double)expf(__fsub_rn(m[i], m_star));
      l_star += (double)l[i] * alpha;
      a_star += (double)acc[i * C + d] * alpha;
    }
    out[((long long)b * H + h) * C + d] =
        __fdiv_rn(__double2float_rn(a_star),
                  fmaxf(__double2float_rn(l_star), 1e-30f));
  }
}

template <typename T>
int launch_split(const float* q_lat, const float* q_rope, const void* cp,
                 const void* rp, const int32_t* pt, const int32_t* lengths,
                 float* m, float* l, float* acc, int B, int H, int C, int R,
                 int P, int page, int ts, int S, long long pt_stride,
                 float scale, size_t smem, cudaStream_t stream) {
  auto kernel = mla_split_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)S, (unsigned)((H + kHG - 1) / kHG), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q_lat, q_rope, static_cast<const T*>(cp), static_cast<const T*>(rp), pt,
      lengths, m, l, acc, H, C, R, P, page, ts, S, pt_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the split kernel needs for latent width C, rope
// width R and `span` = ts*page positions per split (saturating at
// INT_MAX); the wrapper checks it against the card's limit.
extern "C" int paged_attn_mla_smem(int C, int R, int span) {
  const long long n =
      8LL * kWarps +
      4LL * ((long long)kHG * (C + R) + (long long)kHG * span + kHG);
  return n > INT_MAX ? INT_MAX : (int)n;
}

// q_lat (B,H,C) and q_rope (B,H,R) f32; pools (P,page,C) and (P,page,R) of
// `pool_bf16` ? bf16 : f32; pt (B, >= S*ts) int32 with row stride
// pt_stride; lengths (B,) int32; scratch m, l (B,S,H) and acc (B,S,H,C)
// f32; out (B,H,C) f32.
extern "C" int paged_attn_mla(const void* q_lat, const void* q_rope,
                              const void* cp, const void* rp, const void* pt,
                              const void* lengths, void* m, void* l, void* acc,
                              void* out, int B, int H, int C, int R, int P,
                              int page, int ts, int S, long long pt_stride,
                              float scale, int pool_bf16, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || C > kMaxC || R < 0 || R > kMaxR ||
      P <= 0 || page <= 0 || ts <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)paged_attn_mla_smem(C, R, ts * page);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float* ql = static_cast<const float*>(q_lat);
  const float* qr = static_cast<const float*>(q_rope);
  const int32_t* ptv = static_cast<const int32_t*>(pt);
  const int32_t* lv = static_cast<const int32_t*>(lengths);
  float *mf = static_cast<float*>(m), *lf = static_cast<float*>(l),
        *af = static_cast<float*>(acc);
  const int err =
      pool_bf16
          ? launch_split<__nv_bfloat16>(ql, qr, cp, rp, ptv, lv, mf, lf, af, B,
                                        H, C, R, P, page, ts, S, pt_stride,
                                        scale, smem, st)
          : launch_split<float>(ql, qr, cp, rp, ptv, lv, mf, lf, af, B, H, C,
                                R, P, page, ts, S, pt_stride, scale, smem, st);
  if (err != 0) return err;
  mla_combine_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, 0, st>>>(
      mf, lf, af, static_cast<float*>(out), H, S, C);
  return (int)cudaGetLastError();
}
