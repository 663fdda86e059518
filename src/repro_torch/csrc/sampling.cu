// K3: fused sample-from-logits for the serving step, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `_sample_kernel` of
// src/repro/kernels/sampling.py (called from `_sample_pallas`). Per slot s:
//
//     out[s] = lowest-index argmax over V of  lg[s]/max(t[s],1e-6) + noise[s]
//              if t[s] > 0, else of lg[s]
//
// and V when the row holds a NaN (the reference's max is then NaN, no lane
// equals it, and its masked min returns V). A row of -inf returns 0.
//
// Bound. Reading lg once, and noise only for the temperature rows (a greedy
// row never loads it): 4*S*V + 4*S_hot*V bytes. For 4 slots over the
// 151936-token vocabulary that is 2.4 MB when every row is greedy, as in
// most decode steps (about 0.73 us at 3.35 TB/s), and 4.9 MB when every row
// samples (about 1.45 us). The work is so small that the kernel must spread
// it over many SMs and keep many loads in flight on each, in one launch.
//
// Design. A grid of (P, S) blocks in clusters of P (cluster dims set at
// launch, so P is a runtime choice: 4, 8, or 16 with the non-portable size
// allowed; the wrapper takes the largest that `sample_max_clusters`, the
// occupancy query, says the card can place). Block p of row s scans its contiguous slice of the row
// (`row_slices` in kernels/sampling.py mirrors the cut: internal boundaries
// fall on 16-byte-aligned elements, so only block 0's head and block P-1's
// tail are scalar) with 16-byte read-only loads, kUnroll of them in flight
// per thread, keeping (max, lowest index, NaN seen). Warp shuffles, then
// shared memory across warps, reduce the block to one partial; after a
// cluster barrier, lane q of block rank 0's first warp reads block q's
// partial through distributed shared memory, the warp reduces the P
// partials and writes out[s]; a second cluster barrier keeps every block's
// shared memory alive until then. One launch, no
// workspace, no atomics. `take` is a total order (greater value, then lower
// index), so the result does not depend on how the row was cut: ties go to
// the lowest index within a thread, across threads and across blocks. The
// scaling is __fdiv_rn then __fadd_rn, exactly the reference's two
// roundings.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // float4 loads in flight per thread and operand
constexpr int kMaxCluster = 16;

__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
}

__device__ __forceinline__ void visit(float& bv, int& bi, int& nan, float x,
                                      float z, bool hot, float div, int i) {
  // A zero numerator is its own quotient (div > 0); leaving it out of the
  // division spares the divide's slow path, which zeros take.
  if (hot) x = __fadd_rn(x == 0.0f ? x : __fdiv_rn(x, div), z);
  if (isnan(x)) nan = 1;
  else take(bv, bi, x, i);
}

// The slice of a V-wide row that block p of P scans: boundaries at
// h + 4*floor(p*n4/P), where h is the count of elements before the row's
// first 16-byte-aligned one and n4 the row's aligned float4 count.
__device__ __forceinline__ int slice_edge(int p, int P, int V, int h) {
  if (p == 0) return 0;
  if (p == P) return V;
  const int n4 = (V - h) / 4;
  return h + 4 * (int)(((long long)p * n4) / P);
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ lg, const float* __restrict__ noise,
              const float* __restrict__ temps, int32_t* __restrict__ out,
              int V) {
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int p = (int)cluster.block_rank();
  const int s = blockIdx.y;
  const float t = temps[s];
  const bool hot = t > 0.0f;
  const float div = fmaxf(t, 1e-6f);
  const float* row = lg + (size_t)s * V;
  const float* nrow = noise + (size_t)s * V;

  // Elements before the row's first 16-byte boundary (the wrapper makes lg
  // and noise agree in address modulo 16).
  const int mis = (int)((reinterpret_cast<uintptr_t>(row) & 15) / 4);
  const int h = min((4 - mis) & 3, V);
  const int lo = slice_edge(p, P, V, h), hi = slice_edge(p + 1, P, V, h);
  // [lo, a) and [b, hi) scalar; [a, b) in float4s.
  const int a = min(hi, lo < h ? h : lo);
  const int b = a + 4 * ((hi - a) / 4);

  float bv = -INFINITY;
  int bi = V, nan = 0;
  for (int i = lo + (int)threadIdx.x; i < a; i += kThreads)
    visit(bv, bi, nan, row[i], hot ? nrow[i] : 0.0f, hot, div, i);
  for (int i = b + (int)threadIdx.x; i < hi; i += kThreads)
    visit(bv, bi, nan, row[i], hot ? nrow[i] : 0.0f, hot, div, i);

  const float4* r4 = reinterpret_cast<const float4*>(row + a);
  const float4* n4 = reinterpret_cast<const float4*>(nrow + a);
  const int cnt = (b - a) / 4;
  for (int k0 = (int)threadIdx.x; k0 < cnt; k0 += kThreads * kUnroll) {
    float4 x[kUnroll], z[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      x[u] = k < cnt ? __ldg(r4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      z[u] = (hot && k < cnt) ? __ldg(n4 + k)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < cnt) {
        const int i = a + 4 * k;
        visit(bv, bi, nan, x[u].x, z[u].x, hot, div, i);
        visit(bv, bi, nan, x[u].y, z[u].y, hot, div, i + 1);
        visit(bv, bi, nan, x[u].z, z[u].z, hot, div, i + 2);
        visit(bv, bi, nan, x[u].w, z[u].w, hot, div, i + 3);
      }
    }
  }

  // Block: warp shuffles, then the warps' partials through shared memory.
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(bv, bi, ov, oi);
  }
  nan = __any_sync(0xffffffffu, nan);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps], warp_nan[kWarps];
  __shared__ float block_v;
  __shared__ int block_i, block_nan;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_v[warp] = bv; warp_i[warp] = bi; warp_nan[warp] = nan;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? warp_v[lane] : -INFINITY;
    bi = lane < kWarps ? warp_i[lane] : V;
    nan = lane < kWarps ? warp_nan[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take(bv, bi, ov, oi);
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) { block_v = bv; block_i = bi; block_nan = nan; }
  }

  // Cluster: lane q of rank 0's first warp reads block q's partial (all P
  // remote reads in flight at once), and the warp reduces them.
  cluster.sync();
  if (p == 0 && warp == 0) {
    bv = -INFINITY;
    bi = V;
    nan = 0;
    if (lane < P) {
      bv = *cluster.map_shared_rank(&block_v, lane);
      bi = *cluster.map_shared_rank(&block_i, lane);
      nan = *cluster.map_shared_rank(&block_nan, lane);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take(bv, bi, ov, oi);
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) out[s] = nan ? V : bi;
  }
  cluster.sync();  // keep every block's shared memory until rank 0 is done
}

}  // namespace

namespace {

// Allow the non-portable cluster sizes (9 to 16 blocks) once.
cudaError_t allow_large_clusters() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      sample_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

cudaLaunchConfig_t launch_config(int P, int S, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, S, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of P blocks the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *count: 0 where no GPC of this
// card or partition has P free SMs. The wrapper picks its cluster size
// with it.
extern "C" int sample_max_clusters(int P, void* count) {
  if (P <= 0 || P > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (P > 8) {
    const cudaError_t e = allow_large_clusters();
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(P, 1, nullptr, attr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, sample_kernel,
                                                       &cfg);
  *static_cast<int*>(count) = e == cudaSuccess ? n : 0;
  return e == cudaSuccess ? 0 : (int)e;
}

// P blocks (a cluster) per row: 1 to 8 portably, up to 16 as a
// non-portable cluster size. The Python wrapper checks shapes, types,
// contiguity and that lg and noise agree in address modulo 16.
extern "C" int sample_tokens(const void* lg, const void* noise,
                             const void* temps, void* out, int S, int V,
                             int P, void* stream) {
  if (S <= 0 || V <= 0 || P <= 0 || P > kMaxCluster || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (P > 8) {
    const cudaError_t e = allow_large_clusters();
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      P, S, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sample_kernel, static_cast<const float*>(lg),
      static_cast<const float*>(noise), static_cast<const float*>(temps),
      static_cast<int32_t*>(out), V);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
