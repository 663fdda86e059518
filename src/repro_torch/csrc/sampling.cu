// K3: fused sample-from-logits for the serving step, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `_sample_kernel` of
// src/repro/kernels/sampling.py (called from `_sample_pallas`). Per slot s:
//
//     out[s] = lowest-index argmax over V of  lg[s]/max(t[s],1e-6) + noise[s]
//              if t[s] > 0, else of lg[s]
//
// and V when the row holds a NaN (the reference's max is then NaN, no lane
// equals it, and its masked min returns V).
//
// Design. One block per slot; each thread scans the row with a stride of
// the block size, keeping (max, lowest index), then a warp-shuffle and a
// shared-memory reduction break ties toward the lower index. The scaling is
// __fdiv_rn then __fadd_rn, exactly the reference's two roundings.
//
// Bound. Reading lg once, and noise only for the temperature rows (a greedy
// row never loads it): 4*S*V + 4*S_hot*V bytes. For 4 slots over the
// 151936-token vocabulary that is 2.4 MB when every row is greedy, as in
// most decode steps (about 0.73 us at 3.35 TB/s), and 4.9 MB when every row
// samples (about 1.45 us). With one block per slot only S SMs stream the
// rows; splitting rows over more blocks is later work.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ lg, const float* __restrict__ noise,
              const float* __restrict__ temps, int32_t* __restrict__ out,
              int V) {
  const int s = blockIdx.x;
  const float t = temps[s];
  const bool hot = t > 0.0f;
  const float div = fmaxf(t, 1e-6f);
  const float* row = lg + (size_t)s * V;
  const float* nrow = noise + (size_t)s * V;

  float bv = -INFINITY;
  int bi = V;
  int nan = 0;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    float v = row[i];
    if (hot) v = __fadd_rn(__fdiv_rn(v, div), nrow[i]);
    if (isnan(v)) nan = 1;
    else take(bv, bi, v, i);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(bv, bi, ov, oi);
  }
  nan = __any_sync(0xffffffffu, nan);

  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  __shared__ int snan[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sv[warp] = bv; si[warp] = bi; snan[warp] = nan; }
  __syncthreads();
  if (warp == 0) {
    bv = sv[lane]; bi = si[lane]; nan = snan[lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take(bv, bi, ov, oi);
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) out[s] = nan ? V : bi;
  }
}

}  // namespace

extern "C" int sample_tokens(const void* lg, const void* noise,
                             const void* temps, void* out, int S, int V,
                             void* stream) {
  if (S <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  sample_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lg), static_cast<const float*>(noise),
      static_cast<const float*>(temps), static_cast<int32_t*>(out), V);
  return (int)cudaGetLastError();
}
