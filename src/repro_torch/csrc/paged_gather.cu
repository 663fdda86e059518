// K6: the page-table gather of the paged KV pool, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/paged.py
// (called from `gather_pages_pallas`):
//
//     out[e] = pool[pt[e]]     e = b*T + t, one whole page per entry
//
// for a pool (P, page, *feat) of any element type: the kernel sees a page
// as `page_bytes` raw bytes, so the copy is bitwise whatever the type.
// Page ids are clamped into [0, P), as the reference's gather clamps an
// out-of-range index; the engine's tables hold only valid ids (0 = trash).
//
// Design. Block (e, c) copies chunk c of entry e's page: kThreads threads,
// one vector of type V each, V the widest of 16/8/4/2/1 bytes that divides
// the page and both base addresses (the wrapper picks it; 16 for the
// serving pools). Neighbouring threads touch neighbouring vectors, so
// loads and stores are coalesced; there is no reuse, so no shared memory.
//
// Bound. Bytes: each gathered page read once and written once,
// 2 * B*T * page_bytes. At the serving prefill shape (pool of 16-token
// pages of 8 kv-heads x 128 bf16, a (4, 32) table) that is 8 MiB per call,
// about 2.5 us at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_pages_kernel(const V* __restrict__ pool, const int32_t* __restrict__ pt,
                    V* __restrict__ out, int P, long long page_vecs) {
  const long long e = blockIdx.x;
  const long long i = (long long)blockIdx.y * kThreads + threadIdx.x;
  if (i >= page_vecs) return;
  int pid = pt[e];
  pid = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  out[e * page_vecs + i] = pool[(long long)pid * page_vecs + i];
}

template <typename V>
int launch(const void* pool, const void* pt, void* out, int entries, int P,
           long long page_bytes, cudaStream_t stream) {
  const long long page_vecs = page_bytes / (long long)sizeof(V);
  const long long chunks = (page_vecs + kThreads - 1) / kThreads;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)entries, (unsigned)chunks);
  gather_pages_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(pool), static_cast<const int32_t*>(pt),
      static_cast<V*>(out), P, page_vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// vec_bytes in {16, 8, 4, 2, 1} must divide page_bytes and both pointers.
extern "C" int gather_pages(const void* pool, const void* pt, void* out,
                            int entries, int P, long long page_bytes,
                            int vec_bytes, void* stream) {
  if (entries <= 0 || P <= 0 || page_bytes <= 0 ||
      page_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(pool, pt, out, entries, P, page_bytes, s);
    case 8: return launch<uint2>(pool, pt, out, entries, P, page_bytes, s);
    case 4: return launch<uint32_t>(pool, pt, out, entries, P, page_bytes, s);
    case 2: return launch<uint16_t>(pool, pt, out, entries, P, page_bytes, s);
    case 1: return launch<uint8_t>(pool, pt, out, entries, P, page_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
