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
// The softmax is two-pass, as the plain version's: every score of the
// split first, then its max, then p. A running (online) max would rescale
// partial sums by exp(m_old - m_new) and give other float p, other bits.
//
// A split with no live position keeps m = NEG = -0.7*FLT_MAX, l = 0 and
// acc = 0, exactly the reference's masked state, so its a_s is exp(NEG -
// m*) = 0 beside a live split and a length-0 row comes out as exact zeros
// (0 / 1e-30). The reference zeroes masked lanes with where(valid, ...);
// this kernel never computes them.
//
// Masked positions are SKIPPED, not loaded: only the rows of positions
// below lengths[b] are copied, so pages past a row's length (the trash
// page 0 of a freed or short row included) are never read. The reference
// loads them and multiplies their p = 0 by V, so a NaN stored in a masked
// page would poison its output and not this kernel's; for finite pools the
// two agree. Skipping also makes a page-table prefix that covers every
// row's length (the engine's kv_cap) neutral.
//
// Bound. Bytes: the live K and V rows read once, q read once, out written
// once. At the decode shape (4 rows, 8 kv-heads of 128 bf16, 16-token
// pages, an 8-page cap) that is about 1.1 MB, 0.34 us at 3.35 TB/s; the
// latency of a launch, of its memory round trips and of its barriers sets
// the time at this size, so the design spends as few of each as it can.
//
// Design. One launch per call: a grid of (S, Hkv, B) blocks of 128
// threads, the S split blocks of one (kv-head, row) in one thread-block
// cluster (S <= 8, the portable size; S = 1 launches without a cluster).
// At this size every block is a chain of dependent latencies (one warp per
// scheduler), so each phase is written to keep its loads independent of
// the float64 arithmetic that consumes them: indices are clamped into
// range and only the arithmetic is predicated, never branched around.
//  - Staging. The threads read lengths[b], the split's page ids and q in
//    one round trip, then copy the live rows of K (threads 0-63) and of V
//    (threads 64-127) of their kv-head into two rings of `R` page slots in
//    shared memory with 16-byte cp.async copies; each thread's copies of a
//    page complete on the slot's mbarrier (cp.async.mbarrier.arrive). The
//    V copies do not wait for the scores, so K and V of the first R pages
//    are in flight together. A split of more than R live pages refills a
//    slot as soon as every warp is done with it (the wrapper's `k4_plan`
//    sizes R; `k4_ring_schedule` mirrors the order). Rows that are not a
//    multiple of 16 bytes, or pools not 16-byte aligned, are copied with
//    plain loads instead, on the same barriers.
//  - Pass 1: the eight lanes of a position read its row as 16-byte
//    vectors and q (stored as double, interleaved so that they read 128
//    contiguous bytes of it), and three shuffle levels reduce the G dots;
//    scores go to shared memory.
//  - Softmax: warp w owns heads w, w+4, ...: max, p = exp(score - m) (kept
//    as double) and l, with warp reductions only.
//  - Pass 2: two row groups of 64 threads each take every other position;
//    a thread owns two (four) features for all G heads.
//  - Combine: each block stores its (m, l) and its acc, rounded to float,
//    into the shared memory of the split block that owns those outputs
//    (block s owns outputs [s*per, (s+1)*per) of the G*Dv); after one
//    cluster barrier the owner reduces them, in split order 0..S-1, from
//    its own shared memory and writes out. No scratch in device memory, no
//    atomics: two calls are bitwise equal.
#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kThreads / 2;  // stagers of K, of V; a pass-2 group
constexpr int kMaxDim = 256;    // Dk, Dv <= kMaxDim
constexpr int kMaxG = 16;       // query heads per kv-head
constexpr int kMaxCluster = 8;  // the portable cluster size: S <= 8
constexpr long long kSmemLimit = 232448;  // 227 KB a block
constexpr float kNeg = -0.7f * FLT_MAX;

#ifdef K4_PHASE_CLOCKS
// Built with -DK4_PHASE_CLOCKS by launch/profile_k4.py only: thread 0 of
// each of the first kClockBlocks blocks records clock64() as it enters each
// phase, and once more as it leaves.
constexpr int kClockBlocks = 4096;
__device__ long long k4_clocks[kClockBlocks][8];
#define K4_MARK(i)                                                         \
  do {                                                                     \
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +     \
                    blockIdx.x;                                            \
    if (threadIdx.x == 0 && blk < kClockBlocks)                            \
      k4_clocks[blk][i] = clock64();                                       \
  } while (0)
#else
#define K4_MARK(i) \
  do {             \
  } while (0)
#endif

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
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

// Completes an arrival on `bar` once every cp.async this thread issued so
// far has landed (the barrier counts one such arrival per thread).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Shared-memory layout of a block, in bytes from the dynamic base; every
// region starts on 16 bytes. kernels/paged_attn.py's `_k4_smem` mirrors it
// (the entry point checks that the two agree).
struct Layout {
  long long bars, pids, qd, sc, pd, xs, in_m, in_l, in_acc, kring, vring,
      kslot, vslot, total;
  int per;  // outputs each split block reduces: ceil(G*Dv / S)
};

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// Dk rounded up to a whole 16-byte vector of pool elements: the row pitch
// of K in shared memory (zeros past Dk).
__host__ __device__ inline int padded_dk(int Dk, int isz) {
  const int vec = 16 / isz;
  return (Dk + vec - 1) / vec * vec;
}

// Pass 1 reads a row as chunks of eight 16-byte vectors (one per lane of
// a position); q, as double, is stored chunk by chunk so that those lanes
// read 128 contiguous bytes of it too.
__host__ __device__ inline int q_chunks(int Dk, int isz) {
  const int per = 8 * (16 / isz);
  return (Dk + per - 1) / per;
}

__host__ __device__ inline Layout layout(int G, int Dk, int Dv, int page,
                                         int ts, int S, int R, int isz) {
  Layout L;
  const long long span = (long long)ts * page;
  const int Dkp = padded_dk(Dk, isz);
  L.per = (G * Dv + S - 1) / S;
  long long o = 0;
  L.bars = o;   o += align16(16LL * R);                // K and V mbarriers
  L.pids = o;   o += align16(4LL * ts);                // the split's pages
  L.qd = o;     o += align16(8LL * G * q_chunks(Dk, isz) * 8 * (16 / isz));
  L.sc = o;     o += align16(4LL * G * span);          // scores
  L.pd = o;     o += align16(8LL * G * span);          // p as double
  L.xs = o;     o += align16(8LL * G * Dv);            // pass 2's 2nd half
  L.in_m = o;   o += align16(4LL * S * G);             // the splits' m,
  L.in_l = o;   o += align16(4LL * S * G);             // l and acc for
  L.in_acc = o; o += align16(4LL * S * L.per);         // this block's outputs
  L.kslot = align16((long long)page * Dkp * isz);
  L.vslot = align16((long long)page * Dv * isz);
  L.kring = o;  o += R * L.kslot;
  L.vring = o;  o += R * L.vslot;
  L.total = o;
  return L;
}

// How thread t of the kHalf staging threads takes part in staging rows
// of D elements with 16-byte copies: rows r0, r0 + step, ... at element
// offset e (inactive when r0 >= step). Computed once per block.
struct CopyLane {
  int r0, e, step;
};

template <typename T>
__device__ __forceinline__ CopyLane copy_lane(int D, int tid) {
  // Copies per row, 1 to 64 (D / kVec is 0 only where no copy is made).
  // A row of 64 copies (256 f32) takes all kHalf threads.
  const int per_row = max(1, D / (16 / (int)sizeof(T)));
  return {tid / per_row, (tid % per_row) * (16 / (int)sizeof(T)),
          kHalf / per_row};
}

// kHalf threads (t their index among them) stage the live rows [0, rows)
// of page `pid`, kv-head k, into a ring slot (rows `pitch` >= D elements
// apart, zeros past D), and each arrives once on the slot's mbarrier: with
// 16-byte cp.async copies (arriving when its own copies land), or else
// with plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_page(T* dst, int pitch, const T* pool,
                                           uint64_t* bar, int pid, int rows,
                                           int k, int Hkv, int D, int page,
                                           bool vec, CopyLane cl, int t) {
  const long long stride = (long long)Hkv * D;  // elements between rows
  const T* src = pool + ((long long)pid * page * Hkv + k) * D;
  if (vec) {
    if (cl.r0 < cl.step) {
      const T* from = src + cl.r0 * stride + cl.e;
      T* to = dst + cl.r0 * pitch + cl.e;
      for (int r = cl.r0; r < rows; r += cl.step) {
        cp_async16(to, from);
        from += cl.step * stride;
        to += cl.step * pitch;
      }
    }
    mbar_arrive_cp_async(bar);
  } else {
    for (int i = t; i < rows * pitch; i += kHalf) {
      const int r = i / pitch, d = i - r * pitch;
      dst[i] = d < D ? src[r * stride + d] : T(0.0f);
    }
    mbar_arrive(bar);
  }
}

// The kVec pool elements of a 16-byte vector, as floats (exact).
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int MAXG, bool WIDE, typename T>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const void* __restrict__ qv, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int32_t* __restrict__ pt,
                  const int32_t* __restrict__ lengths, float* __restrict__ out,
                  int H, int Hkv, int G, int Dk, int Dv, int P, int page,
                  int ts, int R, long long pt_stride, float scale, int q_bf16,
                  int vec) {
  // WIDE: head dims up to 256, else up to 128. Loads below are never
  // branched around (indices are clamped into range and only the
  // arithmetic is predicated), so that the compiler can issue a page's
  // shared-memory loads ahead of the float64 chains that consume them.
  constexpr int kVec = 16 / sizeof(T);    // pool elements in 16 bytes
  constexpr int KC = (WIDE ? kMaxDim : kMaxDim / 2) / (8 * kVec);  // vectors
  constexpr int DP = WIDE ? 4 : 2;        // features per thread in pass 2
  const int s = blockIdx.x, k = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int span = ts * page;               // positions of one split
  const Layout L = layout(G, Dk, Dv, page, ts, S, R, (int)sizeof(T));
  cg::cluster_group cluster = cg::this_cluster();
  // This block has started; waited for before the first remote store.
  if (S > 1) cluster_arrive_relaxed();

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* vbar = kbar + R;
  int* pids = reinterpret_cast<int*>(smem + L.pids);
  double* qd = reinterpret_cast<double*>(smem + L.qd);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  double* pd = reinterpret_cast<double*>(smem + L.pd);
  float* in_m = reinterpret_cast<float*>(smem + L.in_m);
  float* in_l = reinterpret_cast<float*>(smem + L.in_l);
  float* in_acc = reinterpret_cast<float*>(smem + L.in_acc);
  T* kring = reinterpret_cast<T*>(smem + L.kring);
  T* vring = reinterpret_cast<T*>(smem + L.vring);
  const int kslot = (int)(L.kslot / sizeof(T));  // elements of a slot
  const int vslot = (int)(L.vslot / sizeof(T));
  const int Dkp = padded_dk(Dk, (int)sizeof(T));  // K row pitch in the ring
  K4_MARK(0);  // the first round trip

  // Staging: the length, the split's page ids and q in one round trip,
  // then the first R live pages of K and of V, all in flight together.
  const int32_t* pt_row = pt + (long long)b * pt_stride + (long long)s * ts;
  if (tid == 0) {
    for (int r = 0; r < R; ++r) {
      mbar_init(&kbar[r], kHalf);
      mbar_init(&vbar[r], kHalf);
    }
  }
  const int live = min(max(lengths[b] - s * span, 0), span);
  for (int i = tid; i < ts; i += kThreads) {
    const int pid = pt_row[i];
    pids[i] = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  }
  const long long q0 = ((long long)b * H + (long long)k * G) * Dk;
  // q as double, dim d of head g at ((g*NC + c)*kVec/2 + e)*8 + sl (as
  // double2, component d & 1), where d = kVec*(sl + 8c) + 2e + (d & 1).
  const int NC = q_chunks(Dk, (int)sizeof(T));
  for (int g = 0; g < G; ++g)
    for (int d = tid; d < NC * 8 * kVec; d += kThreads) {
      const long long qi = q0 + (long long)g * Dk + (d < Dk ? d : 0);
      const float x = q_bf16
          ? to_f32(static_cast<const __nv_bfloat16*>(qv)[qi])
          : static_cast<const float*>(qv)[qi];
      const int c = d / (8 * kVec), sl = (d / kVec) % 8, e = (d % kVec) / 2;
      qd[(((g * NC + c) * (kVec / 2) + e) * 8 + sl) * 2 + (d & 1)] =
          d < Dk ? (double)x : 0.0;
    }
  // Threads [0, kHalf) stage K, threads [kHalf, kThreads) stage V.
  const bool stage_k = tid < kHalf;
  const int th = tid % kHalf;
  const CopyLane cl = copy_lane<T>(stage_k ? Dk : Dv, th);
  const int n = (live + page - 1) / page;   // live pages of the split
  __syncthreads();  // barriers initialized, page ids and q in place
  K4_MARK(1);  // issuing the copies
  for (int i = 0; i < min(n, R); ++i) {
    if (stage_k)
      stage_page(kring + i * kslot, Dkp, kp, &kbar[i], pids[i],
                 min(page, live - i * page), k, Hkv, Dk, page, vec, cl, th);
    else
      stage_page(vring + i * vslot, Dv, vp, &vbar[i], pids[i],
                 min(page, live - i * page), k, Hkv, Dv, page, vec, cl, th);
  }

  K4_MARK(2);
  // Pass 1: the split's scores. Lanes 8p..8p+7 of a warp take one
  // position (the warp four, the block sixteen at a time); lane sl reads
  // 16-byte vectors sl, sl+8, ... of its row and of q, and three shuffle
  // levels reduce the G dots.
  {
    const int jl = tid / 8, sl = tid % 8;
    for (int i = 0; i < n; ++i) {
      const int slot = i % R, rows = min(page, live - i * page);
      mbar_wait(&kbar[slot], (i / R) & 1);
      const T* kt = kring + slot * kslot;
      for (int r0 = 0; r0 < rows; r0 += kThreads / 8) {
        const int r = r0 + jl;
        const T* krow = kt + min(r, rows - 1) * Dkp;
        double dot[MAXG][2];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) dot[g][0] = dot[g][1] = 0.0;
        // No branch: a vector past Dkp reads vector 0 and counts as zero,
        // a head past G reads head 0 and is dropped below.
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int d0 = kVec * (sl + 8 * c);
          const bool ok = d0 < Dkp;
          const int dc = ok ? d0 : 0;
          float kf[kVec];
          unpack(*reinterpret_cast<const uint4*>(krow + dc), kf);
          double kd[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) kd[e] = ok ? (double)kf[e] : 0.0;
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            const double2* qg = reinterpret_cast<const double2*>(qd) +
                                ((g < G ? g : 0) * NC + (c < NC ? c : 0)) *
                                    (kVec / 2) * 8 + sl;
#pragma unroll
            for (int e = 0; e < kVec / 2; ++e) {
              const double2 qq = qg[8 * e];
              dot[g][0] += qq.x * kd[2 * e];
              dot[g][1] += qq.y * kd[2 * e + 1];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            double v = dot[g][0] + dot[g][1];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            if (sl == 0 && r < rows)
              sc[g * span + i * page + r] =
                  __fmul_rn(__double2float_rn(v), scale);
          }
        }
      }
      if (i + R < n) {  // refill the slot with page i + R
        __syncthreads();
        if (stage_k)
          stage_page(kring + slot * kslot, Dkp, kp, &kbar[slot], pids[i + R],
                     min(page, live - (i + R) * page), k, Hkv, Dk, page, vec,
                     cl, th);
      }
    }
  }
  K4_MARK(3);  // softmax
  if (S > 1) cluster_wait();  // every split block has started
  __syncthreads();

  // The split's max per head, then p = exp(score - m) (kept as double for
  // pass 2) and l; warp w owns heads w, w + kWarps, ... A dead split leaves
  // (NEG, 0). Lane r < S stores (m, l) into split block r's inbox.
  for (int g = warp; g < G; g += kWarps) {
    const float* sg = sc + g * span;
    double* pg = pd + g * span;
    float m = kNeg;
    for (int j = lane; j < live; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    double l = 0.0;
    for (int j = lane; j < live; j += 32) {
      const double p = (double)expf(__fsub_rn(sg[j], m));
      pg[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane < S) {
      float* im = S > 1 ? cluster.map_shared_rank(in_m, lane) : in_m;
      float* il = S > 1 ? cluster.map_shared_rank(in_l, lane) : in_l;
      im[s * G + g] = m;
      il[s * G + g] = __double2float_rn(l);
    }
  }
  __syncthreads();

  K4_MARK(4);
  // Pass 2: acc = sum_j p[j] * V[j]. Thread t of row group t / kHalf owns
  // features t % kHalf + kHalf*c and takes every other position of the
  // split, U at a time: their loads first (a position past the page's end
  // reads its last row and adds 0 * 0; heads past G are computed from head
  // 0 and dropped), then their products. The second group's sums join the
  // first's through shared memory; the first stores them, rounded to
  // float, into the inbox of the block that owns each output.
  constexpr int U = MAXG >= 8 ? 1 : 4;
  constexpr int NP = MAXG * DP <= 4 ? 2 : 1;  // partial sums per output
  const int grp = tid / kHalf;
  double acc[MAXG][DP][NP];
  int dcl[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const int d = th + kHalf * c;
    dcl[c] = d < Dv ? d : 0;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int h = 0; h < NP; ++h) acc[g][c][h] = 0.0;
  }
  for (int i = 0; i < n; ++i) {
    const int slot = i % R, rows = min(page, live - i * page);
    mbar_wait(&vbar[slot], (i / R) & 1);
    const T* vt = vring + slot * vslot;
    const double* pg = pd + i * page;
    for (int r0 = grp; r0 < rows; r0 += 2 * U) {
      double v[U][DP], p[U][MAXG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool rok = r0 + 2 * u < rows;
        const int r = rok ? r0 + 2 * u : rows - 1;
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          const double x = (double)to_f32(vt[r * Dv + dcl[c]]);
          v[u][c] = rok ? x : 0.0;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const double x = pg[(g < G ? g : 0) * span + r];
          p[u][g] = rok ? x : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < DP; ++c)
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            acc[g][c][u % NP] += p[u][g] * v[u][c];
    }
    if (i + R < n) {
      __syncthreads();
      if (!stage_k)
        stage_page(vring + slot * vslot, Dv, vp, &vbar[slot], pids[i + R],
                   min(page, live - (i + R) * page), k, Hkv, Dv, page, vec,
                   cl, th);
    }
  }
  double* xs = reinterpret_cast<double*>(smem + L.xs);
  if (grp == 1)
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const int d = th + kHalf * c;
        double a = acc[g][c][0];
#pragma unroll
        for (int h = 1; h < NP; ++h) a += acc[g][c][h];
        if (g < G && d < Dv) xs[g * Dv + d] = a;
      }
  __syncthreads();
  if (grp == 0)
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const int d = th + kHalf * c;
        if (g < G && d < Dv) {
          double a = acc[g][c][0];
#pragma unroll
          for (int h = 1; h < NP; ++h) a += acc[g][c][h];
          a += xs[g * Dv + d];
          const int e = g * Dv + d, owner = e / L.per;
          float* ia = S > 1 ? cluster.map_shared_rank(in_acc, owner) : in_acc;
          ia[s * L.per + e - owner * L.per] = __double2float_rn(a);
        }
      }

  K4_MARK(5);
  // Combine: after the barrier every split's state for this block's
  // outputs [s*per, s*per + per) is in its own inbox; reduce in split
  // order 0..S-1.
  if (S > 1) cluster.sync(); else __syncthreads();
  const int E = G * Dv, lo = s * L.per, hi = min(E, lo + L.per);
#pragma unroll 2
  for (int e = lo + tid; e < hi; e += kThreads) {
    const int g = e / Dv;
    float mr[kMaxCluster];
    float m_star = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = in_m[(r < S ? r : 0) * G + g];
      if (r < S) m_star = fmaxf(m_star, mr[r]);
    }
    double l_star = 0.0, a_star = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const int rr = r < S ? r : 0;
      const double lr = (double)in_l[rr * G + g];
      const double ar = (double)in_acc[rr * L.per + e - lo];
      if (r < S) {
        const double alpha = (double)expf(__fsub_rn(mr[r], m_star));
        l_star += lr * alpha;
        a_star += ar * alpha;
      }
    }
    out[((long long)b * H + (long long)k * G) * Dv + e] =
        __fdiv_rn(__double2float_rn(a_star),
                  fmaxf(__double2float_rn(l_star), 1e-30f));
  }
  K4_MARK(6);
}

template <int MAXG, bool WIDE, typename T>
int launch(const void* q, const void* kp, const void* vp, const int32_t* pt,
           const int32_t* lengths, float* out, int B, int H, int Hkv, int Dk,
           int Dv, int P, int page, int ts, int S, int R, long long pt_stride,
           float scale, int q_bf16, int vec, int smem, cudaStream_t st) {
  auto kernel = gqa_decode_kernel<MAXG, WIDE, T>;
  static int attr_bytes = 48 * 1024;  // the largest dynamic size granted
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)Hkv, (unsigned)B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;  // one split needs no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const T*>(kp), static_cast<const T*>(vp),
      pt, lengths, out, H, Hkv, H / Hkv, Dk, Dv, P, page, ts, R, pt_stride,
      scale, q_bf16, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool WIDE, typename T>
int launch_g(int G, const void* q, const void* kp, const void* vp,
             const int32_t* pt, const int32_t* lengths, float* out, int B,
             int H, int Hkv, int Dk, int Dv, int P, int page, int ts, int S,
             int R, long long pt_stride, float scale, int q_bf16, int vec,
             int smem, cudaStream_t st) {
#define REPRO_K4(MG)                                                          \
  return launch<MG, WIDE, T>(q, kp, vp, pt, lengths, out, B, H, Hkv, Dk, Dv, \
                             P, page, ts, S, R, pt_stride, scale, q_bf16,    \
                             vec, smem, st)
  if (G <= 1) REPRO_K4(1);
  if (G <= 2) REPRO_K4(2);
  if (G <= 4) REPRO_K4(4);
  if (G <= 8) REPRO_K4(8);
  REPRO_K4(16);
#undef REPRO_K4
}

template <typename T>
int launch_w(int G, const void* q, const void* kp, const void* vp,
             const int32_t* pt, const int32_t* lengths, float* out, int B,
             int H, int Hkv, int Dk, int Dv, int P, int page, int ts, int S,
             int R, long long pt_stride, float scale, int q_bf16, int vec,
             int smem, cudaStream_t st) {
  return (Dk > kMaxDim / 2 || Dv > kMaxDim / 2)
             ? launch_g<true, T>(G, q, kp, vp, pt, lengths, out, B, H, Hkv,
                                 Dk, Dv, P, page, ts, S, R, pt_stride, scale,
                                 q_bf16, vec, smem, st)
             : launch_g<false, T>(G, q, kp, vp, pt, lengths, out, B, H, Hkv,
                                  Dk, Dv, P, page, ts, S, R, pt_stride, scale,
                                  q_bf16, vec, smem, st);
}

}  // namespace

// q (B,H,Dk) bf16 (`q_bf16`) or f32; pools (P,page,Hkv,Dk|Dv) of
// `pool_bf16` ? bf16 : f32; pt (B, >= S*ts) int32 with row stride
// pt_stride; lengths (B,) int32; out (B,H,Dv) f32. S splits of ts pages in
// clusters of S, rings of R pages; `smem` is the wrapper's `k4_plan` size,
// which must equal this file's layout.
extern "C" int paged_attn_gqa(const void* q, const void* kp, const void* vp,
                              const void* pt, const void* lengths, void* out,
                              int B, int H, int Hkv, int Dk, int Dv, int P,
                              int page, int ts, int S, int R,
                              long long pt_stride, float scale, int pool_bf16,
                              int q_bf16, int smem, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      H / Hkv > kMaxG || Dk <= 0 || Dk > kMaxDim || Dv <= 0 ||
      Dv > kMaxDim || P <= 0 || page <= 0 || ts <= 0 || S <= 0 ||
      S > kMaxCluster || R <= 0 || R > ts)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv, isz = pool_bf16 ? 2 : 4;
  const Layout L = layout(G, Dk, Dv, page, ts, S, R, isz);
  if (L.total != (long long)smem || L.total > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need rows of 16-byte multiples and 16-byte aligned
  // pools (the row stride Hkv*D*isz is then one too).
  const int vec = (Dk * isz) % 16 == 0 && (Dv * isz) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ptv = static_cast<const int32_t*>(pt);
  const int32_t* lv = static_cast<const int32_t*>(lengths);
  float* of = static_cast<float*>(out);
  return pool_bf16
             ? launch_w<__nv_bfloat16>(G, q, kp, vp, ptv, lv, of, B, H, Hkv,
                                       Dk, Dv, P, page, ts, S, R, pt_stride,
                                       scale, q_bf16, vec, smem, st)
             : launch_w<float>(G, q, kp, vp, ptv, lv, of, B, H, Hkv, Dk, Dv,
                               P, page, ts, S, R, pt_stride, scale, q_bf16,
                               vec, smem, st);
}

#ifdef K4_PHASE_CLOCKS
// Copies the phase clocks of the last launch into dst (kClockBlocks x 8
// int64).
extern "C" int paged_attn_gqa_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k4_clocks, sizeof(k4_clocks));
}
#endif
