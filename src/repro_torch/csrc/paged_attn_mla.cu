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
// bitwise whatever order each sums in (but at a float32 rounding tie).
// The exponentials and elementwise steps are the plain version's float
// operations (expf, round-to-nearest products, differences and the
// division). The softmax is two-pass: every score of the split, then m,
// then p; no online rescaling. No fast-math.
//
// A split with no live position keeps the reference's masked state
// (m = NEG = -0.7*FLT_MAX, l = 0, acc = 0), so a length-0 row comes out as
// exact zeros. Masked positions are SKIPPED, not loaded: only the rows of
// positions below lengths[b] are copied, so pages past a row's length (the
// trash page 0 included) are never read, which also makes a page-table
// prefix covering every row's length (the engine's kv_cap) neutral.
//
// Bound. At the serving decode shape (4 rows, 128 heads, C = 512, R = 64,
// 16-token bf16 pages) the function reads the live latent and rope rows
// (1152 bytes a position), q and writes out (~1 MB each), and does
// 2*H*(C+R+C) flops a position: at ~260 live positions the flops at the
// f32 rate (~1.1 us) bind over the bytes (~0.7 us). The contract's sums
// run on the FP64 pipe (64 fused multiply-adds a clock per SM). What holds
// a block is a chain of latencies: the ~34 KB of q a block of 16 heads
// reads arrive ~9k SM cycles after their loads issue, and each pass over a
// page takes 5-7k cycles (launch/profile_k5.py), so the design spends as
// few round trips, barriers and instructions as it can.
//
// Design. One launch per call: a grid of (S, ceil(H/HG), B) blocks of 256
// threads, HG <= 16 query heads a block; the S split blocks of one (head
// group, row) form one thread-block cluster (S <= 8, the portable size;
// S = 1 launches without a cluster). Indices are clamped into range and
// only the arithmetic is predicated, never branched around, so that the
// compiler can issue loads ahead of the float64 chains that consume them.
//  - Staging. The threads issue the loads of lengths[b], the split's page
//    ids and q together (q in 16-byte chunks where its rows allow, else
//    element by element); as soon as the page ids are in shared memory they
//    copy the live latent and rope rows of the split's pages into a ring of
//    page slots with 16-byte cp.async copies, every thread's copies of a
//    page completing on the slot's mbarrier, and only then convert q to
//    double (each element once), so that the rows and q travel together. A
//    slot row holds the latent, then the rope (each padded to whole 16-byte
//    vectors, and one vector more so that rows start on other banks): a
//    position's C+R features lie in one row. Pass 1 and pass 2 both read
//    the staged rows: while the ring holds the whole split, each latent row
//    is read from device memory once. A split longer than the ring (S <= 4
//    at long tables) stages its latents a second time for pass 2 on the
//    same barriers (`k5_plan` sizes the ring; `k5_ring_schedule` spells out
//    the order). Rows that are not 16-byte multiples, or pools that are not
//    16-byte aligned, are copied with plain loads on the same barriers.
//  - Pass 1: sixteen positions at a time, thread (position j, vector group
//    vg) converts its 16-byte vectors vg, vg+16, ... of row j to double and
//    dots them with q for every head of the group (q read from shared
//    memory, two addresses a warp); the vector loop is rolled, which keeps
//    its body small. The 16 partial dots of a head meet in one shuffle (a
//    reduce-scatter over the warp's two vector groups) and a sum over the 8
//    warps in shared memory.
//  - Softmax: warp w owns heads w, w+8: max, p = exp(score - m) (kept as
//    double, so pass 2 converts no p) and l, with warp reductions only;
//    lane r < S stores (m, l) into split block r's inbox.
//  - Pass 2: thread t owns latent features 2t, 2t+1 for every head of the
//    group and walks the split's positions, p read as broadcast 16-byte
//    pairs. With one split the combine is the identity and pass 2 writes
//    out itself. A thread's two outputs of a head go out as one 8-byte
//    store (to the owner's inbox over distributed shared memory, or to out).
//  - Combine: each block stores its acc, rounded to float as the plain
//    split state, into the shared memory of the split block that owns those
//    outputs (block s owns outputs [s*per, (s+1)*per) of the HG*C); after
//    one cluster barrier the owner computes each head's exp(m_s - m*) and
//    l* once, then reduces every output in split order 0..S-1 from its own
//    shared memory and writes out. No scratch in device memory, no atomics:
//    two calls are bitwise equal.
#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                 // positions of a pass-1 chunk
constexpr int kGroups = kThreads / kRows; // vector groups of pass 1
constexpr int kMaxHG = 16;                // query heads a block
constexpr int kMaxC = 512;                // latent width C <= kMaxC
constexpr int kMaxR = 128;                // rope width R <= kMaxR
constexpr int kDP = 2;                    // latent features a thread, pass 2
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr long long kSmemLimit = 232448;  // 227 KB a block
constexpr float kNeg = -0.7f * FLT_MAX;
static_assert(kDP * kThreads >= kMaxC, "pass 2 covers the latent");

#ifdef K5_PHASE_CLOCKS
// Built with -DK5_PHASE_CLOCKS by launch/profile_k5.py only: thread 0 of
// each of the first kClockBlocks blocks records clock64() as it enters each
// phase, and once more as it leaves.
constexpr int kClockBlocks = 4096;
__device__ long long k5_clocks[kClockBlocks][8];
#define K5_MARK(i)                                                         \
  do {                                                                     \
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +     \
                    blockIdx.x;                                            \
    if (threadIdx.x == 0 && blk < kClockBlocks)                            \
      k5_clocks[blk][i] = clock64();                                       \
  } while (0)
#else
#define K5_MARK(i) \
  do {             \
  } while (0)
#endif

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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The pool elements of a 16-byte vector, as floats (exact).
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

// Two neighbouring pool elements as floats (exact).
__device__ __forceinline__ void load_pair(const float* p, float (&f)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  f[0] = x.x;
  f[1] = x.y;
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* p,
                                          float (&f)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// x[i] = q[idx[i]] as float for a bf16 (`bf16`) or f32 q, every load
// issued before any is used.
template <int N>
__device__ __forceinline__ void gather_f32(const void* q, int bf16,
                                           const long long (&idx)[N],
                                           float (&x)[N]) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(q);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[idx[i]]);
  } else {
    const float* p = static_cast<const float*>(q);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[idx[i]];
  }
}

// The 4 f32 or 8 bf16 (`bf16`) values of a 16-byte chunk, as doubles at
// dst (16-byte aligned).
__device__ __forceinline__ void store_chunk(double* dst, uint4 raw, int bf16) {
  double2* d = reinterpret_cast<double2*>(dst);
  if (bf16) {
    float f[8];
    unpack(raw, f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_double2((double)f[2 * i], (double)f[2 * i + 1]);
  } else {
    float f[4];
    unpack(raw, f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      d[i] = make_double2((double)f[2 * i], (double)f[2 * i + 1]);
  }
}

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) & ~15LL;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The compiled head count for HG heads a block (heads past HG are computed
// from head 0 and dropped).
__host__ __device__ inline int max_g(int HG) {
  return HG <= 4 ? 4 : (HG <= 8 ? 8 : kMaxHG);
}

// Shared-memory layout of a block, in bytes from the dynamic base; every
// region starts on 16 bytes. kernels/paged_attn.py's `_k5_smem` mirrors it
// (the entry point checks that the two agree).
struct Layout {
  long long bars, pids, qd, pd, red, in_m, in_l, in_acc, ring, slot, total;
  int per;    // outputs each split block reduces: ceil(HG*C / S)
  int cp;     // C padded to whole 16-byte vectors of pool elements
  int d2;     // features of a staged row: cp + R padded likewise
  int pitch;  // elements between staged rows: d2 and one vector
  int pp;     // doubles between the positions' p (and scores)
};

__host__ __device__ inline Layout layout(int HG, int C, int R, int page,
                                         int ts, int S, int ring, int isz) {
  Layout L;
  const int vec = 16 / isz;
  const long long span = (long long)ts * page;
  L.cp = round_up(C, vec);
  L.d2 = L.cp + round_up(R, vec);
  L.pitch = L.d2 + vec;  // one vector more: rows start on other banks
  L.pp = max_g(HG) + 2;
  L.per = (HG * C + S - 1) / S;
  long long o = 0;
  L.bars = o;   o += align16(8LL * ring);                // a slot's mbarrier
  L.pids = o;   o += align16(4LL * ts);                  // the split's pages
  L.qd = o;     o += align16(8LL * HG * L.d2);           // q as double
  L.pd = o;     o += align16(8LL * span * L.pp);         // scores, then p
  L.red = o;    o += align16(8LL * kWarps * max_g(HG) * kRows);  // pass 1
  L.in_m = o;   o += align16(4LL * S * HG);              // the splits' m,
  L.in_l = o;   o += align16(4LL * S * HG);              // l and acc for
  L.in_acc = o; o += align16(4LL * S * L.per);           // this block's outputs
  L.slot = align16((long long)page * L.pitch * isz);
  L.ring = o;   o += ring * L.slot;
  L.total = o;
  return L;
}

// How a thread takes part in staging rows of D elements with 16-byte
// copies: rows r0, r0 + step, ... at element offset e (inactive when
// r0 >= step). Computed once per block.
struct CopyLane {
  int r0, e, step;
};

template <typename T>
__device__ __forceinline__ CopyLane copy_lane(int D, int tid) {
  // Copies per row, 1 to 128 (D / kVec is 0 only where no copy is made).
  const int per_row = max(1, D / (16 / (int)sizeof(T)));
  return {tid / per_row, (tid % per_row) * (16 / (int)sizeof(T)),
          kThreads / per_row};
}

// Every thread stages its share of the `rows` live rows of page `pid` into
// a ring slot (latent at [0, C), rope at [cp, cp+R) of each row, `pitch`
// elements apart) and arrives once on the slot's mbarrier: with 16-byte
// cp.async copies (arriving when its own copies land), or else with plain
// loads and stores that also zero the padding. Pass 2's second staging of
// a page (`rope` false) copies the latent only.
template <typename T>
__device__ __forceinline__ void stage_page(T* dst, const T* cpool,
                                           const T* rpool, uint64_t* bar,
                                           int pid, int rows, bool rope,
                                           int C, int R, int page,
                                           const Layout& L, bool vec,
                                           CopyLane cl, CopyLane rl, int tid) {
  const T* csrc = cpool + (long long)pid * page * C;
  const T* rsrc = rpool + (long long)pid * page * R;
  if (vec) {
    if (cl.r0 < cl.step)
      for (int r = cl.r0; r < rows; r += cl.step)
        cp_async16(dst + r * L.pitch + cl.e, csrc + (long long)r * C + cl.e);
    if (rope && R > 0 && rl.r0 < rl.step)
      for (int r = rl.r0; r < rows; r += rl.step)
        cp_async16(dst + r * L.pitch + L.cp + rl.e,
                   rsrc + (long long)r * R + rl.e);
    mbar_arrive_cp_async(bar);
  } else {
#pragma unroll 1
    for (int i = tid; i < rows * L.d2; i += kThreads) {
      const int r = i / L.d2, d = i - r * L.d2;
      T x = T(0.0f);
      if (d < C) x = csrc[(long long)r * C + d];
      else if (d >= L.cp && d < L.cp + R)
        x = rsrc[(long long)r * R + d - L.cp];
      if (rope || d < L.cp) dst[r * L.pitch + d] = x;
    }
    mbar_arrive(bar);
  }
}

template <int MAXG, typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const void* __restrict__ qlv, const void* __restrict__ qrv,
                  const T* __restrict__ cpool, const T* __restrict__ rpool,
                  const int32_t* __restrict__ pt,
                  const int32_t* __restrict__ lengths, float* __restrict__ out,
                  int H, int HG, int C, int R, int P, int page, int ts,
                  int ring, long long pt_stride, long long ql_sb,
                  long long ql_sh, long long qr_sb, long long qr_sh,
                  float scale, int ql_bf16, int qr_bf16, int vec,
                  int qvec) {
  constexpr int kVec = 16 / sizeof(T);             // pool elements in 16 B
  const int s = blockIdx.x, b = blockIdx.z, S = gridDim.x;
  const int h0 = blockIdx.y * HG;
  const int G = min(HG, H - h0);                   // heads of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int span = ts * page;                      // positions of one split
  const Layout L = layout(HG, C, R, page, ts, S, ring, (int)sizeof(T));
  cg::cluster_group cluster = cg::this_cluster();
  // This block has started; waited for before the first remote store.
  if (S > 1) cluster_arrive_relaxed();

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* pids = reinterpret_cast<int*>(smem + L.pids);
  double* qd = reinterpret_cast<double*>(smem + L.qd);
  double* pd = reinterpret_cast<double*>(smem + L.pd);
  float* scf = reinterpret_cast<float*>(smem + L.pd);  // score in p's slot
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* in_m = reinterpret_cast<float*>(smem + L.in_m);
  float* in_l = reinterpret_cast<float*>(smem + L.in_l);
  float* in_acc = reinterpret_cast<float*>(smem + L.in_acc);
  T* ringp = reinterpret_cast<T*>(smem + L.ring);
  const int slot_elems = (int)(L.slot / sizeof(T));
  const int d2 = L.d2, pp = L.pp;
  K5_MARK(0);  // the first round trip

  // Staging. One round trip brings lengths[b], the split's page ids and q
  // (every load issued before any is used: heads past G and features past C
  // or R load element 0 and are not stored); the first ring's copies are
  // issued as soon as the page ids are in shared memory, before q is
  // converted, so that the rows and q travel together.
  if (tid == 0) {
#pragma unroll 1
    for (int r = 0; r < ring; ++r) mbar_init(&bar[r], kThreads);
  }
  const int len_b = lengths[b];
  const int32_t* pt_row = pt + (long long)b * pt_stride + (long long)s * ts;
  const int pid0 = pt_row[tid < ts ? tid : 0];
  constexpr int QL = kMaxC / kThreads;
  float xl[MAXG * QL], xr[MAXG];
  // With `qvec` (rows of 16-byte multiples on 16-byte boundaries), the
  // threads take q in 16-byte chunks instead: a quarter of the requests.
  constexpr int QV = kMaxHG * kMaxC * 4 / 16 / kThreads;   // latent chunks
  constexpr int RV = kMaxHG * kMaxR * 4 / 16 / kThreads;   // rope chunks
  const int qls = ql_bf16 ? 2 : 4, qrs = qr_bf16 ? 2 : 4;
  const int lpr = C * qls / 16, rpr = R * qrs / 16;        // chunks a row
  uint4 vl[QV], vr[RV];
  if (qvec) {
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int i = tid + kThreads * j, g = i / lpr;
      if (g < G)
        vl[j] = reinterpret_cast<const uint4*>(
            static_cast<const uint8_t*>(qlv) +
            ((long long)b * ql_sb + (long long)(h0 + g) * ql_sh) * qls)[i - g * lpr];
    }
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      const int i = tid + kThreads * j, g = rpr > 0 ? i / rpr : G;
      if (g < G)
        vr[j] = reinterpret_cast<const uint4*>(
            static_cast<const uint8_t*>(qrv) +
            ((long long)b * qr_sb + (long long)(h0 + g) * qr_sh) * qrs)[i - g * rpr];
    }
  } else {
    long long li[MAXG * QL], ri[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const long long h = h0 + (g < G ? g : 0);
#pragma unroll
      for (int k = 0; k < QL; ++k) {
        const int d = tid + kThreads * k;
        li[g * QL + k] = (long long)b * ql_sb + h * ql_sh + (d < C ? d : 0);
      }
      ri[g] = (long long)b * qr_sb + h * qr_sh + (tid < R ? tid : 0);
    }
    gather_f32(qlv, ql_bf16, li, xl);
    if (R > 0) gather_f32(qrv, qr_bf16, ri, xr);
  }
#pragma unroll 1
  for (int i = tid; i < ts; i += kThreads) {
    const int pid = i == tid ? pid0 : pt_row[i];
    pids[i] = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  }
  const int live = min(max(len_b - s * span, 0), span);
  const CopyLane cl = copy_lane<T>(C, tid), rl = copy_lane<T>(R, tid);
  const int n = (live + page - 1) / page;     // live pages of the split
  // Stagings: pages 0..n-1 with their rope rows for pass 1, then, when the
  // split outgrows the ring, pages 0..n-1 again (latent only) for pass 2.
  // Staging k fills slot k % ring, completing phase k / ring of its barrier.
  const int n_stage = n <= ring ? n : 2 * n;
  auto stage = [&](int k) {
    const int i = k < n ? k : k - n;
    stage_page(ringp + (k % ring) * slot_elems, cpool, rpool,
               &bar[k % ring], pids[i], min(page, live - i * page), k < n, C,
               R, page, L, vec != 0, cl, rl, tid);
  };
  __syncthreads();  // barriers initialized, page ids in place
  K5_MARK(1);  // issuing the copies, q to double
  for (int k = 0; k < min(n_stage, ring); ++k) stage(k);
  // q of head g at qd[g*d2 + d]: the latent at d < C, the rope at
  // [cp, cp+R), zeros between and after, as the staged rows.
  if (qvec) {
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int i = tid + kThreads * j, g = i / lpr;
      if (g < G) store_chunk(qd + g * d2 + (i - g * lpr) * (16 / qls), vl[j],
                             ql_bf16);
    }
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      const int i = tid + kThreads * j, g = rpr > 0 ? i / rpr : G;
      if (g < G)
        store_chunk(qd + g * d2 + L.cp + (i - g * rpr) * (16 / qrs), vr[j],
                    qr_bf16);
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      double* qg = qd + g * d2;
      if (!qvec) {
#pragma unroll
        for (int k = 0; k < QL; ++k) {
          const int d = tid + kThreads * k;
          if (d < C) qg[d] = (double)xl[g * QL + k];
        }
        if (tid < R) qg[L.cp + tid] = (double)xr[g];
      }
      for (int d = C + tid; d < L.cp; d += kThreads) qg[d] = 0.0;
      for (int d = L.cp + R + tid; d < d2; d += kThreads) qg[d] = 0.0;
    }
  }
  __syncthreads();  // q in place

  K5_MARK(2);
  // Pass 1: the split's scores, kRows positions at a time. Thread (jl, vg)
  // takes vectors vg, vg + kGroups, ... of row jl; lanes l and l ^ 16 share
  // jl and hold neighbouring vector groups.
  {
    constexpr int GH = MAXG / 2;           // heads kept per lane
    const int jl = tid % kRows, vg = tid / kRows;
    const bool hi = lane >= 16;
    const int NV = d2 / kVec;
    for (int i = 0; i < n; ++i) {
      const int slot = i % ring, rows = min(page, live - i * page);
      mbar_wait(&bar[slot], (i / ring) & 1);
      const T* pg = ringp + slot * slot_elems;
      for (int r0 = 0; r0 < rows; r0 += kRows) {
        const T* row = pg + min(r0 + jl, rows - 1) * L.pitch;
        double part[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) part[g] = 0.0;
        // One vector a step, rolled: the body stays small enough for the
        // instruction cache.
#pragma unroll 1
        for (int v = vg; v < NV; v += kGroups) {
          float f[kVec];
          unpack(*reinterpret_cast<const uint4*>(row + v * kVec), f);
          double kd[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) kd[e] = (double)f[e];
#pragma unroll
          for (int e = 0; e < kVec / 2; ++e)
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              const double2 q2 = reinterpret_cast<const double2*>(
                  qd + (g < G ? g : 0) * d2 + v * kVec)[e];
              part[g] += q2.x * kd[2 * e];
              part[g] += q2.y * kd[2 * e + 1];
            }
        }
        // Lanes below 16 keep heads [0, GH), the others [GH, MAXG), each
        // summed over both vector groups; then the warps' sums meet in red.
        double* rw = red + warp * MAXG * kRows;
#pragma unroll
        for (int k = 0; k < GH; ++k) {
          const double give = hi ? part[k] : part[k + GH];
          const double mine = hi ? part[k + GH] : part[k];
          rw[((hi ? GH : 0) + k) * kRows + jl] =
              mine + __shfl_xor_sync(0xffffffffu, give, 16);
        }
        __syncthreads();
        if (tid < MAXG * kRows) {
          const int g = tid / kRows, j = tid % kRows;
          double dot = 0.0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            dot += red[(w * MAXG + g) * kRows + j];
          if (g < G && r0 + j < rows)
            scf[2 * ((i * page + r0 + j) * pp + g)] =
                __fmul_rn(__double2float_rn(dot), scale);
        }
        __syncthreads();  // red and the slot's rows are free again
      }
      if (i + ring < n_stage) stage(i + ring);  // refill the slot
    }
  }
  K5_MARK(3);  // softmax
  if (S > 1) cluster_wait();  // every split block has started
  __syncthreads();

  // The split's max per head, then p = exp(score - m) (as double, in the
  // score's slot) and l; warp w owns heads w, w + kWarps. A dead split
  // leaves (NEG, 0). Lane r < S stores (m, l) into split block r's inbox.
  for (int g = warp; g < G; g += kWarps) {
    float m = kNeg;
    for (int j = lane; j < live; j += 32) m = fmaxf(m, scf[2 * (j * pp + g)]);
    m = warp_max(m);
    double l = 0.0;
    for (int j = lane; j < live; j += 32) {
      const double p = (double)expf(__fsub_rn(scf[2 * (j * pp + g)], m));
      pd[j * pp + g] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane < S) {
      float* im = S > 1 ? cluster.map_shared_rank(in_m, lane) : in_m;
      float* il = S > 1 ? cluster.map_shared_rank(in_l, lane) : in_l;
      im[s * HG + g] = m;
      il[s * HG + g] = __double2float_rn(l);
    }
  }
  __syncthreads();

  K5_MARK(4);
  // Pass 2: acc = sum_j p[j] * c_kv[j]. Thread t owns latent features 2t
  // and 2t + 1 for every head and takes the split's positions U at a time:
  // their loads first (a position past the page's end reads its last row
  // and adds p * 0, p finite; heads past G read other heads' p and are
  // dropped), then their products. The sums go, rounded to float, into the
  // inbox of the block that owns each output.
  constexpr int U = 2;
  const int d0 = kDP * tid;
  const int dcl = d0 < L.cp ? d0 : 0;  // cp is even, so d0 + 1 < cp too
  double acc[MAXG][kDP];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int c = 0; c < kDP; ++c) acc[g][c] = 0.0;
  const bool again = n > ring;   // the latents were staged a second time
  for (int i = 0; i < n; ++i) {
    const int k = again ? n + i : i;
    const int slot = k % ring, rows = min(page, live - i * page);
    if (again) mbar_wait(&bar[slot], (k / ring) & 1);
    const T* pg = ringp + slot * slot_elems + dcl;
    const double* pi = pd + (long long)i * page * pp;
#pragma unroll 2
    for (int r0 = 0; r0 < rows; r0 += U) {
      double v[U][kDP], p[U][MAXG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool rok = r0 + u < rows;
        const int r = rok ? r0 + u : rows - 1;
        float f[kDP];
        load_pair(pg + r * L.pitch, f);
#pragma unroll
        for (int c = 0; c < kDP; ++c) v[u][c] = rok ? (double)f[c] : 0.0;
#pragma unroll
        for (int g = 0; g < MAXG; g += 2) {
          const double2 x =
              reinterpret_cast<const double2*>(pi + r * pp)[g / 2];
          p[u][g] = x.x;
          p[u][g + 1] = x.y;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < kDP; ++c)
#pragma unroll
          for (int g = 0; g < MAXG; ++g) acc[g][c] += p[u][g] * v[u][c];
    }
    if (again && i + ring < n) {
      __syncthreads();
      stage(n + i + ring);
    }
  }
  // A thread's two features go out as one 8-byte pair where C and the
  // owners' shares are even (they then never straddle a row or an owner).
  const bool pairs = C % 2 == 0 && L.per % 2 == 0 && d0 < C;
  if (S == 1) {
    // One split: the combine is the identity (a = exp(m - m) = 1), so out
    // is acc, rounded to float, over max(l, 1e-30) (in_l holds l).
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float lg = fmaxf(in_l[g], 1e-30f);
        float o[kDP];
#pragma unroll
        for (int c = 0; c < kDP; ++c)
          o[c] = __fdiv_rn(__double2float_rn(acc[g][c]), lg);
        float* og = out + ((long long)b * H + h0 + g) * C + d0;
        if (pairs) {
          *reinterpret_cast<float2*>(og) = make_float2(o[0], o[1]);
        } else {
#pragma unroll
          for (int c = 0; c < kDP; ++c)
            if (d0 + c < C) og[c] = o[c];
        }
      }
    }
    K5_MARK(5);
    K5_MARK(6);
    return;
  }
  const float inv_per = 1.0f / (float)L.per;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      float o[kDP];
#pragma unroll
      for (int c = 0; c < kDP; ++c) o[c] = __double2float_rn(acc[g][c]);
#pragma unroll
      for (int c = 0; c < kDP; ++c) {
        const int d = d0 + c;
        if ((pairs && c == 0) || (!pairs && d < C)) {
          // owner = e / per (e < 2^13: the float estimate is off by <= 1)
          const int e = g * C + d;
          int owner = __float2int_rz((float)e * inv_per);
          owner += (owner + 1) * L.per <= e;
          owner -= owner * L.per > e;
          float* ia = cluster.map_shared_rank(in_acc, owner) + s * L.per + e -
                      owner * L.per;
          if (pairs)
            *reinterpret_cast<float2*>(ia) = make_float2(o[0], o[1]);
          else
            *ia = o[c];
        }
      }
    }
  }

  K5_MARK(5);
  // Combine: after the barrier every split's state for this block's
  // outputs [s*per, s*per + per) is in its own inbox. The per-head terms
  // (m*, a_r = exp(m_r - m*), l*) are computed once, into the free pass-1
  // scratch; then each output sums its splits in order 0..S-1.
  cluster.sync();
  double* alpha = red;                                   // HG x kMaxCluster
  float* lstar = reinterpret_cast<float*>(red + HG * kMaxCluster);  // HG
  if (tid < G) {
    float m_star = kNeg;
    for (int r = 0; r < S; ++r) m_star = fmaxf(m_star, in_m[r * HG + tid]);
    double l_star = 0.0;
    for (int r = 0; r < S; ++r) {
      const double a = (double)expf(__fsub_rn(in_m[r * HG + tid], m_star));
      alpha[tid * kMaxCluster + r] = a;
      l_star += (double)in_l[r * HG + tid] * a;
    }
    lstar[tid] = fmaxf(__double2float_rn(l_star), 1e-30f);
  }
  __syncthreads();
  const int E = G * C, lo = s * L.per, hi = min(E, lo + L.per);
  const float inv_c = 1.0f / (float)C;
#pragma unroll 4
  for (int e = lo + tid; e < hi; e += kThreads) {
    int g = __float2int_rz((float)e * inv_c);   // e / C, as the owner above
    g += (g + 1) * C <= e;
    g -= g * C > e;
    const double* ag = alpha + g * kMaxCluster;
    const float* ia = in_acc + e - lo;
    double a_star = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const int rr = r < S ? r : 0;
      const double x = (double)ia[rr * L.per] * ag[rr];
      if (r < S) a_star += x;
    }
    out[((long long)b * H + h0) * C + e] =
        __fdiv_rn(__double2float_rn(a_star), lstar[g]);
  }
  K5_MARK(6);
}

struct Args {
  const void *ql, *qr, *cp, *rp;
  const int32_t *pt, *lengths;
  float* out;
  int B, H, HG, C, R, P, page, ts, S, ring;
  long long pt_stride, ql_sb, ql_sh, qr_sb, qr_sh;
  float scale;
  int ql_bf16, qr_bf16, vec, qvec, smem;
};

template <int MAXG, typename T>
int launch(const Args& a, cudaStream_t st) {
  auto kernel = mla_decode_kernel<MAXG, T>;
  static int attr_bytes = 48 * 1024;  // the largest dynamic size granted
  if (a.smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = a.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.S, (unsigned)((a.H + a.HG - 1) / a.HG),
                     (unsigned)a.B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.S > 1 ? 1 : 0;  // one split needs no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, a.ql, a.qr, static_cast<const T*>(a.cp),
      static_cast<const T*>(a.rp), a.pt, a.lengths, a.out, a.H, a.HG, a.C,
      a.R, a.P, a.page, a.ts, a.ring, a.pt_stride, a.ql_sb, a.ql_sh, a.qr_sb,
      a.qr_sh, a.scale, a.ql_bf16, a.qr_bf16, a.vec, a.qvec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g(const Args& a, cudaStream_t st) {
  const int mg = max_g(a.HG);
  if (mg == 4) return launch<4, T>(a, st);
  if (mg == 8) return launch<8, T>(a, st);
  return launch<kMaxHG, T>(a, st);
}

}  // namespace

// q_lat (B,H,C) and q_rope (B,H,R), each bf16 (`ql_bf16`, `qr_bf16`) or
// f32, unit-strided along the last dim with batch and head strides
// (elements) ql_sb, ql_sh, qr_sb, qr_sh; pools (P,page,C) and (P,page,R) of
// `pool_bf16` ? bf16 : f32; pt (B, >= S*ts) int32 with row stride
// pt_stride; lengths (B,) int32; out (B,H,C) f32. HG heads a block, S
// splits of ts pages in clusters of S, a ring of `ring` page slots; `smem`
// is the wrapper's `k5_plan` size, which must equal this file's layout.
extern "C" int paged_attn_mla(const void* q_lat, const void* q_rope,
                              const void* cp, const void* rp, const void* pt,
                              const void* lengths, void* out, int B, int H,
                              int HG, int C, int R, int P, int page, int ts,
                              int S, int ring, long long pt_stride,
                              long long ql_sb, long long ql_sh,
                              long long qr_sb, long long qr_sh, float scale,
                              int pool_bf16, int ql_bf16, int qr_bf16,
                              int smem, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || HG <= 0 || HG > kMaxHG ||
      (H + HG - 1) / HG > 65535 || C <= 0 || C > kMaxC || R < 0 ||
      R > kMaxR || P <= 0 || page <= 0 || ts <= 0 || S <= 0 ||
      S > kMaxCluster || ring <= 0 || ring > ts)
    return (int)cudaErrorInvalidValue;
  const int isz = pool_bf16 ? 2 : 4;
  const Layout L = layout(HG, C, R, page, ts, S, ring, isz);
  if (L.total != (long long)smem || L.total > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need rows of 16-byte multiples and 16-byte aligned
  // pools (every row then starts on 16 bytes).
  const int vec = (C * isz) % 16 == 0 && (R * isz) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(cp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(rp) % 16 == 0;
  // q in 16-byte chunks: rows of 16-byte multiples on 16-byte boundaries
  // (q_lat f32 and q_rope bf16 at the serving shape).
  const int qls = ql_bf16 ? 2 : 4, qrs = qr_bf16 ? 2 : 4;
  const auto a16 = [](long long x) { return x % 16 == 0; };
  const int qvec =
      a16((long long)C * qls) && a16(reinterpret_cast<uintptr_t>(q_lat)) &&
      a16(ql_sb * qls) && a16(ql_sh * qls) &&
      (R == 0 || (a16((long long)R * qrs) &&
                  a16(reinterpret_cast<uintptr_t>(q_rope)) &&
                  a16(qr_sb * qrs) && a16(qr_sh * qrs)));
  const Args a{q_lat, q_rope, cp, rp, static_cast<const int32_t*>(pt),
               static_cast<const int32_t*>(lengths), static_cast<float*>(out),
               B, H, HG, C, R, P, page, ts, S, ring, pt_stride, ql_sb, ql_sh,
               qr_sb, qr_sh, scale, ql_bf16, qr_bf16, vec, qvec, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pool_bf16 ? launch_g<__nv_bfloat16>(a, st) : launch_g<float>(a, st);
}

#ifdef K5_PHASE_CLOCKS
// Copies the phase clocks of the last launch into dst (kClockBlocks x 8
// int64).
extern "C" int paged_attn_mla_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k5_clocks, sizeof(k5_clocks));
}
#endif
