// Exact 1-nearest-neighbour search and per-bucket nearest references for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   iggt_official_tpu/ops/nn1_pallas.py::nn1_pallas  (_nn1_kernel)
//   iggt_official_tpu/ops/nn1_pallas.py::bucket_topk_pallas  (_bucket_topk_kernel),
//   described after the nn1 kernels below
//
// What nn1 computes, for every query row q of a (Q, 8) fp32 matrix against a
// (R, 8) fp32 reference matrix:
//   d2(q, r) = sum over a = 0..7, in that order, of (q_a - r_a)^2, each
//              subtraction, square and addition rounded on its own (no FMA)
//   out[q]   = the smallest index r with the least d2 (int64)
// bit for bit what the plain PyTorch version (`ops/nn1.py::nn1_plain`) returns.
// The clustering pipeline runs it twice per scene: the noise reassignment
// (Q = noise points, R = clustered points of the <= 150k subsample) and the
// full-density backfill (Q = every pixel, up to 2.15M, R = the 150k subsample).
//
// Why the exact chain alone is slow.  It takes 3 fp32 operations per feature
// and pair that may not fuse (an FMA rounds once where the chain rounds twice,
// and flips picks), so 24 instructions per pair: 3.22e11 pairs at 2.15M x 150k
// are 7.7e12 instructions, 230.7 ms at one instruction per lane and cycle on
// 132 SMs x 128 lanes at 1.98 GHz.  That floor holds for any design that runs
// the chain on every pair.
//
// Design: a filter on the tensor cores, the exact chain only where it can
// matter.  |q|^2 + |r|^2 - 2 q.r approximates d2; if its error is at most a
// window W around the true distance, a pair whose approximation exceeds
// (least exact chain seen) + W cannot be the answer, and every other pair is
// rechecked with the exact chain.  The answer is then exact by construction.
//   1. nn1_split_kernel (once per call): each reference row r as
//      hi = cvt.rna.tf32(r) and lo = r - hi (exact in fp32, so hi + lo == r;
//      the tensor core reads lo truncated to TF32), |r|^2 as an fp32 FMA
//      chain, +inf for the
//      rows that pad R to a multiple of 256, and max |r|^2 over the real rows
//      (one atomicMax per warp), into scratch the wrapper allocates (68 bytes
//      a row).
//   2. nn1_filter_kernel: one block per 256 query rows; a producer warp whose
//      one thread streams 256-row reference tiles (hi and lo through 2-D TMA
//      tensor maps in the 32-byte swizzle, |r|^2 by a 1-D bulk copy) through a
//      ring of 4 mbarrier stages, and two consumer warpgroups of 128 query rows
//      (two m64 tiles) each.  A consumer keeps its rows' hi / lo split as the
//      register A operand of wgmma.m64n64k8.f32.tf32.tf32 (TF32 takes K-major
//      operands: a reference row is exactly one 32-byte swizzle span) and
//      issues, per 64-reference sub-tile and m64 tile, hi.lo + lo.hi + hi.hi
//      into one fp32 accumulator per tile, one commit group each: one tile's
//      products run while the other tile's epilogue runs, and the two
//      consumers interleave alike.  The pass count is a template parameter (a
//      run-time branch around the wgmma made ptxas add a dummy wgmma and a
//      fence to every group).
//   3. Epilogue, two instructions per pair and no running approximate
//      minimum: a~ = |r|^2 - 2 dot (one FFMA), tested as !(a~ > thr) (one
//      FSETP, its predicate OR-ed over 16 pairs; NaN passes) with
//      thr = T - |q|^2 rounded up and T = bound (1 + c u) + A_q, where
//      bound is the least exact chain this thread (or, after each sub-tile of
//      the first stage and each later stage, its quad) has computed for the
//      row and A_q = kappa u (|q|^2 + max |r|^2) + F.  Where a pair of the
//      warp passes, the warp builds each row's 16-bit mask of passing pairs
//      and walks it, one pair per lane and step, through the exact chain on
//      the query row and r = hi + lo, both from shared memory, updating
//      (best, index) lexicographically by selects.  The first sub-tile
//      rechecks every pair (bound = +inf).  The four threads that share a
//      row merge (best, index) at the end; the smallest index wins a tie.  A
//      row whose bound cannot hold (|q|^2 or max |r|^2 not finite or above
//      2^60) gets thr = +inf: every pair is rechecked.
//   While a wgmma is in flight, every branch of a consumer is warp-uniform
//   (vote-guarded recheck, mbarrier waits polled with __all_sync, a
//   predicated arrive): around a divergent path ptxas serializes all wgmma.
//
// The window (kappa, c, F: `ops/nn1.py::filter_constants`, the one place they
// live; the wrapper passes kappa u, 1 + c u and F).  u = 2^-24; x^h, x^l the
// split of x, x^l' the TF32 truncation of x^l; S = sum_a |q_a r_a| <= |q||r|.
//   * split: |x^l_a| <= 2^-11 |x_a| (hi rounded to nearest), |x^l_a - x^l'_a|
//     <= 2^-10 |x^l_a| <= 8u |x_a| (lo truncated), |x^h_a| <= (1 + 2^-11)|x_a|.
//     The dot of the three passes misses q^h (r^l - r^l') + (q^l - q^l') r^h
//     + q^l r^l: at most (16 (1 + 2^-11) + 4) u S <= 20.01 u S.
//   * accumulation: the 24 products are exact (11-bit significands); their
//     fp32 sum is taken in an unspecified order with unspecified rounding.
//     Modelled as 6 blocks (k8 as two k4, three passes) that align up to 4
//     products and the accumulator to the largest and truncate, then truncate
//     the sum: each block errs by at most 6 ulps of its largest term, 6 * 2u
//     * 1.0015 S, so 72.2 u S in all.  Dot error <= 92.3 u S <= 46.2 u
//     (|q|^2 + |r|^2).
//   * norms: |q|^2, |r|^2 as 8-step fp32 chains of non-negative terms, <= 8.01u
//     relative each; the FFMA rounds once, <= u |r|^2 + 2|q||r| u <= 2.01 u
//     (|q|^2 + |r|^2).
//   => |(|q|^2 + a~) - d2_true| <= (8.01 + 92.3 + 2.01) u (|q|^2 + |r|^2)
//      <= 102.5 u (|q|^2 + max |r|^2)  (|r|^2 <= max |r|^2 (1 + 8.1u)).
//   * the chain itself: 10 roundings of non-negative quantities, so
//     d2_true <= d2_chain (1 + 10.02 u).
//   * underflow: each of the ~40 roundings and flushes to zero above adds at
//     most 2^-126 absolute, 2^-120 in all.
// So the answer r* (least chain) satisfies |q|^2 + a~* <= d2_true* + 102.5 u
// (...) + 2^-120 <= bound (1 + 10.02 u) + 102.5 u (...) + 2^-120 for any bound
// that is the chain of a visited reference.  The kernel takes twice and more:
// kappa = 256, c = 32, F = 2^-100; T and thr are computed rounding upward.
// The accumulation model above is an assumption: PTX specifies neither the
// order nor the rounding of wgmma's fp32 sums, and the CPU test
// (tests/test_torch_nn1.py) can only emulate candidate orders.  So the kernel
// keeps one diagnostic output, `probe`: block 0 writes the a~ of its first 64
// references, as the hardware computed them, and the card check holds them to
// the exact chain in units of u (|q|^2 + max |r|^2).  It costs a uniform
// branch on a null pointer per sub-tile and is null on every call of the port.
//
// What bounds it (8 views 518 px backfill, 2,146,592 x 150,000): one TF32 pass
// over every pair's dot product, 2 Q R 8 = 5.15e12 operations, 10.4 ms at
// 495 TF/s; the three passes take 31.2 ms of tensor-core time, and the two
// epilogue instructions per pair 19.3 ms of issue; each block reads the split
// references, 10.2 MB, from L2 (85.5 GB a call, computed from the shapes: the
// card's traffic counters cannot be read on the machines it was measured on).  On an H100 80GB HBM3 at
// 700 W (PERF.md) it is latency-bound: variants without the epilogue showed
// a fixed cost per wgmma commit group well beyond its products, and this
// design's groups (3 x m64n64k8) are small.  Two sub-tiles in flight (128
// accumulator registers under setmaxnreg) and a producer folded into a
// consumer warp both read slower; 128-reference sub-tiles read the same (the
// first sub-tile's rechecks double).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int D = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sq_diff_sum(const float (&q)[D], float4 a, float4 b) {
  const float r[D] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float d = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float diff = __fsub_rn(q[k], r[k]);
    d = __fadd_rn(d, __fmul_rn(diff, diff));
  }
  return d;
}

// |x|^2 as an fp32 FMA chain over the features in order.
__device__ __forceinline__ float norm2(float4 a, float4 b) {
  float s = __fmul_rn(a.x, a.x);
  s = __fmaf_rn(a.y, a.y, s);
  s = __fmaf_rn(a.z, a.z, s);
  s = __fmaf_rn(a.w, a.w, s);
  s = __fmaf_rn(b.x, b.x, s);
  s = __fmaf_rn(b.y, b.y, s);
  s = __fmaf_rn(b.z, b.z, s);
  return __fmaf_rn(b.w, b.w, s);
}

namespace fl {
constexpr int BM = 256;                          // query rows per block
constexpr int BN = 64;                           // references per wgmma (one sub-tile)
constexpr int NJ = BN / 8;                       // 8-column groups of a sub-tile
constexpr int ACC = BN / 2;                      // accumulator registers per m64 tile
constexpr int PAIRS = BN / 4;                    // pairs per row and thread in a sub-tile
constexpr int STAGE_N = 256;                     // references per ring stage; R is padded to it
constexpr int SUBS = STAGE_N / BN;
constexpr int STAGES = 4;
constexpr int THREADS = 384;                     // a producer and 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;                // arrivals that free a ring stage
constexpr int ROW_BYTES = D * 4;                 // one 32-byte swizzle span
constexpr int TILE_BYTES = STAGE_N * ROW_BYTES;  // hi or lo of a stage
constexpr int SUB_BYTES = BN * ROW_BYTES;
constexpr int R2_OFF = 2 * TILE_BYTES;           // |r|^2 of a stage after hi and lo
constexpr int STAGE_TX = 2 * TILE_BYTES + STAGE_N * 4;
constexpr int STAGE_STRIDE = 18 * 1024;          // every stage 1024-byte aligned
constexpr size_t ROWC = (size_t)STAGES * STAGE_STRIDE;  // per query row: (A_q, |q|^2)
constexpr size_t QROWS = ROWC + BM * 8;                 // the block's fp32 query rows
constexpr size_t BARS = QROWS + BM * ROW_BYTES;
constexpr size_t SMEM = BARS + 16 * STAGES + 1024;      // + base alignment
}  // namespace fl

struct FilterArgs {
  const float* query;            // (Q, 8)
  const float* r2;               // (R_pad,) |r|^2, +inf past R
  const unsigned* max_r2;        // bits of max |r|^2 over the R rows
  long long* out;                // (Q,)
  unsigned long long* rechecks;  // exact chains computed, or null
  float* probe;                  // (256, 64) a~ of block 0's first sub-tile, or null
  long long Q;
  int R, R_pad;
  float ku, onepcu, floor_abs;   // kappa u, 1 + c u, F
};

// One output row per thread: the TF32 split of a reference, |r|^2 and the
// running max |r|^2.  Output row i holds reference (i / nb_pad) nb + i % nb_pad
// when i % nb_pad < nb and that index is below R, else padding (zero row,
// |r|^2 = +inf).  nn1 takes nb = nb_pad = rows (row i is reference i); the
// bucket kernel's layout puts bucket b of chunk j at row j nb_pad + b.
constexpr int SPLIT_THREADS = 256;

__global__ void __launch_bounds__(SPLIT_THREADS)
nn1_split_kernel(const float* __restrict__ ref, float* __restrict__ hi, float* __restrict__ lo,
                 float* __restrict__ r2, unsigned* __restrict__ max_r2, int R, int nb, int nb_pad,
                 int rows) {
  const int i = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const int b = i % nb_pad;
  const long long src = (long long)(i / nb_pad) * nb + b;
  const bool real = i < rows && b < nb && src < R;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  float n2 = INFINITY;
  if (real) {
    const float4* p = reinterpret_cast<const float4*>(ref + src * D);
    a = p[0];
    c = p[1];
    n2 = norm2(a, c);
  }
  const float x[D] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  float h[D], l[D];
#pragma unroll
  for (int k = 0; k < D; ++k) split_tf32(x[k], h[k], l[k]);  // hi + lo == r (the recheck rebuilds r)
  if (i < rows) {
    float4* ph = reinterpret_cast<float4*>(hi + (long long)i * D);
    float4* pl = reinterpret_cast<float4*>(lo + (long long)i * D);
    ph[0] = make_float4(h[0], h[1], h[2], h[3]);
    ph[1] = make_float4(h[4], h[5], h[6], h[7]);
    pl[0] = make_float4(l[0], l[1], l[2], l[3]);
    pl[1] = make_float4(l[4], l[5], l[6], l[7]);
    r2[i] = n2;
  }
  // as unsigned bits: non-negative floats order alike, and NaN lies above +inf
  const unsigned m = __reduce_max_sync(FULL, real ? __float_as_uint(n2) : 0u);
  if ((threadIdx.x & 31) == 0 && m != 0u) atomicMax(max_r2, m);
}

// The loads of ring stage `it` (hi and lo boxes of the 2-D tensor maps, |r|^2 by
// a 1-D bulk copy) into its slot, completed on its `full` barrier; issued by
// the lanes where `pred` holds, predicated rather than branched (the issuing
// warp may have a wgmma in flight).
__device__ __forceinline__ void load_stage(unsigned char* slot, uint64_t* bar,
                                           const CUtensorMap* thi, const CUtensorMap* tlo,
                                           const float* r2, int it, bool pred) {
  const int row = it * fl::STAGE_N;
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(fl::STAGE_TX), "r"((int)pred)
      : "memory");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%6], [%7, {%3, %4}], [%2];\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%8], [%9], %10, [%2];\n}\n"
      ::"r"(smem_u32(slot)), "l"(reinterpret_cast<uint64_t>(thi)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"((int)pred), "r"(smem_u32(slot + fl::TILE_BYTES)),
      "l"(reinterpret_cast<uint64_t>(tlo)), "r"(smem_u32(slot + fl::R2_OFF)),
      "l"(reinterpret_cast<uint64_t>(r2 + row)), "r"(fl::STAGE_N * 4)
      : "memory");
}

// 1 if any pair of a row's 16 passes, else 0: per pair a~ = fma(-2, dot, |r|^2)
// and !(a~ > thr) (NaN passes), the predicate OR-ed along; inside one asm so
// that no a~ outlives the test (the recheck computes its own).
__device__ __forceinline__ uint32_t any_within(const float (&dot)[16], const float (&r2)[16],
                                               float thr) {
  uint32_t r;
  asm("{\n.reg .pred p;\n.reg .f32 x;\n"
      "fma.rn.f32 x, %1, 0fC0000000, %17;\nsetp.leu.f32 p, x, %33;\n"
      "fma.rn.f32 x, %2, 0fC0000000, %18;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %3, 0fC0000000, %19;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %4, 0fC0000000, %20;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %5, 0fC0000000, %21;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %6, 0fC0000000, %22;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %7, 0fC0000000, %23;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %8, 0fC0000000, %24;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %9, 0fC0000000, %25;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %10, 0fC0000000, %26;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %11, 0fC0000000, %27;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %12, 0fC0000000, %28;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %13, 0fC0000000, %29;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %14, 0fC0000000, %30;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %15, 0fC0000000, %31;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "fma.rn.f32 x, %16, 0fC0000000, %32;\nsetp.leu.or.f32 p, x, %33, p;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "f"(dot[0]), "f"(dot[1]), "f"(dot[2]), "f"(dot[3]), "f"(dot[4]), "f"(dot[5]),
        "f"(dot[6]), "f"(dot[7]), "f"(dot[8]), "f"(dot[9]), "f"(dot[10]), "f"(dot[11]),
        "f"(dot[12]), "f"(dot[13]), "f"(dot[14]), "f"(dot[15]),
        "f"(r2[0]), "f"(r2[1]), "f"(r2[2]), "f"(r2[3]), "f"(r2[4]), "f"(r2[5]), "f"(r2[6]),
        "f"(r2[7]), "f"(r2[8]), "f"(r2[9]), "f"(r2[10]), "f"(r2[11]), "f"(r2[12]),
        "f"(r2[13]), "f"(r2[14]), "f"(r2[15]), "f"(thr));
  return r;
}

__device__ __forceinline__ float pick(float4 v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// thr = T - |q|^2 with T = bound (1 + c u) + A_q, every step rounded upward;
// c = (A_q, |q|^2).  A_q = +inf (a row on the exact path) gives +inf.
__device__ __forceinline__ float row_threshold(float bound, float2 c, float onepcu) {
  return __fsub_ru(__fadd_ru(__fmul_ru(bound, onepcu), c.x), c.y);
}

// A thread's four query rows ("slots" rs = 2 mt + hr: m64 tile mt, half hr):
// the thresholds, the least exact chain known (its own or its quad's), and its
// own best chain and index.
struct Rows {
  float thr[4], bound[4], best[4];
  int idx[4];
};

// Accumulator layout of wgmma.m64n64 (per warp w, g = lane / 4, t = lane % 4):
// d[4j + 2hr + e] is row 16w + g + 8hr, column 8j + 2t + e.
template <int PASSES>
__global__ void __launch_bounds__(fl::THREADS, 1)
    nn1_filter_kernel(const __grid_constant__ CUtensorMap thi,
                      const __grid_constant__ CUtensorMap tlo, const FilterArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float2* rowc = reinterpret_cast<float2*>(smem + fl::ROWC);
  float4* qrows = reinterpret_cast<float4*>(smem + fl::QROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + fl::BARS);
  uint64_t* empty = full + fl::STAGES;
  const int nstages = a.R_pad / fl::STAGE_N;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < fl::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, fl::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      for (int it = 0; it < nstages; ++it) {
        const int sl = it % fl::STAGES;
        mbar_wait(empty + sl, ((it / fl::STAGES) & 1) ^ 1);
        load_stage(smem + sl * fl::STAGE_STRIDE, full + sl, &thi, &tlo, a.r2, it, true);
      }
    }
  } else {
    // consumer warpgroups: 128 query rows each, as two m64 tiles.  While a
    // wgmma is in flight every branch is warp-uniform: ptxas serializes wgmma
    // around divergent code.
    const int wgi = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const long long row0 = (long long)blockIdx.x * fl::BM;
    auto local_row = [&](int rs) { return wgi * 128 + (rs >> 1) * 64 + warp * 16 + (rs & 1) * 8 + g; };

    const float max_r2 = __uint_as_float(*a.max_r2);
    const bool all_exact = !(max_r2 <= 0x1p60f);
    uint32_t ahi[2][4], alo[2][4];
    uint32_t live = 0;
    Rows st;
#pragma unroll
    for (int rs = 0; rs < 4; ++rs) {
      const int lr = local_row(rs);
      const long long row = row0 + lr;
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
      if (row < a.Q) {
        const float4* p = reinterpret_cast<const float4*>(a.query + row * D);
        x0 = p[0];
        x1 = p[1];
        live |= 1u << rs;
      }
      const float q2 = norm2(x0, x1);
      const bool exact = all_exact || !(q2 <= 0x1p60f);
      const float aq = exact ? INFINITY
                             : __fadd_ru(__fmul_ru(a.ku, __fadd_ru(q2, max_r2)), a.floor_abs);
      if (t == 0) {
        rowc[lr] = make_float2(aq, exact ? 0.f : q2);
        qrows[2 * lr] = x0;
        qrows[2 * lr + 1] = x1;
      }
      st.thr[rs] = row < a.Q ? INFINITY : -INFINITY;
      st.bound[rs] = st.best[rs] = INFINITY;
      st.idx[rs] = INT_MAX;
      // this row's A elements: columns t (a0 / a1) and t + 4 (a2 / a3)
      const int mt = rs >> 1, hr = rs & 1;
      const float e0 = pick(x0, t), e1 = pick(x1, t);
      ahi[mt][hr] = tf32_rna(e0);
      alo[mt][hr] = __float_as_uint(__fsub_rn(e0, __uint_as_float(ahi[mt][hr])));
      ahi[mt][2 + hr] = tf32_rna(e1);
      alo[mt][2 + hr] = __float_as_uint(__fsub_rn(e1, __uint_as_float(ahi[mt][2 + hr])));
    }
    __syncwarp();
    unsigned nre = 0;                            // exact chains computed

    auto stage_base = [&](int s) {
      return smem + (size_t)((s / fl::SUBS) % fl::STAGES) * fl::STAGE_STRIDE;
    };
    auto wait_full = [&](int s) {                // before the first sub-tile of a stage
      const int k = s / fl::SUBS;
      mbar_wait_warp(full + k % fl::STAGES, (k / fl::STAGES) & 1);
    };
    // the three passes of sub-tile s for m64 tile mt, one commit group
    auto issue = [&](float (&acc)[fl::ACC], int s, int mt) {
      const unsigned char* b = stage_base(s) + (s % fl::SUBS) * fl::SUB_BYTES;
      const uint64_t dhi = smem_desc(b, 16, 8 * fl::ROW_BYTES, 3);
      const uint64_t dlo = smem_desc(b + fl::TILE_BYTES, 16, 8 * fl::ROW_BYTES, 3);
      fence_regs(acc);
      wgmma_fence();
      if constexpr (PASSES == 3) {
        wgmma_tf32_rs_n64(acc, ahi[mt], dlo, 0);
        wgmma_tf32_rs_n64(acc, alo[mt], dhi, 1);
        wgmma_tf32_rs_n64(acc, ahi[mt], dhi, 1);
      } else {
        wgmma_tf32_rs_n64(acc, ahi[mt], dhi, 0);
      }
      wgmma_commit();
    };
    // Sub-tile s of m64 tile mt: a~ of each pair against its row's threshold.
    // Where a pair of the warp passes, the warp builds each row's mask of
    // passing pairs and walks it, a pair per lane and step, through the exact
    // chain, updating by selects; the thresholds tighten as the bounds fall.
    // The chain reads the query row and r = hi + lo (exact) from shared memory.
    auto epilogue = [&](const float (&acc)[fl::ACC], const float2 (&rc)[fl::NJ], int s, int mt) {
      uint32_t any = 0;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int c = 0; c < fl::NJ / 8; ++c) {
          float dot[16], r2[16];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * c + jj;
            dot[2 * jj] = acc[4 * j + 2 * hr];
            dot[2 * jj + 1] = acc[4 * j + 2 * hr + 1];
            r2[2 * jj] = rc[j].x;
            r2[2 * jj + 1] = rc[j].y;
          }
          any |= any_within(dot, r2, st.thr[2 * mt + hr]);
        }
      }
      if (__any_sync(FULL, any)) {
        const unsigned char* tile = stage_base(s) + (s % fl::SUBS) * fl::SUB_BYTES;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rs = 2 * mt + hr;
          uint32_t m = 0;
#pragma unroll
          for (int k = 0; k < fl::PAIRS; ++k) {
            const float2 r = rc[k >> 1];
            const float x = __fmaf_rn(-2.f, acc[4 * (k >> 1) + 2 * hr + (k & 1)], k & 1 ? r.y : r.x);
            m |= (x > st.thr[rs] ? 0u : 1u) << k;
          }
          m = ((live >> rs) & 1) ? m : 0u;
          if (!__any_sync(FULL, m != 0)) continue;
          const int lr = local_row(rs);
          const float4 q0 = qrows[2 * lr], q1 = qrows[2 * lr + 1];
          const float q[D] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          const float2 c = rowc[lr];
          while (__any_sync(FULL, m != 0)) {
            const bool act = m != 0;
            const int b = act ? __ffs(m) - 1 : 0;
            m &= m - 1;
            const int n = 8 * (b >> 1) + 2 * t + (b & 1);      // column in the sub-tile
            const int col = s * fl::BN + n;
            const bool ok = act && col < a.R;
            // row n of the 32-byte-swizzled tiles: its 16-byte halves swap in
            // rows 4-7 of every 8
            const int sw = (n >> 2) & 1;
            const float4* h = reinterpret_cast<const float4*>(tile + n * fl::ROW_BYTES);
            const float4* l = reinterpret_cast<const float4*>(tile + fl::TILE_BYTES +
                                                              n * fl::ROW_BYTES);
            const float4 h0 = h[sw], h1 = h[sw ^ 1], l0 = l[sw], l1 = l[sw ^ 1];
            const float4 ra = make_float4(__fadd_rn(h0.x, l0.x), __fadd_rn(h0.y, l0.y),
                                          __fadd_rn(h0.z, l0.z), __fadd_rn(h0.w, l0.w));
            const float4 rb = make_float4(__fadd_rn(h1.x, l1.x), __fadd_rn(h1.y, l1.y),
                                          __fadd_rn(h1.z, l1.z), __fadd_rn(h1.w, l1.w));
            const float d = sq_diff_sum(q, ra, rb);
            nre += ok ? 1u : 0u;
            const bool better =
                ok && (d < st.best[rs] || (d == st.best[rs] && col < st.idx[rs]));
            st.best[rs] = better ? d : st.best[rs];
            st.idx[rs] = better ? col : st.idx[rs];
            const bool tighter = better && d < st.bound[rs];
            st.bound[rs] = tighter ? d : st.bound[rs];
            st.thr[rs] = tighter ? row_threshold(d, c, a.onepcu) : st.thr[rs];
          }
        }
      }
      if (a.probe != nullptr && s == 0 && blockIdx.x == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* pr = a.probe + local_row(2 * mt + hr) * 64;
#pragma unroll
          for (int j = 0; j < 8; ++j) {                // the first 64 references
            pr[8 * j + 2 * t] = __fmaf_rn(-2.f, acc[4 * j + 2 * hr], rc[j].x);
            pr[8 * j + 2 * t + 1] = __fmaf_rn(-2.f, acc[4 * j + 2 * hr + 1], rc[j].y);
          }
        }
      }
    };

    // After both tiles of sub-tile s: at a stage's end, free it; then (and
    // after every sub-tile of the first stage, while the bounds fall fastest)
    // the quad shares its bounds.
    auto finish_sub = [&](int s) {
      const bool stage_done = s % fl::SUBS == fl::SUBS - 1;
      if (stage_done) {
        __syncwarp();
        mbar_arrive_if(empty + (s / fl::SUBS) % fl::STAGES, lane == 0);
      }
      if (stage_done || s < fl::SUBS) {
#pragma unroll
        for (int rs = 0; rs < 4; ++rs) {
          float o = fminf(st.bound[rs], __shfl_xor_sync(FULL, st.bound[rs], 1));
          o = fminf(o, __shfl_xor_sync(FULL, o, 2));
          const bool tighter = o < st.bound[rs];
          st.bound[rs] = tighter ? o : st.bound[rs];
          st.thr[rs] = tighter ? row_threshold(o, rowc[local_row(rs)], a.onepcu) : st.thr[rs];
        }
      }
    };
    auto load_rc = [&](float2 (&rc)[fl::NJ], int s) {
      const float* r2s = reinterpret_cast<const float*>(stage_base(s) + fl::R2_OFF) +
                         (s % fl::SUBS) * fl::BN;
#pragma unroll
      for (int j = 0; j < fl::NJ; ++j) rc[j] = *reinterpret_cast<const float2*>(r2s + 8 * j + 2 * t);
    };
    auto issue_sub = [&](float (&x0)[fl::ACC], float (&x1)[fl::ACC], int s) {
      if (s % fl::SUBS == 0) wait_full(s);
      issue(x0, s, 0);
      issue(x1, s, 1);
    };

    // One accumulator per m64 tile, one commit group each: the products of
    // one tile run on the tensor cores while the other tile's epilogue runs,
    // and the other consumer warpgroup interleaves the same way.  (Two
    // sub-tiles in flight, with 128 accumulator registers, read slower.)
    const int nsub = nstages * fl::SUBS;
    float a0[fl::ACC], a1[fl::ACC];
    float2 rc[fl::NJ];                           // |r|^2 of the sub-tile's columns
    issue_sub(a0, a1, 0);
    for (int s = 0; s < nsub; ++s) {
      const bool more = s + 1 < nsub;
      load_rc(rc, s);
      wgmma_wait<1>();                           // tile 0 of sub-tile s
      fence_regs(a0);
      epilogue(a0, rc, s, 0);
      if (more) {
        if ((s + 1) % fl::SUBS == 0) wait_full(s + 1);
        issue(a0, s + 1, 0);
        wgmma_wait<1>();                         // tile 1 of sub-tile s
      } else {
        wgmma_wait<0>();
      }
      fence_regs(a1);
      epilogue(a1, rc, s, 1);
      finish_sub(s);
      if (more) issue(a1, s + 1, 1);
    }

    // merge the quad's (best, index) pairs: least chain, then least index
#pragma unroll
    for (int rs = 0; rs < 4; ++rs) {
      float b = st.best[rs];
      int i = st.idx[rs];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(FULL, b, off);
        const int oi = __shfl_xor_sync(FULL, i, off);
        if (ob < b || (ob == b && oi < i)) {
          b = ob;
          i = oi;
        }
      }
      // no chain below +inf (a query of inf or NaN): index 0, as the plain version
      if (t == 0 && ((live >> rs) & 1)) a.out[row0 + local_row(rs)] = i == INT_MAX ? 0 : i;
    }
    if (a.rechecks != nullptr) {
      const unsigned n = __reduce_add_sync(FULL, nre);
      if (lane == 0) atomicAdd(a.rechecks, (unsigned long long)n);
    }
  }
}

// Per-bucket nearest references: for every query q and bucket b < nb, the
// least d2(q, r) over the references r = b, b + nb, b + 2 nb, ... (bucket of a
// reference = its index mod nb) and the smallest such r attaining it, with
// d2 the exact fp32 chain of nn1.  An empty bucket (b >= R) holds +inf and
// index b.  The exact top-k over the nb bucket minima is taken outside the
// kernel (`ops/nn1.py::bucket_topk`), as the JAX package takes it outside its
// Pallas call.  No module calls it (as in the JAX package); it is a candidate
// for the clustering's core kNN.
//
// Why the exact chain alone is slow: 24 instructions per pair on every pair,
// 16.1 ms of issue at Q = R = 150,000.
//
// Design: nn1's filter, per bucket, in two passes over the references.
// nn1_split_kernel lays the split references out by bucket: row j nb_pad + b
// holds reference j nb + b (nb_pad = nb rounded up to 64; the padding rows
// are zero with |r|^2 = +inf), so the 64 rows j nb_pad + b0 ... + 63 are
// chunk j of 64 buckets, and every such row exists.  bucket_filter_kernel
// takes one block per (192 query rows, 64-bucket group b0): a producer
// warpgroup whose one thread streams the chunks j = 0, 1, ... twice (4 a
// stage: hi and lo as one box of a 3-D tensor map (8, nb_pad, J) in the
// 32-byte swizzle, |r|^2 as a box of a 2-D map (nb_pad, J)) through a ring of
// mbarrier stages, and three consumer warpgroups of 64 query rows, whose hi /
// lo split is the register A operand of wgmma.m64n128k8.f32.tf32 (hi.lo +
// lo.hi + hi.hi) over two chunks at a time.  The accumulator fragment holds
// the same (query, bucket) pairs for every chunk, 32 per thread and chunk.
//   Pass 1: per pair the least a~ = |r|^2 - 2 q.r over its bucket, a1 (an
//   FFMA and a min per pair and chunk).  Then per pair, with nn1's window
//   (`ops/nn1.py::filter_constants`): bound = |q|^2 + a1 + A_q is at least
//   the chain of the reference that gave a1, so the answer's chain is at most
//   bound, and the answer has a~ <= thr = T - |q|^2, T = bound (1 + c u) +
//   A_q (every step rounded up).
//   Pass 2: the same products; each pair with a~ <= thr (NaN passes) gets the
//   exact chain, nn1's recheck loop (a pair per lane and step, the reference
//   rebuilt as hi + lo from shared memory), and keeps the least (chain,
//   chunk) key in shared memory: the chunks ascend, so a tie goes to the
//   smallest index.  Rows on the exact path (A_q = +inf: |q|^2 or max |r|^2
//   above 2^60 or not finite) recheck every pair.  The keys then go out by
//   rows, a row's 64 buckets from adjacent threads.
// Rechecks per (query, bucket) are the references inside the final window:
// 1 where the least approximation is alone there, more on near ties (the
// clustering's smoothed features).
//
// Why this shape (variants timed on the card, PERF.md): the consumers'
// epilogues are latency-bound (a clock64 split of a warp's time showed the
// wgmma waits small beside the pass-2 rechecks, the pass-2 filter and pass
// 1), so more warps pay more than groups in flight.  Three warpgroups with
// one m64n128 group each read faster than two with two groups each
// (m64n128 or m64n64) or three with two m64n64 groups; four did not launch
// at 120 registers.  A warp-wide queue of the pass-2 candidates, one chain
// per lane, and two candidates per lane and step read slower than the
// per-lane loop; more ring stages read the same.  Slower too: one pass
// that kept the least and second-least a~ and walked the whole bucket
// exactly where the second lay inside the window (62.3 ms on the smoothed
// subsample, scripts/bucket_ab.py, where 55% of the pairs walk), and nn1's
// rule as the chunks stream (5.6 rechecks per pair).
//
// What bounds it (Q = R = 150,000, nb = 1024): one TF32 pass over every
// pair's dot product, 2 Q R 8 = 3.6e11 operations, 0.73 ms at 495 TF/s
// (three passes 2.18 ms, and this design runs them twice); writing the (Q,
// nb) minima and int64 indices, 1.84 GB, 0.55 ms at 3.35 TB/s.

namespace bk {
constexpr int NWG = 3;                           // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * NWG;                     // query rows per block
constexpr int BN = 64;                           // buckets per block (one chunk is 64 rows)
constexpr int ITEM = 2;                          // chunks per wgmma group (m64n128k8)
constexpr int CH = 4;                            // chunks per ring stage
constexpr int PER_STAGE = CH / ITEM;             // items per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (NWG + 1);         // a producer and the consumer warpgroups
constexpr int CONSUMER_WARPS = 4 * NWG;
constexpr int REG_PRODUCER = 24;                 // setmaxnreg: 128 x 24 + 384 x 160 <= 65536
constexpr int REG_CONSUMER = 160;
constexpr int ROW_BYTES = D * 4;                 // one 32-byte swizzle span
constexpr int CHUNK_BYTES = BN * ROW_BYTES;      // hi or lo of a chunk
constexpr int LO_OFF = CH * CHUNK_BYTES;
constexpr int R2_OFF = 2 * CH * CHUNK_BYTES;
constexpr int STAGE_TX = 2 * CH * CHUNK_BYTES + CH * BN * 4;
constexpr int STAGE_STRIDE = 17 * 1024;          // = STAGE_TX, 1024-byte aligned
constexpr size_t QROWS = (size_t)STAGES * STAGE_STRIDE;  // the block's fp32 query rows
constexpr size_t KEYS = QROWS + BM * ROW_BYTES;          // per pair its least (chain, chunk)
constexpr size_t BARS = KEYS + (size_t)BM * BN * 8;
constexpr size_t SMEM = BARS + 16 * STAGES + 1024;       // + base alignment
static_assert(STAGE_TX <= STAGE_STRIDE, "a stage fits its slot");
static_assert(CH % ITEM == 0, "a stage holds whole items");
static_assert(SMEM <= 232448, "shared memory of one block");
}  // namespace bk

struct BucketArgs {
  const float* query;            // (Q, 8)
  const unsigned* max_r2;        // bits of max |r|^2 over the R references
  float* out_d;                  // (Q, nb)
  long long* out_i;              // (Q, nb)
  unsigned long long* rechecks;  // exact chains computed, or null
  long long Q;
  int R, nb;
  float ku, onepcu, floor_abs;   // kappa u, 1 + c u, F
};

// The loads of ring stage k: CH chunks of hi, lo (3-D boxes) and |r|^2 (a 2-D
// box) at bucket b0, chunks k CH ..., completed on `bar`.
__device__ __forceinline__ void load_bucket_stage(unsigned char* slot, uint64_t* bar,
                                                  const CUtensorMap* thi, const CUtensorMap* tlo,
                                                  const CUtensorMap* tr2, int b0, int k) {
  mbar_expect_tx(bar, bk::STAGE_TX);
  const int j0 = k * bk::CH;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%6], [%7, {%3, %4, %5}], [%2];\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%8], [%9, {%4, %5}], [%2];\n" ::"r"(smem_u32(slot)),
      "l"(reinterpret_cast<uint64_t>(thi)), "r"(smem_u32(bar)), "r"(0), "r"(b0), "r"(j0),
      "r"(smem_u32(slot + bk::LO_OFF)), "l"(reinterpret_cast<uint64_t>(tlo)),
      "r"(smem_u32(slot + bk::R2_OFF)), "l"(reinterpret_cast<uint64_t>(tr2))
      : "memory");
}

// A recheck's key, ordered as the answer is: the least chain (as bits:
// non-negative floats order alike, and NaN lies above +inf, so it never
// wins), then the least chunk, i.e. the smallest index in the bucket.
__device__ __forceinline__ unsigned long long best_key(float d, int j) {
  return (unsigned long long)__float_as_uint(d) << 32 | (unsigned)j;
}
constexpr unsigned long long NO_KEY = 0x7f800000ffffffffULL;   // +inf, no reference

// Pair p of a thread (0..31) in a chunk: row half p / 16 (rows g, g + 8),
// column 8 (p / 2 % 8) + 2t + p % 2 of the chunk; accumulator element
// 4 (p / 2 % 8) + 2 (p / 16) + p % 2, plus 32 for the item's second chunk.
__device__ __forceinline__ int pair_acc(int p) { return 4 * ((p >> 1) & 7) + 2 * (p >> 4) + (p & 1); }
__device__ __forceinline__ int pair_col(int p, int t) { return 8 * ((p >> 1) & 7) + 2 * t + (p & 1); }

// A consumer warpgroup: 64 query rows (one m64 tile) against the block's 64
// buckets, both passes, two chunks (an "item") per wgmma group.
template <int PASSES>
__device__ __forceinline__ void bucket_consumer(const BucketArgs& a, unsigned char* smem,
                                                uint64_t* full, uint64_t* empty, int b0,
                                                int nchunks) {
  float4* qrows = reinterpret_cast<float4*>(smem + bk::QROWS);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + bk::KEYS);
  const int wgi = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = (long long)blockIdx.x * bk::BM;
  auto local_row = [&](int hr) { return wgi * 64 + warp * 16 + 8 * hr + g; };
  auto key_slot = [&](int p) { return keys + (wgi * 32 + p) * 128 + tid; };

  const float max_r2 = __uint_as_float(*a.max_r2);
  const bool all_exact = !(max_r2 <= 0x1p60f);
  uint32_t ahi[4], alo[4];
  float2 rowc[2];                                  // (A_q, |q|^2) of rows g, g + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int lr = local_row(hr);
    const long long row = row0 + lr;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (row < a.Q) {
      const float4* p = reinterpret_cast<const float4*>(a.query + row * D);
      x0 = p[0];
      x1 = p[1];
    }
    const float q2 = norm2(x0, x1);
    const bool exact = all_exact || !(q2 <= 0x1p60f);
    const float aq = exact ? INFINITY
                           : __fadd_ru(__fmul_ru(a.ku, __fadd_ru(q2, max_r2)), a.floor_abs);
    rowc[hr] = make_float2(aq, exact ? 0.f : q2);
    if (t == 0) {
      qrows[2 * lr] = x0;
      qrows[2 * lr + 1] = x1;
    }
    // this row's A elements: columns t (a0 / a1) and t + 4 (a2 / a3)
    float h, l;
    split_tf32(pick(x0, t), h, l);
    ahi[hr] = __float_as_uint(h);
    alo[hr] = __float_as_uint(l);
    split_tf32(pick(x1, t), h, l);
    ahi[2 + hr] = __float_as_uint(h);
    alo[2 + hr] = __float_as_uint(l);
  }
#pragma unroll
  for (int p = 0; p < 32; ++p) *key_slot(p) = NO_KEY;
  __syncwarp();

  // Per pair: a1 through pass 1, then the threshold thr of pass 2 (-inf for a
  // row past Q or a bucket past nb).
  float lim[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) lim[p] = INFINITY;
  unsigned nre = 0;                                // exact chains computed

  // Item i of 2 nitems: pass i / nitems, chunks 2k and 2k + 1 (k = i mod
  // nitems; the second exists if 2k + 1 < nchunks), in ring stage
  // (pass ? nst : 0) + k / 2.
  const int nitems = (nchunks + bk::ITEM - 1) / bk::ITEM;
  const int nst = (nchunks + bk::CH - 1) / bk::CH;
  auto item_of = [&](int i) { return i < nitems ? i : i - nitems; };
  auto stage_of = [&](int i) { return (i < nitems ? 0 : nst) + item_of(i) / bk::PER_STAGE; };
  auto slot_of = [&](int i) { return smem + (size_t)(stage_of(i) % bk::STAGES) * bk::STAGE_STRIDE; };
  auto first_chunk_at = [&](int i) { return (item_of(i) % bk::PER_STAGE) * bk::ITEM; };
  // a~ = |r|^2 - 2 q.r of pair p in chunk c of the item (padding rows have
  // |r|^2 = +inf: a~ = +inf)
  auto approx = [&](const float (&acc)[64], const float* r2s, int c, int p) {
    const float r2 = r2s[c * bk::BN + pair_col(p, t)];
    return __fmaf_rn(-2.f, acc[32 * c + pair_acc(p)], r2);
  };
  auto set_thresholds = [&]() {
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const float2 c = rowc[p >> 4];
      const bool live = row0 + local_row(p >> 4) < a.Q && b0 + pair_col(p, t) < a.nb;
      const float bound = __fadd_ru(__fadd_ru(c.y, lim[p]), c.x);
      lim[p] = live ? row_threshold(bound, c, a.onepcu) : -INFINITY;
    }
  };
  auto epilogue = [&](const float (&acc)[64], int i) {
    const int k = item_of(i);
    const int nc = 2 * k + 1 < nchunks ? 2 : 1;    // chunks of the item
    const unsigned char* tile = slot_of(i) + first_chunk_at(i) * bk::CHUNK_BYTES;
    const float* r2s = reinterpret_cast<const float*>(slot_of(i) + bk::R2_OFF) +
                       first_chunk_at(i) * bk::BN;
    if (i < nitems) {                              // pass 1: the least a~
#pragma unroll
      for (int c = 0; c < bk::ITEM; ++c) {
        if (c < nc) {
#pragma unroll
          for (int p = 0; p < 32; ++p) lim[p] = fminf(lim[p], approx(acc, r2s, c, p));
        }
      }
      if (i == nitems - 1) set_thresholds();
      return;
    }
    // pass 2: the pairs within thr, a pair per lane and step, through the
    // exact chain on the query row and r = hi + lo, both from shared memory
    uint32_t m0 = 0, m1 = 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      m0 |= (approx(acc, r2s, 0, p) > lim[p] ? 0u : 1u) << p;
      m1 |= (approx(acc, r2s, 1, p) > lim[p] ? 0u : 1u) << p;
    }
    m1 = nc == 2 ? m1 : 0u;
    while (__any_sync(FULL, (m0 | m1) != 0)) {
      const bool act = (m0 | m1) != 0;
      const int c = m0 != 0 ? 0 : 1;
      const int p = act ? __ffs(c ? m1 : m0) - 1 : 0;
      m1 = c ? m1 & (m1 - 1) : m1;
      m0 = c ? m0 : m0 & (m0 - 1);
      const int n = pair_col(p, t);
      const int lr = local_row(p >> 4);
      const float4 q0 = qrows[2 * lr], q1 = qrows[2 * lr + 1];
      const float q[D] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      // row n of the 32-byte-swizzled chunk: its 16-byte halves swap in rows
      // 4-7 of every 8
      const int sw = (n >> 2) & 1;
      const unsigned char* row = tile + c * bk::CHUNK_BYTES + n * bk::ROW_BYTES;
      const float4* h = reinterpret_cast<const float4*>(row);
      const float4* l = reinterpret_cast<const float4*>(row + bk::LO_OFF);
      const float4 h0 = h[sw], h1 = h[sw ^ 1], l0 = l[sw], l1 = l[sw ^ 1];
      const float4 ra = make_float4(__fadd_rn(h0.x, l0.x), __fadd_rn(h0.y, l0.y),
                                    __fadd_rn(h0.z, l0.z), __fadd_rn(h0.w, l0.w));
      const float4 rb = make_float4(__fadd_rn(h1.x, l1.x), __fadd_rn(h1.y, l1.y),
                                    __fadd_rn(h1.z, l1.z), __fadd_rn(h1.w, l1.w));
      const float d = sq_diff_sum(q, ra, rb);
      const int j = 2 * k + c;
      const bool ok = act && row0 + lr < a.Q && b0 + n < a.nb &&
                      (long long)j * a.nb + b0 + n < a.R;
      unsigned long long* slot = key_slot(p);
      const unsigned long long old = *slot, key = best_key(d, j);
      *slot = ok && key < old ? key : old;
      nre += ok ? 1u : 0u;
    }
  };

  // One group in flight per warpgroup: the other two warpgroups' epilogues
  // run while it computes.
  float acc[64];
  for (int i = 0; i < 2 * nitems; ++i) {
    const int k = item_of(i);
    if (k % bk::PER_STAGE == 0) {                  // the item opens a stage
      const int s = stage_of(i);
      mbar_wait_warp(full + s % bk::STAGES, (s / bk::STAGES) & 1);
    }
    const unsigned char* tile = slot_of(i) + first_chunk_at(i) * bk::CHUNK_BYTES;
    const uint64_t dhi = smem_desc(tile, 16, 8 * bk::ROW_BYTES, 3);
    const uint64_t dlo = smem_desc(tile + bk::LO_OFF, 16, 8 * bk::ROW_BYTES, 3);
    fence_regs(acc);
    wgmma_fence();
    if constexpr (PASSES == 3) {
      wgmma_tf32_rs_n128(acc, ahi, dlo, 0);
      wgmma_tf32_rs_n128(acc, alo, dhi, 1);
      wgmma_tf32_rs_n128(acc, ahi, dhi, 1);
    } else {
      wgmma_tf32_rs_n128(acc, ahi, dhi, 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    epilogue(acc, i);
    // the stage is read: free it (warp-uniform waits and a predicated arrive,
    // as around an in-flight wgmma: ptxas serializes wgmma near divergent code)
    __syncwarp();
    mbar_arrive_if(empty + stage_of(i) % bk::STAGES,
                   lane == 0 && (k % bk::PER_STAGE == bk::PER_STAGE - 1 || k == nitems - 1));
  }

  // The warpgroup's 64 rows x 64 buckets: (distance, index) from the keys,
  // a row's buckets from adjacent threads; no reference: +inf, b.
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
#pragma unroll 4
  for (int it = 0; it < 32; ++it) {
    const int item = it * 128 + tid;
    const int rl = item >> 6, col = item & 63;     // row of the warpgroup, bucket of the group
    const int w = rl >> 4, hr = (rl >> 3) & 1, gg = rl & 7;
    const int p = 16 * hr + 2 * (col >> 3) + (col & 1);
    const int owner = 32 * w + 4 * gg + ((col >> 1) & 3);
    const unsigned long long key = keys[(wgi * 32 + p) * 128 + owner];
    const long long row = row0 + wgi * 64 + rl;
    if (row < a.Q && b0 + col < a.nb) {
      const unsigned j = (unsigned)key;
      a.out_d[row * a.nb + b0 + col] = __uint_as_float((unsigned)(key >> 32));
      a.out_i[row * a.nb + b0 + col] = (j == 0xffffffffu ? 0LL : (long long)j * a.nb) + b0 + col;
    }
  }
  if (a.rechecks != nullptr) {
    const unsigned n = __reduce_add_sync(FULL, nre);
    if (lane == 0) atomicAdd(a.rechecks, (unsigned long long)n);
  }
}

template <int PASSES>
__global__ void __launch_bounds__(bk::THREADS, 1)
    bucket_filter_kernel(const __grid_constant__ CUtensorMap thi,
                         const __grid_constant__ CUtensorMap tlo,
                         const __grid_constant__ CUtensorMap tr2, const BucketArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bk::BARS);
  uint64_t* empty = full + bk::STAGES;
  const int b0 = blockIdx.y * bk::BN;
  // chunks holding a reference of this bucket group: j nb + b0 < R
  const int nchunks = b0 < a.R ? (a.R - 1 - b0) / a.nb + 1 : 0;
  const int nst = (nchunks + bk::CH - 1) / bk::CH;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < bk::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, bk::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load, the chunks once per
    // pass; setmaxnreg moves registers from it to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(bk::REG_PRODUCER) : "memory");
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2 * nst; ++k) {
        const int sl = k % bk::STAGES;
        mbar_wait(empty + sl, ((k / bk::STAGES) & 1) ^ 1);
        load_bucket_stage(smem + sl * bk::STAGE_STRIDE, full + sl, &thi, &tlo, &tr2, b0, k % nst);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(bk::REG_CONSUMER) : "memory");
    bucket_consumer<PASSES>(a, smem, full, empty, b0, nchunks);
  }
}

// The split references, 2-D (8, R_pad) fp32 rows; boxes of STAGE_N rows in the
// 32-byte swizzle that the wgmma descriptors name.
bool make_rows_map(CUtensorMap* map, const float* base, int rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)fl::ROW_BYTES};
  const cuuint32_t box[2] = {(cuuint32_t)D, (cuuint32_t)fl::STAGE_N};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long padded_refs(long long R) { return (R + fl::STAGE_N - 1) / fl::STAGE_N * fl::STAGE_N; }

// The bucket layout of R references: J = ceil(R / nb) chunks of nb_pad rows.
long long bucket_pad(int nb) { return ((long long)nb + bk::BN - 1) / bk::BN * bk::BN; }
long long bucket_rows(long long R, int nb) { return (R + nb - 1) / nb * bucket_pad(nb); }

// The split references of the bucket layout as a 3-D map (8, nb_pad, J):
// boxes of CH chunks of 64 rows in the 32-byte swizzle.
bool make_chunk_map(CUtensorMap* map, const float* base, int nb_pad, int J) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)nb_pad, (cuuint64_t)J};
  const cuuint64_t strides[2] = {(cuuint64_t)bk::ROW_BYTES, (cuuint64_t)nb_pad * bk::ROW_BYTES};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)bk::BN, (cuuint32_t)bk::CH};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// |r|^2 of the bucket layout as a 2-D map (nb_pad, J): boxes of CH x 64.
bool make_chunk_r2_map(CUtensorMap* map, const float* base, int nb_pad, int J) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)nb_pad, (cuuint64_t)J};
  const cuuint64_t strides[1] = {(cuuint64_t)nb_pad * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bk::BN, (cuuint32_t)bk::CH};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Bytes of the scratch iggt_nn1 takes for R references: hi and lo rows, |r|^2
// (R padded to a multiple of 256) and max |r|^2.
long long iggt_nn1_scratch_bytes(long long R) { return padded_refs(R) * (2 * D * 4 + 4) + 256; }

// query (Q, 8) and ref (R, 8): contiguous fp32, 16-byte aligned; out (Q,) int64;
// scratch of iggt_nn1_scratch_bytes(R), 256-byte aligned.  ku, onepcu, floor_abs:
// the recheck window (kappa u, 1 + c u, F); passes 3 (1 only as a planted fault);
// rechecks (may be null) receives the number of exact chains computed; probe (may
// be null, 256 x 64 fp32) the a~ of the first block's first 64 references.
// Returns a cudaError_t (0 on success).
int iggt_nn1(const float* query, const float* ref, long long* out, long long Q, long long R,
             void* scratch, float ku, float onepcu, float floor_abs, int passes,
             unsigned long long* rechecks, float* probe, void* stream) {
  if (Q <= 0 || R <= 0 || R > 0x7fffffffLL - fl::STAGE_N || (passes != 1 && passes != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (Q + fl::BM - 1) / fl::BM;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int R_pad = (int)padded_refs(R);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  float* hi = reinterpret_cast<float*>(s);
  float* lo = reinterpret_cast<float*>(s + (size_t)R_pad * fl::ROW_BYTES);
  float* r2 = reinterpret_cast<float*>(s + (size_t)R_pad * 2 * fl::ROW_BYTES);
  unsigned* max_r2 = reinterpret_cast<unsigned*>(s + (size_t)R_pad * (2 * fl::ROW_BYTES + 4));
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaMemsetAsync(max_r2, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  nn1_split_kernel<<<R_pad / SPLIT_THREADS, SPLIT_THREADS, 0, st>>>(ref, hi, lo, r2, max_r2,
                                                                    (int)R, R_pad, R_pad, R_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap thi, tlo;
  if (!make_rows_map(&thi, hi, R_pad) || !make_rows_map(&tlo, lo, R_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  FilterArgs a;
  a.query = query; a.r2 = r2; a.max_r2 = max_r2; a.out = out;
  a.rechecks = rechecks; a.probe = probe;
  a.Q = Q; a.R = (int)R; a.R_pad = R_pad;
  a.ku = ku; a.onepcu = onepcu; a.floor_abs = floor_abs;
  auto kern = passes == 3 ? nn1_filter_kernel<3> : nn1_filter_kernel<1>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fl::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, fl::THREADS, fl::SMEM, st>>>(thi, tlo, a);
  return (int)cudaGetLastError();
}

// Bytes of the scratch iggt_bucket_min takes: the split references in the
// bucket layout (hi, lo, |r|^2) and max |r|^2.
long long iggt_bucket_scratch_bytes(long long R, int nb) {
  return nb > 0 ? bucket_rows(R, nb) * (2 * D * 4 + 4) + 256 : 0;
}

// query (Q, 8) and ref (R, 8): contiguous fp32, 16-byte aligned; out_d (Q, nb)
// fp32 and out_i (Q, nb) int64; scratch of iggt_bucket_scratch_bytes(R, nb),
// 256-byte aligned.  ku, onepcu, floor_abs, passes: the filter as iggt_nn1
// takes it; rechecks (may be null) receives the number of exact chains
// computed.  *launches receives the number of bucket_filter_kernel launches.
// Returns a cudaError_t (0 on success).
int iggt_bucket_min(const float* query, const float* ref, float* out_d, long long* out_i,
                    long long Q, long long R, int nb, void* scratch, float ku, float onepcu,
                    float floor_abs, int passes, unsigned long long* rechecks, void* stream,
                    int* launches) {
  *launches = 0;
  if (Q <= 0 || R <= 0 || nb <= 0 || R > 0x7fffffffLL || (passes != 1 && passes != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = bucket_rows(R, nb), nb_pad = bucket_pad(nb);
  const long long blocks = (Q + bk::BM - 1) / bk::BM, groups = nb_pad / bk::BN;
  if (rows > 0x7fffffffLL - SPLIT_THREADS || blocks > 0x7fffffffLL || groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int J = (int)(rows / nb_pad);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  float* hi = reinterpret_cast<float*>(s);
  float* lo = reinterpret_cast<float*>(s + (size_t)rows * bk::ROW_BYTES);
  float* r2 = reinterpret_cast<float*>(s + (size_t)rows * 2 * bk::ROW_BYTES);
  unsigned* max_r2 = reinterpret_cast<unsigned*>(s + (size_t)rows * (2 * bk::ROW_BYTES + 4));
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaMemsetAsync(max_r2, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  nn1_split_kernel<<<(unsigned)((rows + SPLIT_THREADS - 1) / SPLIT_THREADS), SPLIT_THREADS, 0,
                     st>>>(ref, hi, lo, r2, max_r2, (int)R, nb, (int)nb_pad, (int)rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap thi, tlo, tr2;
  if (!make_chunk_map(&thi, hi, (int)nb_pad, J) || !make_chunk_map(&tlo, lo, (int)nb_pad, J) ||
      !make_chunk_r2_map(&tr2, r2, (int)nb_pad, J)) {
    return (int)cudaErrorInvalidValue;
  }
  BucketArgs a;
  a.query = query; a.max_r2 = max_r2; a.out_d = out_d; a.out_i = out_i;
  a.rechecks = rechecks;
  a.Q = Q; a.R = (int)R; a.nb = nb;
  a.ku = ku; a.onepcu = onepcu; a.floor_abs = floor_abs;
  auto kern = passes == 3 ? bucket_filter_kernel<3> : bucket_filter_kernel<1>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bk::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)blocks, (unsigned)groups), bk::THREADS, bk::SMEM, st>>>(thi, tlo, tr2, a);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launches = 1;
  return (int)err;
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
