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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  return h;
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
constexpr int THREADS = 288;                     // 2 consumer warpgroups + a producer warp
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

// One reference per thread: the TF32 split, |r|^2 and the running max |r|^2.
// R_pad is a multiple of the block size, so every lane of a warp is live.
constexpr int SPLIT_THREADS = 256;

__global__ void __launch_bounds__(SPLIT_THREADS)
nn1_split_kernel(const float* __restrict__ ref, float* __restrict__ hi, float* __restrict__ lo,
                 float* __restrict__ r2, unsigned* __restrict__ max_r2, int R) {
  const int i = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  float n2 = INFINITY;
  if (i < R) {
    const float4* p = reinterpret_cast<const float4*>(ref + (long long)i * D);
    a = p[0];
    b = p[1];
    n2 = norm2(a, b);
  }
  const float x[D] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float h[D], l[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    // hi + lo == r exactly (the recheck rebuilds r from them); a value whose
    // rounding is not finite keeps hi = r, lo = 0
    h[k] = __uint_as_float(tf32_rna(x[k]));
    const bool fin = isfinite(h[k]);
    h[k] = fin ? h[k] : x[k];
    l[k] = fin ? __fsub_rn(x[k], h[k]) : 0.f;
  }
  float4* ph = reinterpret_cast<float4*>(hi + (long long)i * D);
  float4* pl = reinterpret_cast<float4*>(lo + (long long)i * D);
  ph[0] = make_float4(h[0], h[1], h[2], h[3]);
  ph[1] = make_float4(h[4], h[5], h[6], h[7]);
  pl[0] = make_float4(l[0], l[1], l[2], l[3]);
  pl[1] = make_float4(l[4], l[5], l[6], l[7]);
  r2[i] = n2;
  // as unsigned bits: non-negative floats order alike, and NaN lies above +inf
  const unsigned m = __reduce_max_sync(FULL, i < R ? __float_as_uint(n2) : 0u);
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

// D (64 x 64, fp32 registers) (+)= A (64 x 8, tf32 registers) . B^T (8 x 64,
// shared, K-major).  A per warp w: a0 = (16w + g, t), a1 = (16w + g + 8, t),
// a2 = (16w + g, t + 4), a3 = (16w + g + 8, t + 4), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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
        wgmma_tf32(acc, ahi[mt], dlo, 0);
        wgmma_tf32(acc, alo[mt], dhi, 1);
        wgmma_tf32(acc, ahi[mt], dhi, 1);
      } else {
        wgmma_tf32(acc, ahi[mt], dhi, 0);
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
// d2 the same exact fp32 chain as nn1's recheck.  The exact top-k over the nb
// bucket minima is taken outside the kernel (`ops/nn1.py::bucket_topk`), as
// the JAX package takes it outside its Pallas call.  No module calls it (as
// in the JAX package); it is a candidate for the clustering's core kNN.
//
// What bounds it: the same 3 * Q * R * 8 fp32 operations as nn1 (5.4e11 at
// Q = R = 150,000: 8.06 ms at 67 TFLOP/s, 16.1 ms of no-FMA instructions);
// the (Q, nb) minima it writes (1.8 GB with their int64 indices at nb = 1024)
// take ~0.55 ms at 3.35 TB/s.
//
// Design: one thread per (query, bucket).  A block of 256 threads holds 256
// adjacent buckets and BQ = 16 queries, staged in shared memory and read as
// broadcasts; each thread walks its bucket's references in ascending index
// (about R / nb = 147 rows), two 16-byte loads per row, adjacent threads on
// adjacent rows (coalesced, and the 4.8 MB reference set stays in L2), and
// keeps BQ running (min, argmin) pairs in registers with a strict `<`, so a
// tie goes to the smallest index in the bucket with no merge between threads.
// An empty bucket (b >= R) keeps +inf and index b, as the Pallas kernel does.
constexpr int BT_THREADS = 256;
constexpr int BT_BQ = 16;

__global__ void __launch_bounds__(BT_THREADS)
bucket_min_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                  float* __restrict__ out_d, long long* __restrict__ out_i,
                  long long Q, long long R, int nb) {
  __shared__ float4 qs[BT_BQ][2];
  const long long q0 = (long long)blockIdx.y * BT_BQ;
  const int b = blockIdx.x * BT_THREADS + threadIdx.x;
  if (threadIdx.x < 2 * BT_BQ) {
    const int j = threadIdx.x >> 1, h = threadIdx.x & 1;
    qs[j][h] = q0 + j < Q ? reinterpret_cast<const float4*>(query + (q0 + j) * D)[h]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (b >= nb) return;

  float best[BT_BQ];
  long long best_i[BT_BQ];
#pragma unroll
  for (int j = 0; j < BT_BQ; ++j) {
    best[j] = INFINITY;
    best_i[j] = b;
  }
  for (long long r = b; r < R; r += nb) {
    const float4* p = reinterpret_cast<const float4*>(ref + r * D);
    const float4 ra = p[0], rb = p[1];
    const float rr[D] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int j = 0; j < BT_BQ; ++j) {
      const float4 qa = qs[j][0], qb = qs[j][1];
      const float q[D] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float d = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float diff = __fsub_rn(q[k], rr[k]);
        d = __fadd_rn(d, __fmul_rn(diff, diff));
      }
      if (d < best[j]) {
        best[j] = d;
        best_i[j] = r;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BT_BQ; ++j) {
    if (q0 + j < Q) {
      out_d[(q0 + j) * nb + b] = best[j];
      out_i[(q0 + j) * nb + b] = best_i[j];
    }
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
                                                                    (int)R);
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

// query (Q, 8) and ref (R, 8): contiguous fp32, 16-byte aligned; out_d (Q, nb)
// fp32 and out_i (Q, nb) int64.  *launches receives the number of kernels
// launched.  Returns a cudaError_t (0 on success).
int iggt_bucket_min(const float* query, const float* ref, float* out_d, long long* out_i,
                    long long Q, long long R, int nb, void* stream, int* launches) {
  *launches = 0;
  if (Q <= 0 || R <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const long long qblocks = (Q + BT_BQ - 1) / BT_BQ;
  // grid.y is at most 65535: further query blocks go to further launches
  const long long per_launch = 65535;
  for (long long s = 0; s < qblocks; s += per_launch) {
    const long long n = qblocks - s < per_launch ? qblocks - s : per_launch;
    const dim3 grid((unsigned)((nb + BT_THREADS - 1) / BT_THREADS), (unsigned)n);
    const long long q_off = s * BT_BQ;
    bucket_min_kernel<<<grid, BT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        query + q_off * D, ref, out_d + q_off * nb, out_i + q_off * nb, Q - q_off, R, nb);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
