// Flash attention for Hopper (sm_90a), and the q/k prep of its fused variant.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   iggt_official_tpu/ops/flash_attention.py::flash_attention        (_flash_kernel)
//   iggt_official_tpu/ops/flash_attention.py::flash_attention_fused  (_flash_fused_kernel,
//                                                                     _ln_rope_block, _rot_matrix)
//
// What it computes, per (batch b, head h, query row):
//   s   = (q . k) accumulated in fp32, times D^-1/2, plus key_bias[b, key]; keys past
//         Nk masked out
//   online softmax in fp32 (running max m, running sum l, fp32 accumulator)
//   p   is rounded to V's dtype before P.V, which accumulates in fp32
//   out = acc / max(l, 1e-30), cast to q's dtype
// The fused variant first preps q and k: fp32 head-dim LayerNorm with the fast
// variance E[x^2] - mu^2 (clamped at 0), then 2D RoPE x*cos + rot_half(x)*sin, then
// one rounding to the compute dtype.
//
// What bounds it on an H100: tensor-core operations, at every main-path shape.
// Attention does 4*D flops per (query, key) pair for 4*D bytes of K/V per key row:
// the 8-view 518 px global block (1, 10992, 16, 64) does 4.95e11 flops (0.50 ms at
// 989 TF/s) and moves 90 MB (0.027 ms at 3.35 TB/s); the frame block (8, 1374, 16, 64)
// does 6.2e10 flops (0.0625 ms) for 45 MB.  Only wgmma reaches Hopper's tensor-core
// rate, and only if the loads never stall it.
//
// Kernels:
//   * flash_kernel_qk_prep (bf16 fused variant): one warp per (token, head) row of q
//     and of k, four rows' loads in flight per warp (coalesced loads, warp-shuffle
//     sums; rot_half takes the partner lane, lane ^ D/4, with a shuffle), each row
//     written once, rounded once, into contiguous scratch that the wgmma kernel then
//     reads.  The TPU kernel prepped K inside the attention loop, once per 512-row
//     query block, which one 2048-key block made cheap there; on Hopper's 128-row
//     query tiles that would prep each K row 11x (frame) to 86x (global) over, so
//     every row is prepped exactly once.
//   * flash_kernel_wgmma (bf16, D = 32 or 64): one block per (128-row query tile,
//     b*h), the query tiles of one (b, h) adjacent in the grid, so a head's K and V
//     stay in L2.  Three warpgroups: a producer, whose one thread keeps TMA loads in
//     flight (Q once; K and V through a ring of 3 stages of 128 keys, completed on
//     mbarriers), and two consumers of 64 query rows each.  The TMA descriptors read
//     the strided (B, N, H, D) views in place (dims D, N, H, B) and zero-fill rows
//     past N; tiles land with the 128-byte (D = 64) or 64-byte (D = 32) swizzle that
//     the wgmma descriptors name.  S = Q.K^T is wgmma.m64n128k16 with both operands
//     in shared memory (K-major); the online softmax runs in registers with the scale
//     folded into exp2; P is rounded to bf16 straight into the register A operand of
//     O += P.V, wgmma.m64nDk16 with V's row-major tile read through the transpose bit.
//     Within a consumer, S of tile i and P.V of tile i - 1 are issued together, and
//     the softmax of tile i runs while P.V(i - 1) is on the tensor cores; the two
//     consumers run independently, so one's softmax also overlaps the other's
//     products.  setmaxnreg moves registers from the producer (24) to the
//     consumers (240).
//   * flash_kernel_simt (fp32: the part head's cross-attention with fp32 heads, and
//     the fp32 trunk): one block of 4 warps per (64-row query tile, b*h), scalar FMAs
//     in full fp32 (no TF32), logits and the accumulator in shared memory, each lane
//     owning two key columns of S and the same output columns of O; 16-byte loads
//     where rows allow; when fused, each q/k tile is prepped as it is loaded (the
//     same prep_row as the bf16 prep kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;      // query rows owned by one warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float f(float x) { return x; }
  __device__ static float t(float x) { return x; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ static float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 t(float x) { return __float2bfloat16(x); }
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

struct Args {
  const void* q; const void* k; const void* v; void* o;
  const float* key_bias;                        // (B, Nk) or null
  const float* cos; const float* sin;           // (B, N, D) fp32, last dim contiguous
  long long rope_sb, rope_sn;
  const float* gq; const float* bq; const float* gk; const float* bk;  // (D,) each
  int use_norm, use_rope;
  int B, H, Nq, Nk;
  long long q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh;
  float scale, eps;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// (lo, hi) -> bf16x2 with lo in the low half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [n0, n0+64) of one head into a shared tile with row stride LDT;
// rows >= n_valid are zero.  16-byte vector loads when the source rows allow it.
template <typename T, int D, int LDT>
__device__ void load_tile(T* dst, const T* src, long long sn, int n0, int n_valid) {
  constexpr int VE = 16 / sizeof(T);            // elements per 16-byte vector
  constexpr int VPR = D / VE;                   // vectors per row
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     static_cast<uintptr_t>(sn * sizeof(T))) % 16) == 0;
  if (vec) {
    for (int idx = threadIdx.x; idx < 64 * VPR; idx += NTHREADS) {
      const int r = idx / VPR, c = (idx % VPR) * VE;
      const int n = n0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < n_valid) val = *reinterpret_cast<const uint4*>(src + (long long)n * sn + c);
      if constexpr ((LDT * sizeof(T)) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
      } else {
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int i = 0; i < VE; ++i) dst[r * LDT + c + i] = e[i];
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D;
      const int n = n0 + r;
      dst[r * LDT + d] = n < n_valid ? src[(long long)n * sn + d] : Num<T>::t(0.f);
    }
  }
}

// The q/k prep of one row held in registers, each lane owning columns
// e * 32 + lane: fp32 LayerNorm (fast variance, clamped at 0) then RoPE.
template <int D>
__device__ __forceinline__ void prep_row(float (&x)[D / 32], const Args& a, int b, int n,
                                         const float* gamma, const float* beta) {
  constexpr int E = D / 32;
  constexpr int Q4 = D / 4;                      // rotate-half partner distance
  const int lane = threadIdx.x % 32;
  if (a.use_norm) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { s += x[e]; s2 += x[e] * x[e]; }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / D;
    const float var = fmaxf(s2 / D - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + a.eps);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * 32 + lane;
      x[e] = (x[e] - mu) * inv * gamma[j] + beta[j];
    }
  }
  if (a.use_rope) {
    const float* cr = a.cos + b * a.rope_sb + n * a.rope_sn;
    const float* sr = a.sin + b * a.rope_sb + n * a.rope_sn;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * 32 + lane;
      const float partner = __shfl_xor_sync(FULL, x[e], Q4);
      const float rot = (lane & Q4) ? partner : -partner;
      x[e] = x[e] * cr[j] + rot * sr[j];
    }
  }
}

// The q/k prep on rows [n0, n0+64) of a tile (the fp32 kernel's fused variant):
// each warp takes 16 rows, each lane D/32 columns, then one cast to T.
template <typename T, int D, int LDT>
__device__ void load_tile_prepped(T* dst, const T* src, long long sn, int n0, int n_valid,
                                  const Args& a, int b, const float* gamma, const float* beta) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    const int n = n0 + r;
    float x[E];
    if (n < n_valid) {                           // warp-uniform
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = Num<T>::f(src[(long long)n * sn + e * 32 + lane]);
      prep_row<D>(x, a, b, n, gamma, beta);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[r * LDT + e * 32 + lane] = Num<T>::t(x[e]);
  }
}

template <typename T, int D, int LDT, bool FUSED, bool HAS_BIAS>
__device__ __forceinline__ void load_kv_tile(T* Ks, T* Vs, float* Bs, const T* kp, const T* vp,
                                             int k0, const Args& a, int b) {
  if (FUSED) {
    load_tile_prepped<T, D, LDT>(Ks, kp, a.k_sn, k0, a.Nk, a, b, a.gk, a.bk);
  } else {
    load_tile<T, D, LDT>(Ks, kp, a.k_sn, k0, a.Nk);
  }
  load_tile<T, D, LDT>(Vs, vp, a.v_sn, k0, a.Nk);
  if (HAS_BIAS && threadIdx.x < BK) {
    const int key = k0 + threadIdx.x;
    Bs[threadIdx.x] = key < a.Nk ? a.key_bias[(long long)b * a.Nk + key] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 q/k prep (fused variant): every row once, into contiguous (B, N, H, D) scratch.

constexpr int PREP_WARPS = 8;
constexpr int PREP_ROWS = 4;                     // rows per warp, loaded before any is prepped

// blockIdx.y: 0 preps q, 1 preps k; a warp takes PREP_ROWS output rows (b, n, h)
// and issues all their loads first, so enough bytes are in flight to keep device
// memory busy.
template <int D>
__global__ void __launch_bounds__(PREP_WARPS * 32)
    flash_kernel_qk_prep(const Args a, __nv_bfloat16* q_out, __nv_bfloat16* k_out) {
  using T = __nv_bfloat16;
  constexpr int E = D / 32;
  const bool is_k = blockIdx.y == 1;
  const int N = is_k ? a.Nk : a.Nq;
  const int rows = a.B * N * a.H;                // < 2^31 (checked at launch)
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * PREP_WARPS + threadIdx.x / 32) * PREP_ROWS;
  if (row0 >= rows) return;                      // warp-uniform
  const T* base = static_cast<const T*>(is_k ? a.k : a.q);
  const long long sb = is_k ? a.k_sb : a.q_sb, sn = is_k ? a.k_sn : a.q_sn;
  const long long sh = is_k ? a.k_sh : a.q_sh;
  float x[PREP_ROWS][E];
  int bs[PREP_ROWS], ns[PREP_ROWS];
#pragma unroll
  for (int r = 0; r < PREP_ROWS; ++r) {
    const int row = row0 + r;
    if (row < rows) {
      const int h = row % a.H;
      ns[r] = (row / a.H) % N;
      bs[r] = row / (a.H * N);
      const T* src = base + bs[r] * sb + ns[r] * sn + h * sh;
#pragma unroll
      for (int e = 0; e < E; ++e) x[r][e] = Num<T>::f(src[e * 32 + lane]);
    }
  }
  // every row is prepped before any is stored, so the compiler may issue all rows'
  // table loads together (a store could alias them)
#pragma unroll
  for (int r = 0; r < PREP_ROWS; ++r) {
    if (row0 + r < rows) {
      prep_row<D>(x[r], a, bs[r], ns[r], is_k ? a.gk : a.gq, is_k ? a.bk : a.bq);
    }
  }
  T* out = is_k ? k_out : q_out;
#pragma unroll
  for (int r = 0; r < PREP_ROWS; ++r) {
    const int row = row0 + r;
    if (row >= rows) break;                      // warp-uniform
    T* dst = out + (long long)row * D;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e * 32 + lane] = Num<T>::t(x[r][e]);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring.

namespace wg {
constexpr int BQ = 128;                          // query rows per block (2 consumers x 64)
constexpr int BK = 128;                          // keys per tile
constexpr int STAGES = 3;                        // K/V ring depth
constexpr int THREADS = 384;                     // producer + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;                // arrivals that free a ring stage
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg

template <int D>
struct WgLayout {
  static constexpr int ROW = D * 2;              // bytes per row: one swizzle span
  static constexpr int SWIZZLE = D == 64 ? 1 : 2;  // descriptor layout: 1 = 128 B, 2 = 64 B
  static constexpr int GROUP = 8 * ROW;          // 8 rows, one swizzle atom
  static constexpr int Q_BYTES = wg::BQ * ROW;
  static constexpr int TILE_BYTES = wg::BK * ROW;
  static constexpr size_t q = 0;                 // every tile 1024-byte aligned
  static constexpr size_t k = q + Q_BYTES;
  static constexpr size_t v = k + wg::STAGES * TILE_BYTES;
  static constexpr size_t bars = v + wg::STAGES * TILE_BYTES;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * wg::STAGES) + 1024;  // + base alignment
};

// A box of the 4-D tensor map (D, N, H, B) at (0, row, h, b) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, fp32 registers) (+)= A (64 x 16, shared, K-major) . B^T (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, fp32 registers) += A (64 x 16, bf16 registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32 registers) += A (64 x 16, bf16 registers) . B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}


// Online softmax of one 64 x 128 logit tile in the wgmma accumulator layout, for
// this thread's rows g and g + 8: the running max m (log2 units: logits times
// D^-1/2 log2(e)), this thread's share l of the running sums, the factor al that
// rescales what was accumulated before.  Leaves P = 2^(s - m) in sc.
struct Softmax {
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0 = 0.f, al1 = 0.f;

  template <bool HAS_BIAS>
  __device__ __forceinline__ void update(float (&sc)[wg::BK / 2], int k0, const Args& a, int b,
                                         int t) {
    float mult = a.scale * wg::LOG2E;
    if (HAS_BIAS || k0 + wg::BK > a.Nk) {        // scale, add the bias, mask keys past Nk
#pragma unroll
      for (int j = 0; j < wg::BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + 2 * t + e;
          const float bias =
              HAS_BIAS && key < a.Nk ? a.key_bias[(long long)b * a.Nk + key] * wg::LOG2E : 0.f;
          const bool out = key >= a.Nk;
          sc[4 * j + e] = out ? NEG_INF : sc[4 * j + e] * mult + bias;
          sc[4 * j + 2 + e] = out ? NEG_INF : sc[4 * j + 2 + e] * mult + bias;
        }
      }
      mult = 1.f;
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < wg::BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * mult), mn1 = fmaxf(m1, mx1 * mult);  // mult > 0
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < wg::BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], mult, -mn0));
        sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], mult, -mn1));
        ps0 += sc[4 * j + e];
        ps1 += sc[4 * j + 2 + e];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
  }
};

// Accumulator layout of wgmma.m64nN (per warp w of a warpgroup, g = lane / 4,
// t = lane % 4): d[4j + e] is row 16w + g, column 8j + 2t + e; d[4j + 2 + e] is row
// 16w + g + 8.  The register A operand of m64k16 is mma.m16n8k16's: a0 = (g, 2t..),
// a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..), so the n8 blocks
// 2c and 2c + 1 of S become the A fragment of key chunk c.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + wg::STAGES;

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * wg::BQ;
  const int ntiles = (a.Nk + wg::BK - 1) / wg::BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < wg::STAGES; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      tma_load(smem + L::q, &tq, q_full, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % wg::STAGES;
        mbar_wait(kv_empty + s, ((it / wg::STAGES) & 1) ^ 1);
        mbar_expect_tx(kv_full + s, 2 * L::TILE_BYTES);
        tma_load(smem + L::k + s * L::TILE_BYTES, &tk, kv_full + s, it * wg::BK, h, b);
        tma_load(smem + L::v + s * L::TILE_BYTES, &tv, kv_full + s, it * wg::BK, h, b);
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int half = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // Q and K: K-major (D contiguous), leading offset unused (16 B), 8-row groups
    // GROUP bytes apart; a k16 step is 32 bytes along the row.  V: MN-major (D
    // contiguous along N), one swizzle atom wide, 8-key groups GROUP bytes apart; a
    // k16 step is 16 rows.
    const uint64_t dq = smem_desc(smem + L::q + half * 64 * L::ROW, 16, L::GROUP, L::SWIZZLE);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    Softmax sm;
    float sc[wg::BK / 2];                        // S of the newest tile, then its P in fp32
    uint32_t pa[wg::BK / 16][4];                 // P of the tile whose P.V is in flight
    auto stage_desc = [&](size_t base, int it) {
      return smem_desc(smem + base + (it % wg::STAGES) * L::TILE_BYTES, 16, L::GROUP,
                       L::SWIZZLE);
    };
    auto issue_s = [&](int it) {                 // sc = Q.K^T of tile it
      const uint64_t dk = stage_desc(L::k, it);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) wgmma_ss_n128(sc, dq + 2 * kc, dk + 2 * kc, kc > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int it) {                // o += P.V of tile it
      const uint64_t dv = stage_desc(L::v, it);
#pragma unroll
      for (int kc = 0; kc < wg::BK / 16; ++kc) wgmma_rs<D>(o, pa[kc], dv + kc * (16 * L::ROW >> 4));
      wgmma_commit();
    };
    // after P.V of a tile is done: rescale o by the newer tile's alpha, and
    // round that tile's P into the A operand of the next P.V
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[4 * dn + 0] *= sm.al0;
        o[4 * dn + 1] *= sm.al0;
        o[4 * dn + 2] *= sm.al1;
        o[4 * dn + 3] *= sm.al1;
      }
#pragma unroll
      for (int j = 0; j < wg::BK / 8; ++j) {
        pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    // The P.V of tile it - 1 runs on the tensor cores while the softmax of tile
    // it runs on the other units: S(it) and P.V(it - 1) are issued together,
    // S(it) is waited for (groups complete in order), then P.V(it - 1).
    mbar_wait(q_full, 0);
    mbar_wait(kv_full, 0);
    fence_regs(sc);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    sm.update<HAS_BIAS>(sc, 0, a, b, t);
    rescale_and_pack();
    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(kv_full + it % wg::STAGES, (it / wg::STAGES) & 1);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      issue_s(it);
      issue_pv(it - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      sm.update<HAS_BIAS>(sc, it * wg::BK, a, b, t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + (it - 1) % wg::STAGES);
      rescale_and_pack();
    }
    fence_regs(o);
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    float l0 = sm.l0, l1 = sm.l1;

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int n0 = q0 + half * 64 + warp * 16 + g, n1 = n0 + 8;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
    uint32_t* out0 = reinterpret_cast<uint32_t*>(op + (((long long)b * a.Nq + n0) * a.H + h) * D);
    uint32_t* out1 = reinterpret_cast<uint32_t*>(op + (((long long)b * a.Nq + n1) * a.H + h) * D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = (dn * 8 + 2 * t) / 2;
      if (n0 < a.Nq) out0[c] = pack_bf16(o[4 * dn + 0] / d0, o[4 * dn + 1] / d0);
      if (n1 < a.Nq) out1[c] = pack_bf16(o[4 * dn + 2] / d1, o[4 * dn + 3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs in full fp32, logits and accumulator in shared memory.

template <int D>
struct SimtLayout {
  static constexpr int LDT = D + 1;             // Q/K/V tile row stride (floats)
  static constexpr int LDS = BK + 4;            // logits row stride
  static constexpr int LDO = D + 4;             // accumulator row stride
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(4 * BQ * LDT);
  static constexpr size_t v = k + align128(4 * BK * LDT);
  static constexpr size_t s = v + align128(4 * BK * LDT);
  static constexpr size_t o = s + align128(4 * BQ * LDS);
  static constexpr size_t bias = o + align128(4 * BQ * LDO);
  static constexpr size_t bytes = bias + align128(4 * BK);
};

template <int D, bool FUSED, bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS) flash_kernel_simt(const Args a) {
  using T = float;
  using L = SimtLayout<D>;
  constexpr int LDT = L::LDT, LDS = L::LDS, LDO = L::LDO;
  constexpr int E = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* Bs = reinterpret_cast<float*>(smem + L::bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  if (FUSED) {
    load_tile_prepped<T, D, LDT>(Qs, qp, a.q_sn, q0, a.Nq, a, b, a.gq, a.bq);
  } else {
    load_tile<T, D, LDT>(Qs, qp, a.q_sn, q0, a.Nq);
  }

  float m_row[ROWS], l_row[ROWS];                // identical in every lane of the warp
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_row[i] = NEG_INF;
    l_row[i] = 0.f;
    float* orow = Os + (warp * ROWS + i) * LDO;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * 32 + lane] = 0.f;
  }

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();                             // every warp is done with the last tile
    load_kv_tile<T, D, LDT, FUSED, HAS_BIAS>(Ks, Vs, Bs, kp, vp, k0, a, b);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows; lanes own keys lane and lane + 32.
    float acc[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k_lo = Ks[lane * LDT + d];
      const float k_hi = Ks[(lane + 32) * LDT + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = Qs[(warp * ROWS + i) * LDT + d];
        acc[i][0] = fmaf(qv, k_lo, acc[i][0]);
        acc[i][1] = fmaf(qv, k_hi, acc[i][1]);
      }
    }

    // Online softmax, row by row.
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      float s0 = acc[i][0] * a.scale;
      float s1 = acc[i][1] * a.scale;
      if (HAS_BIAS) {
        s0 += Bs[lane];
        s1 += Bs[lane + 32];
      }
      if (k0 + lane >= a.Nk) s0 = NEG_INF;
      if (k0 + lane + 32 >= a.Nk) s1 = NEG_INF;
      const float m_new = fmaxf(m_row[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float alpha = expf(m_row[i] - m_new);
      l_row[i] = l_row[i] * alpha + warp_sum(p0 + p1);
      m_row[i] = m_new;
      Ss[r * LDS + lane] = p0;
      Ss[r * LDS + lane + 32] = p1;
      float* orow = Os + r * LDO;
#pragma unroll
      for (int e = 0; e < E; ++e) orow[e * 32 + lane] *= alpha;
    }
    __syncwarp();

    // O += P V; lanes own output columns lane (and lane + 32).
    float pv[ROWS][E];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) pv[i][e] = 0.f;
    for (int j = 0; j < BK; ++j) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[j * LDT + e * 32 + lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Ss[(warp * ROWS + i) * LDS + j];
#pragma unroll
        for (int e = 0; e < E; ++e) pv[i][e] = fmaf(p, vv[e], pv[i][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) Os[(warp * ROWS + i) * LDO + e * 32 + lane] += pv[i][e];
    __syncwarp();
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    const int n = q0 + r;
    if (n >= a.Nq) continue;                     // warp-uniform
    const float denom = fmaxf(l_row[i], 1e-30f);
    T* orow = op + (((long long)b * a.Nq + n) * a.H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * 32 + lane] = Os[r * LDO + e * 32 + lane] / denom;
  }
}

// ---------------------------------------------------------------------------
// host side

// A bf16 (B, N, H, D) tensor with element strides (sb, sn, sh, 1) as the 4-D tensor
// map (D, N, H, B); boxes of `rows` rows of one (b, h), zero-filled past N.
bool make_tensor_map(CUtensorMap* map, const void* base, int D, int N, int H, int B,
                     long long sb, long long sn, long long sh, int rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool HAS_BIAS>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_tensor_map(&tq, a.q, D, a.Nq, a.H, a.B, a.q_sb, a.q_sn, a.q_sh, wg::BQ) ||
      !make_tensor_map(&tk, a.k, D, a.Nk, a.H, a.B, a.k_sb, a.k_sn, a.k_sh, wg::BK) ||
      !make_tensor_map(&tv, a.v, D, a.Nk, a.H, a.B, a.v_sb, a.v_sn, a.v_sh, wg::BK)) {
    return cudaErrorInvalidValue;
  }
  auto kern = flash_kernel_wgmma<D, HAS_BIAS>;
  const size_t bytes = WgLayout<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + wg::BQ - 1) / wg::BQ, a.B * a.H);
  kern<<<grid, wg::THREADS, bytes, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int D, bool FUSED, bool HAS_BIAS>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  auto kern = flash_kernel_simt<D, FUSED, HAS_BIAS>;
  const size_t bytes = SimtLayout<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// fp32: the scalar kernel, with the q/k prep of each tile inside when fused.
template <int D>
cudaError_t run_fp32(const Args& a, bool fused, bool has_bias, cudaStream_t stream) {
  if (fused) {
    return has_bias ? launch_simt<D, true, true>(a, stream)
                    : launch_simt<D, true, false>(a, stream);
  }
  return has_bias ? launch_simt<D, false, true>(a, stream)
                  : launch_simt<D, false, false>(a, stream);
}

// bf16: when fused, the prep kernel writes prepped q / k to the scratch, which the
// wgmma kernel then attends over.
template <int D>
cudaError_t run_bf16(const Args& a, bool fused, bool has_bias, void* q_prep, void* k_prep,
                     cudaStream_t stream) {
  Args b = a;
  if (fused) {
    const long long rows = (long long)a.B * (a.Nq > a.Nk ? a.Nq : a.Nk) * a.H;
    if (rows > 0x7fffffffLL - PREP_WARPS * PREP_ROWS) return cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rows + PREP_WARPS * PREP_ROWS - 1) /
                                       (PREP_WARPS * PREP_ROWS));
    flash_kernel_qk_prep<D><<<dim3(blocks, 2), PREP_WARPS * 32, 0, stream>>>(
        a, static_cast<__nv_bfloat16*>(q_prep), static_cast<__nv_bfloat16*>(k_prep));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    b.q = q_prep;
    b.k = k_prep;
    b.q_sb = (long long)a.Nq * a.H * D; b.q_sn = (long long)a.H * D; b.q_sh = D;
    b.k_sb = (long long)a.Nk * a.H * D; b.k_sn = (long long)a.H * D; b.k_sh = D;
  }
  return has_bias ? launch_wgmma<D, true>(b, stream) : launch_wgmma<D, false>(b, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  bf16 with use_norm or
// use_rope preps q and k into q_prep / k_prep (contiguous (B, Nq, H, D) and
// (B, Nk, H, D) scratch) first.  Returns a cudaError_t (0 on success).
int iggt_flash_attention(
    int dtype, int head_dim, int use_norm, int use_rope,
    const void* q, const void* k, const void* v, void* o,
    const float* key_bias,
    const float* rope_cos, const float* rope_sin, long long rope_sb, long long rope_sn,
    const float* gq, const float* bq, const float* gk, const float* bk,
    void* q_prep, void* k_prep,
    int B, int H, int Nq, int Nk,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float scale, float eps, void* stream) {
  if (Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (use_norm && !(gq && bq && gk && bk)) return (int)cudaErrorInvalidValue;
  if (use_rope && !(rope_cos && rope_sin)) return (int)cudaErrorInvalidValue;
  const bool fused = use_norm || use_rope;
  if (dtype == 1 && fused && !(q_prep && k_prep)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.key_bias = key_bias;
  a.cos = rope_cos; a.sin = rope_sin; a.rope_sb = rope_sb; a.rope_sn = rope_sn;
  a.gq = gq; a.bq = bq; a.gk = gk; a.bk = bk;
  a.use_norm = use_norm; a.use_rope = use_rope;
  a.B = B; a.H = H; a.Nq = Nq; a.Nk = Nk;
  a.q_sb = q_sb; a.q_sn = q_sn; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sn = k_sn; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sn = v_sn; a.v_sh = v_sh;
  a.scale = scale; a.eps = eps;
  const bool has_bias = key_bias != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 32 && head_dim != 64) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = head_dim == 32 ? run_fp32<32>(a, fused, has_bias, s)
                         : run_fp32<64>(a, fused, has_bias, s);
  } else if (dtype == 1) {
    err = head_dim == 32 ? run_bf16<32>(a, fused, has_bias, q_prep, k_prep, s)
                         : run_bf16<64>(a, fused, has_bias, q_prep, k_prep, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
