// Flash attention for Hopper (sm_90a), with an optional in-kernel q/k prep.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   iggt_official_tpu/ops/flash_attention.py::flash_attention        (_flash_kernel)
//   iggt_official_tpu/ops/flash_attention.py::flash_attention_fused  (_flash_fused_kernel,
//                                                                     _ln_rope_block, _rot_matrix)
// One templated kernel per compute dtype serves both: FUSED turns the q/k prep on (fp32
// head-dim LayerNorm with the fast variance E[x^2]-mu^2, then 2D RoPE
// x*cos + rot_half(x)*sin, then one rounding to the compute dtype), HAS_BIAS adds a
// per-key fp32 logit bias.
//
// What it computes, per (batch b, head h, query row):
//   s   = (q . k) accumulated in fp32, times D^-1/2, plus key_bias[b, key]; keys past
//         Nk masked to -1e30
//   online softmax in fp32 (running max m, running sum l, fp32 accumulator)
//   p   is cast to V's dtype before P.V, which accumulates in fp32
//   out = acc / max(l, 1e-30), cast to q's dtype
//
// What bounds it on an H100: at the main path's shapes (D = 64, N = 1374 per frame,
// N = 10992 over 8 views) attention does 4*N*D flops per key row for 4*D bytes of
// K/V, so it is bound by tensor-core work, not by HBM (the 8-view global block moves
// 90 MB for 4.95e11 flops: 0.027 ms of HBM time against 0.50 ms of bf16 tensor-core
// time).  The design therefore keeps the tensor cores fed from registers and shared
// memory and reads each K/V tile from HBM once per 64-row query tile.
//
// Design (simple and right first; wgmma/TMA, pipelining and tuning come later):
//   * one thread block of 4 warps per (64-row query tile, b*h); a loop over 64-key
//     tiles replaces the TPU's sequential key-block grid axis;
//   * q/k/v are read in place from strided (B, N, H, D) tensors (last dim contiguous;
//     16-byte vector loads when the rows are 16-byte aligned), so the wrapper needs no
//     transpose or padding copy; ragged tiles are zero-filled and masked;
//   * the query tile (prepped once when FUSED) and each K/V tile (K prepped as it is
//     loaded, so once per query tile) are staged in shared memory;
//   * bf16 (`flash_kernel_mma`): each warp owns 16 query rows.  Q.K^T and P.V run on
//     the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the logits,
//     the running max / sum and the output accumulator stay in registers, and the
//     probabilities go from the accumulator layout straight into the A operand of
//     P.V (rounded to bf16 there);
//   * fp32 (`flash_kernel_simt`): scalar FMAs in full fp32 (no TF32), logits and the
//     accumulator in shared memory, each lane owning two key columns of S and the
//     same output columns of O;
//   * the q/k prep gives each row to one warp (coalesced loads, warp-shuffle sums);
//     rot_half takes the partner lane (lane ^ D/4) with a shuffle; every product is
//     x * (+-1) in the TPU's matrix form, so the result is the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The q/k prep on rows [n0, n0+64): each warp takes 16 rows, each lane D/32 columns.
// fp32 LayerNorm (fast variance, clamped at 0) then RoPE, then one cast to T.
template <typename T, int D, int LDT>
__device__ void load_tile_prepped(T* dst, const T* src, long long sn, int n0, int n_valid,
                                  const Args& a, int b, const float* gamma, const float* beta) {
  constexpr int E = D / 32;
  constexpr int Q4 = D / 4;                      // rotate-half partner distance
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    const int n = n0 + r;
    float x[E];
    if (n < n_valid) {                           // warp-uniform
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = Num<T>::f(src[(long long)n * sn + e * 32 + lane]);
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
// bf16: tensor cores through mma.sync, softmax state in registers.

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) -> bf16x2 with lo in the low half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct MmaLayout {
  static constexpr int LDT = D + 8;             // 16-byte rows, conflict-free fragments
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(2 * BQ * LDT);
  static constexpr size_t v = k + align128(2 * BK * LDT);
  static constexpr size_t bias = v + align128(2 * BK * LDT);
  static constexpr size_t bytes = bias + align128(4 * BK);
};

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16x8, col):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):       c0, c1 = C[g][2t], C[g][2t+1];  c2, c3 = C[g+8][2t], C[g+8][2t+1]
template <int D, bool FUSED, bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS) flash_kernel_mma(const Args a) {
  using T = __nv_bfloat16;
  using L = MmaLayout<D>;
  constexpr int LDT = L::LDT;
  constexpr int KC = D / 16;                    // k-chunks of Q.K^T
  constexpr int NS = BK / 8;                    // n8 tiles of a 16 x 64 logit block
  constexpr int NO = D / 8;                     // n8 tiles of a 16 x D output block
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Bs = reinterpret_cast<float*>(smem + L::bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
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
  __syncthreads();
  uint32_t qa[KC][4];
  const T* qw = Qs + warp * ROWS * LDT;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = ld32(qw + g * LDT + kc * 16 + 2 * t);
    qa[kc][1] = ld32(qw + (g + 8) * LDT + kc * 16 + 2 * t);
    qa[kc][2] = ld32(qw + g * LDT + kc * 16 + 2 * t + 8);
    qa[kc][3] = ld32(qw + (g + 8) * LDT + kc * 16 + 2 * t + 8);
  }

  float o[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;             // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                     // this lane's share of the running sums

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();                             // every warp is done with the last tile
    load_kv_tile<T, D, LDT, FUSED, HAS_BIAS>(Ks, Vs, Bs, kp, vp, k0, a, b);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const T* kr = Ks + (j * 8 + g) * LDT + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mma_16816(s[j], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const float bias = HAS_BIAS ? Bs[c] : 0.f;
        float v0 = s[j][e] * a.scale + bias;
        float v1 = s[j][2 + e] * a.scale + bias;
        if (k0 + c >= a.Nk) v0 = v1 = NEG_INF;
        s[j][e] = v0;
        s[j][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pa[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p00 = expf(s[j][0] - mn0), p01 = expf(s[j][1] - mn0);
      const float p10 = expf(s[j][2] - mn1), p11 = expf(s[j][3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p00, p01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      o[dn][0] *= al0;
      o[dn][1] *= al0;
      o[dn][2] *= al1;
      o[dn][3] *= al1;
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const T* vr = Vs + (kc * 16 + 2 * t) * LDT + dn * 8 + g;
        mma_16816(o[dn], pa[kc], pack_pair(vr[0], vr[LDT]), pack_pair(vr[8 * LDT], vr[9 * LDT]));
      }
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int n0 = q0 + warp * ROWS + g, n1 = n0 + 8;
  T* op = static_cast<T*>(a.o);
  uint32_t* out0 = reinterpret_cast<uint32_t*>(op + (((long long)b * a.Nq + n0) * a.H + h) * D);
  uint32_t* out1 = reinterpret_cast<uint32_t*>(op + (((long long)b * a.Nq + n1) * a.H + h) * D);
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int c = (dn * 8 + 2 * t) / 2;
    if (n0 < a.Nq) out0[c] = pack_bf16(o[dn][0] / d0, o[dn][1] / d0);
    if (n1 < a.Nq) out1[c] = pack_bf16(o[dn][2] / d1, o[dn][3] / d1);
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

template <typename T, int D, bool FUSED, bool HAS_BIAS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  void (*kern)(const Args);
  size_t bytes;
  if constexpr (sizeof(T) == 2) {
    kern = flash_kernel_mma<D, FUSED, HAS_BIAS>;
    bytes = MmaLayout<D>::bytes;
  } else {
    kern = flash_kernel_simt<D, FUSED, HAS_BIAS>;
    bytes = SimtLayout<D>::bytes;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_flags(const Args& a, bool fused, bool has_bias, cudaStream_t stream) {
  if (fused) {
    return has_bias ? launch<T, D, true, true>(a, stream) : launch<T, D, true, false>(a, stream);
  }
  return has_bias ? launch<T, D, false, true>(a, stream) : launch<T, D, false, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, int head_dim, bool fused, bool has_bias,
                         cudaStream_t stream) {
  if (head_dim == 32) return dispatch_flags<T, 32>(a, fused, has_bias, stream);
  if (head_dim == 64) return dispatch_flags<T, 64>(a, fused, has_bias, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int iggt_flash_attention(
    int dtype, int head_dim, int use_norm, int use_rope,
    const void* q, const void* k, const void* v, void* o,
    const float* key_bias,
    const float* rope_cos, const float* rope_sin, long long rope_sb, long long rope_sn,
    const float* gq, const float* bq, const float* gk, const float* bk,
    int B, int H, int Nq, int Nk,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float scale, float eps, void* stream) {
  if (Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (use_norm && !(gq && bq && gk && bk)) return (int)cudaErrorInvalidValue;
  if (use_rope && !(rope_cos && rope_sin)) return (int)cudaErrorInvalidValue;
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
  const bool fused = use_norm || use_rope;
  const bool has_bias = key_bias != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dim<float>(a, head_dim, fused, has_bias, s);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(a, head_dim, fused, has_bias, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
