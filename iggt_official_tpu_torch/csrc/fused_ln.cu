// Fused LayerNorm over the last axis for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   iggt_official_tpu/ops/fused_ln.py::fused_layernorm  (_ln_kernel)
//
// What it computes, for every row x of a (rows, D) matrix in bf16 or fp32:
//   mu   = sum(x) / D                      (fp32)
//   var  = sum((x - mu)^2) / D             (fp32, two-pass: centred first)
//   y    = ((x - mu) * rsqrt(var + eps)) * gamma + beta   (fp32 affine)
// rounded once to the output type (bf16 or fp32).  rsqrt is correctly rounded
// (__frsqrt_rn) and every product and sum is rounded on its own (no FMA), so
// the kernel differs from the plain PyTorch version
// (`ops/fused_ln.py::fused_layernorm_plain`) only in the order of the two row
// sums: at most one bf16 ulp of an output.  The trunk calls it for every
// pre-norm of the DINOv2, frame and global blocks (144 calls per forward),
// at (10,992, 1024) bf16 for 8 views at 518 px.
//
// What bounds it on an H100: bytes.  Each row is read once and written once
// (2 * rows * D * 2 bytes in bf16, 45 MB at the 8-view 518 px shape, 0.0134 ms
// at 3.35 TB/s); the arithmetic is ~10 fp32 operations per element, far below
// the fp32 peak.  The plain version makes ~10 fp32 passes over device memory.
//
// Design (simple and right first):
//   * one warp per row, 8 rows per 256-thread block; a row is cut into
//     8-element chunks (one 16-byte load in bf16, two in fp32), chunk c going
//     to lane c mod 32, so a warp's loads are contiguous;
//   * the row stays in registers between the two passes (CPL chunks per lane,
//     a template parameter: D = 1024 holds 32 floats per lane), so device
//     memory is read once;
//   * both sums are per-lane sequential, then a butterfly of warp shuffles;
//   * gamma and beta (fp32) are read through the read-only cache;
//   * any row count (the last block is partial: whole warps exit), any D that
//     is a multiple of 8 up to 2048; the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;  // elements per chunk

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8_ro(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

template <typename Tin, typename Tout, int CPL>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const Tin* __restrict__ x, const float* __restrict__ gamma,
          const float* __restrict__ beta, Tout* __restrict__ y, long long rows, int D,
          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: every lane shares the row
  const int nchunks = D / VEC;
  const Tin* xr = x + row * D;

  float v[CPL][VEC];
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + c * 32;
    if (ch < nchunks) {
      load8(xr + ch * VEC, v[c]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s = __fadd_rn(s, v[c][k]);
    }
  }
  const float mu = __fdiv_rn(warp_sum(s), (float)D);

  float q = 0.0f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (lane + c * 32 < nchunks) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = __fsub_rn(v[c][k], mu);
        v[c][k] = d;
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)D), eps));

  Tout* yr = y + row * D;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + c * 32;
    if (ch < nchunks) {
      float g[VEC], b[VEC], o[VEC];
      load8_ro(gamma + ch * VEC, g);
      load8_ro(beta + ch * VEC, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][k], rstd), g[k]), b[k]);
      store8(yr + ch * VEC, o);
    }
  }
}

template <typename Tin, typename Tout>
int launch_typed(const void* x, const float* gamma, const float* beta, void* y,
                 long long rows, int D, float eps, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nchunks = D / VEC;
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* yo = static_cast<Tout*>(y);
  const dim3 grid((unsigned)blocks);
  if (nchunks <= 32) {
    ln_kernel<Tin, Tout, 1><<<grid, THREADS, 0, stream>>>(xi, gamma, beta, yo, rows, D, eps);
  } else if (nchunks <= 64) {
    ln_kernel<Tin, Tout, 2><<<grid, THREADS, 0, stream>>>(xi, gamma, beta, yo, rows, D, eps);
  } else if (nchunks <= 128) {
    ln_kernel<Tin, Tout, 4><<<grid, THREADS, 0, stream>>>(xi, gamma, beta, yo, rows, D, eps);
  } else {
    ln_kernel<Tin, Tout, 8><<<grid, THREADS, 0, stream>>>(xi, gamma, beta, yo, rows, D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, D) contiguous, dtype code 0 = fp32, 1 = bf16, 16-byte aligned;
// gamma, beta (D,) fp32; y (rows, D) of the output dtype code.  D must be a
// positive multiple of 8, at most 2048.  Returns a cudaError_t (0 on success).
int iggt_fused_ln(int in_dtype, int out_dtype, const void* x, const float* gamma,
                  const float* beta, void* y, long long rows, int D, float eps,
                  void* stream) {
  if (rows <= 0 || D <= 0 || D % VEC != 0 || D > 2048) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows, D, eps, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(x, gamma, beta, y, rows, D, eps, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_typed<float, __nv_bfloat16>(x, gamma, beta, y, rows, D, eps, s);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_typed<float, float>(x, gamma, beta, y, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
