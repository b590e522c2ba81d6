// Exact 1-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   iggt_official_tpu/ops/nn1_pallas.py::nn1_pallas  (_nn1_kernel)
//
// What it computes, for every query row q of a (Q, 8) fp32 matrix against a
// (R, 8) fp32 reference matrix:
//   d2(q, r) = sum over a = 0..7, in that order, of (q_a - r_a)^2, each
//              subtraction, square and addition rounded on its own (no FMA)
//   out[q]   = the smallest index r with the least d2 (int64)
// The clustering pipeline runs it twice per scene: the noise reassignment
// (Q = noise points, R = clustered points of the <= 150k subsample) and the
// full-density backfill (Q = every pixel, up to 2.15M, R = the 150k subsample).
//
// What bounds it on an H100: 3 fp32 operations per dimension per (query,
// reference) pair, 3 * Q * R * 8 in all (7.7e12 at 2.15M x 150k), against
// 67 TFLOP/s of fp32; the inputs are a few tens of MB, so bytes do not bound
// it.  Written without FMA, each of the 3 operations is its own instruction,
// so the instruction floor is about twice the flop bound.  Exactness rules the
// design: reduced precision (TF32, or the |q|^2 + |r|^2 - 2 q.r expansion)
// flips nearest-neighbour picks on unit-norm features, so every distance is
// the plain fp32 sum, bit for bit the plain PyTorch version's
// (`ops/nn1.py::nn1_plain`), and kernel and plain version return equal indices.
//
// Design (simple and right first; several queries per thread, cp.async double
// buffering and the fp32 pipe's throughput come later):
//   * one thread per query row; its 8 floats live in registers (two 16-byte
//     loads);
//   * each block of 256 threads stages 1024 reference rows at a time in shared
//     memory (32 KB, two float4 per row); every thread of a warp then reads the
//     same row, a broadcast, as two 16-byte shared loads per pair;
//   * each thread keeps a running (min, argmin) in registers and walks the
//     references in ascending index with a strict `<`, so ties go to the
//     smallest index with no extra pass (the Pallas kernel's index-min pass and
//     its (BQ, BK) VMEM tiles have no counterpart here);
//   * row offsets and indices are 64-bit (Q reaches 2.15M on the demo path and
//     Q * R 3.2e11), and the result is written as int64, the caller's type.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 8;
constexpr int THREADS = 256;
constexpr int TILE = 1024;  // reference rows per shared-memory stage

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

__global__ void __launch_bounds__(THREADS)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           long long* __restrict__ out, long long Q, long long R) {
  __shared__ float4 tile[TILE][2];

  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = qi < Q;
  float q[D];
  {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (live) {
      const float4* p = reinterpret_cast<const float4*>(query + qi * D);
      a = p[0];
      b = p[1];
    }
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
  }

  float best = INFINITY;
  long long best_i = 0;
  for (long long base = 0; base < R; base += TILE) {
    const int n = (int)min((long long)TILE, R - base);
    __syncthreads();  // the previous stage is consumed
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float4* p = reinterpret_cast<const float4*>(ref + (base + j) * D);
      tile[j][0] = p[0];
      tile[j][1] = p[1];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float d = sq_diff_sum(q, tile[j][0], tile[j][1]);
        if (d < best) {
          best = d;
          best_i = base + j;
        }
      }
    }
  }
  if (live) out[qi] = best_i;
}

}  // namespace

extern "C" {

// query (Q, 8) and ref (R, 8): contiguous fp32, 16-byte aligned; out (Q,)
// int64.  Returns a cudaError_t (0 on success).
int iggt_nn1(const float* query, const float* ref, long long* out,
             long long Q, long long R, void* stream) {
  if (Q <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (Q + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nn1_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, out, Q, R);
  return (int)cudaGetLastError();
}

const char* iggt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
