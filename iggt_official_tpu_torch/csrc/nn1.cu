// Exact 1-nearest-neighbour search and per-bucket nearest references for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   iggt_official_tpu/ops/nn1_pallas.py::nn1_pallas  (_nn1_kernel)
//   iggt_official_tpu/ops/nn1_pallas.py::bucket_topk_pallas  (_bucket_topk_kernel),
//   described after nn1_kernel below
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

// Per-bucket nearest references: for every query q and bucket b < nb, the
// least d2(q, r) over the references r = b, b + nb, b + 2 nb, ... (bucket of a
// reference = its index mod nb) and the smallest such r attaining it, with
// d2 the same exact fp32 chain as nn1_kernel.  The exact top-k over the nb
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
