// Batched small SPD solve, x[b] = A[b]^-1 y[b], for Hopper (sm_90a).
//
// Replaces the TPU kernel lkpy_tpu/ops/pallas_solve.py::_gj_kernel (entry
// point spd_solve): the ALS fold-in solve on the implicit-ALS serving path
// (ops/als.py::batched_spd_solve <- solve_implicit_bucket <-
// models/als.py::_fold_implicit_kernel <- batch/serving.py).
//
// Contract: A is (B, k, k) f32 row-major and symmetric positive definite
// (only its lower triangle is read), y is (B, k) f32, x is (B, k) f32, and
// 1 <= k <= 256.  No pivoting, as for LAPACK sposv: a zero or negative pivot
// gives NaN or inf (the square root of a non-positive number, or a division
// by zero), which then reaches x.
//
// Bound at the serving path's shape (one block of B = 1024 users, k = 64):
//   bytes: only A's lower triangle is read, so B*k(k+1)/2*4 + 2*B*k*4 =
//   9.04 MB per launch -> 2.70 us at 3.35 TB/s;
//   f32 work: about k^3/3 + 2k^2 = 95.6k flops per system, 97.9 Mflop per
//   launch -> 1.46 us at 67 TFLOP/s.
// So the launch is bound by reading A's lower triangle once.  The design
// reads it once with coalesced loads (the upper part is never loaded), keeps
// the factorisation entirely in shared memory
// and writes only x.  It is the simple first form: one thread block per
// system walks k dependent Cholesky steps with two barriers each, so the
// time is set by that chain of barriers and shared-memory latency, not by
// device memory.  Batching several systems per block or holding a system
// in registers across a warp is the way to the bound and is later work.
//
// Layout per block (dynamic shared memory):
//   L   packed lower triangle, row i starts at i*(i+1)/2: k(k+1)/2 floats
//       (131,584 bytes at k = 256; the full k*(k+1) tableau of the TPU
//       kernel would be 263,168 bytes, above the 227 KB a block may use);
//   col the scaled column of the current step: k floats;
//   z   the right-hand side, turned into L^-1 y during the factorisation.
//
// Products and differences use __fmul_rn/__fsub_rn so that nvcc does not
// contract them into fused multiply-adds: the arithmetic is then the same,
// operation for operation, as spd_solve_plain in ops/spd_solve.py.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__global__ void spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ y,
                                 float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  float* L = smem;
  float* col = L + tri(k);
  float* z = col + k;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t b = blockIdx.x;

  const float* Ab = A + b * k * k;
  for (int idx = tid; idx < k * k; idx += nt) {
    const int i = idx / k;
    const int c = idx - i * k;
    if (c <= i) L[tri(i) + c] = Ab[idx];
  }
  for (int i = tid; i < k; i += nt) z[i] = y[b * k + i];
  __syncthreads();

  // right-looking Cholesky, forward substitution folded into each step
  for (int j = 0; j < k; ++j) {
    const float d = sqrtf(L[tri(j) + j]);
    for (int i = j + 1 + tid; i < k; i += nt) {
      const float v = __fdiv_rn(L[tri(i) + j], d);
      L[tri(i) + j] = v;
      col[i] = v;
    }
    if (tid == 0) z[j] = __fdiv_rn(z[j], d);
    __syncthreads();

    // trailing update of the lower triangle: one warp per row, lanes along it
    for (int i = j + 1 + warp; i < k; i += nwarps) {
      const float ci = col[i];
      float* Li = L + tri(i);
      for (int c = j + 1 + lane; c <= i; c += 32) Li[c] = __fsub_rn(Li[c], __fmul_rn(ci, col[c]));
    }
    const float zj = z[j];
    for (int i = j + 1 + tid; i < k; i += nt) z[i] = __fsub_rn(z[i], __fmul_rn(col[i], zj));
    if (tid == 0) L[tri(j) + j] = d;
    __syncthreads();
  }

  // back substitution with L^T
  float* xb = x + b * k;
  for (int j = k - 1; j >= 0; --j) {
    const float* Lj = L + tri(j);
    const float xj = __fdiv_rn(z[j], Lj[j]);
    for (int i = tid; i < j; i += nt) z[i] = __fsub_rn(z[i], __fmul_rn(Lj[i], xj));
    if (tid == 0) xb[j] = xj;
    __syncthreads();
  }
}

}  // namespace

extern "C" int lkt_spd_solve_f32(const float* A, const float* y, float* x, int B, int k, void* stream) {
  if (B <= 0 || k < 1 || k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = k <= 64 ? 128 : 256;
  const size_t smem = static_cast<size_t>(k * (k + 1) / 2 + 2 * k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spd_solve_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, y, x, k);
  return static_cast<int>(cudaGetLastError());
}
