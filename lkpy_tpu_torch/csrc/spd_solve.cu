// Batched small SPD solve, x[b] = A[b]^-1 y[b], for Hopper (sm_90a).
//
// Replaces the TPU kernel lkpy_tpu/ops/pallas_solve.py::_gj_kernel (entry
// point spd_solve): the ALS fold-in solve on the serving path
// (ops/als.py::batched_spd_solve <- solve_implicit_bucket or
// solve_explicit_bucket <- models/als.py::_fold_implicit_kernel or
// _fold_explicit_kernel <- batch/serving.py).
//
// Contract: A is (B, k, k) f32 row-major and symmetric positive definite
// (only its lower triangle is read), y is (B, k) f32, x is (B, k) f32, and
// 1 <= k <= 256.  No pivoting, as for LAPACK sposv: a zero or negative pivot
// gives non-finite values (the square root of a non-positive number or a
// division by zero on the shared-memory route, a NaN reciprocal on the
// register route) in that system's x only.
//
// Two routes, chosen from (B, k) alone by the Python wrapper
// (ops/spd_solve.py::fold_route):
//   k <= 128: the system held in registers (lkt_spd_solve_reg_f32), over 32,
//             64 or 128 threads a system;
//   k <= 256: the system held in shared memory, one block a system
//             (lkt_spd_solve_shared_f32), the kernel's first form.
//
// Bound at the serving path's shape (one block of B = 1024 users, k = 64):
//   bytes: only A's lower triangle is read, so B*k(k+1)/2*4 + 2*B*k*4 =
//   9.04 MB per launch -> 2.70 us at 3.35 TB/s;
//   f32 work: about k^3/3 + 2k^2 = 95.6k flops per system, 97.9 Mflop per
//   launch -> 1.46 us at 67 TFLOP/s.
// So the launch is bound by reading A's lower triangle once, but that bound
// lies under the time of one system's own chain: k elimination steps and k
// back-substitution steps, each waiting for the one before.  A serving
// block's 1,024 systems are less than one wave of the card, so the launch
// lasts as long as its slowest system's chain, and the design shortens the
// chain rather than the traffic.
//
// The register route (spd_register.cuh, shared with the training solve:
// LDL^T with one reciprocal a step and fmaf, the pivot column through a
// doubled buffer in shared memory, one barrier a step).  Two things differ
// from the training solve, whose batches of 30,000 systems fill every warp
// slot of the card with one warp a system.
//   The step: every instance here takes the header's look-ahead step, which
//   publishes column j+1 and the reciprocal of its pivot (the hardware's
//   approximation and one Newton step, in the pivot's thread alone) before
//   the rest of step j's update, so that the chain from step to step is a
//   load, a multiply, one fmaf, the reciprocal and a store.
//   The mapping: a small batch leaves the SMs' schedulers idle, so a system
//   of K = 64 may spread over two warps (16 x 4 threads, two systems a
//   block, each with a named barrier of its own) or four (16 x 8, one
//   system a block): a step's fused multiply-adds a thread fall from 80 to
//   40 and 24.  All mappings are compiled; the wrapper names the threads a
//   system and this file launches that instance.
//
// The shared-memory route, per block (dynamic shared memory):
//   L   packed lower triangle, row i starts at i*(i+1)/2: k(k+1)/2 floats
//       (131,584 bytes at k = 256; the full k*(k+1) tableau of the TPU
//       kernel would be 263,168 bytes, above the 227 KB a block may use);
//   col the scaled column of the current step: k floats;
//   z   the right-hand side, turned into L^-1 y during the factorisation.
// Right-looking Cholesky with the forward substitution folded in, two block
// barriers a column and one a back-substitution step.  Products and
// differences use __fmul_rn/__fsub_rn so that nvcc does not contract them
// into fused multiply-adds: the arithmetic is then the same, operation for
// operation, as spd_solve_plain in ops/spd_solve.py, and the result equal to
// the bit.  The register route agrees with it to rounding.

#include "spd_register.cuh"

namespace {

// ---------------------------------------------------------------------------
// the shared-memory route: one block a system, any k <= 256
// ---------------------------------------------------------------------------

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__global__ void spd_solve_shared_kernel(const float* __restrict__ A, const float* __restrict__ y,
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

// ---------------------------------------------------------------------------
// the register route: spd_register.cuh, with the fold-in solve's mappings
// ---------------------------------------------------------------------------

using lkt_reg::Cfg;

template <class C, int MIN_BLOCKS>
__global__ void __launch_bounds__(C::T* C::SPB, MIN_BLOCKS)
spd_solve_reg_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, long long n, int k,
                     int vec) {
  lkt_reg::solve_system<C>(A, y, x, n, k, vec);
}

// A compiled mapping: its thread grid, and the blocks an SM must hold (which
// caps the registers a thread).
template <class C, int MIN_BLOCKS>
struct Mapping {
  using cfg = C;
  static constexpr int min_blocks = MIN_BLOCKS;
};

// Calls f with the mapping compiled for width k and `threads` a system.
template <class F>
int with_mapping(int k, int threads, F f) {
  if (k <= 32) {
    if (threads == 32) return f(Mapping<Cfg<32, 8, 4, 4, true>, 8>{});
  } else if (k <= 64) {
    if (threads == 32) return f(Mapping<Cfg<64, 8, 4, 4, true>, 4>{});
    if (threads == 64) return f(Mapping<Cfg<64, 16, 4, 2, true>, 4>{});
    if (threads == 128) return f(Mapping<Cfg<64, 16, 8, 1, true>, 8>{});
  } else if (k <= 96) {
    if (threads == 64) return f(Mapping<Cfg<96, 8, 8, 1, true>, 1>{});
  } else if (k <= 128) {
    if (threads == 128) return f(Mapping<Cfg<128, 16, 8, 1, true>, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The register route, 1 <= k <= 128, over `threads` threads a system.
extern "C" int lkt_spd_solve_reg_f32(const float* A, const float* y, float* x, long long B, int k, int threads,
                                     void* stream) {
  if (B <= 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_mapping(k, threads, [&](auto m) {
    using M = decltype(m);
    return lkt_reg::launch<typename M::cfg>(spd_solve_reg_kernel<typename M::cfg, M::min_blocks>, A, y, x, B, k,
                                            static_cast<cudaStream_t>(stream));
  });
}

// Registers a thread, static shared memory a block, threads a block and local
// (spill) bytes a thread of the register route's instance for width k and
// `threads` a system, as compiled.
extern "C" int lkt_spd_solve_reg_info(int k, int threads, int* regs, int* smem_bytes, int* block_threads,
                                      int* local_bytes) {
  return with_mapping(k, threads, [&](auto m) {
    using M = decltype(m);
    return lkt_reg::info<typename M::cfg>(spd_solve_reg_kernel<typename M::cfg, M::min_blocks>, regs, smem_bytes,
                                          block_threads, local_bytes);
  });
}

// The shared-memory route, 1 <= k <= 256.
extern "C" int lkt_spd_solve_shared_f32(const float* A, const float* y, float* x, int B, int k, void* stream) {
  if (B <= 0 || k < 1 || k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = k <= 64 ? 128 : 256;
  const size_t smem = static_cast<size_t>(k * (k + 1) / 2 + 2 * k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(spd_solve_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spd_solve_shared_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, y, x, k);
  return static_cast<int>(cudaGetLastError());
}
