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
// gives non-finite values (a NaN reciprocal) in that system's x only.
//
// Two routes, chosen from (B, k) alone by the Python wrapper
// (ops/spd_solve.py::fold_route):
//   k <= 128: the system held in registers (lkt_spd_solve_reg_f32), over 32,
//             64 or 128 threads a system;
//   129 <= k <= 256: the blocked Cholesky of spd_blocked.cuh, one block of
//             256 or 512 threads a system (lkt_spd_solve_blocked_f32; it
//             takes any k <= 256).
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
// Above k = 128 (bound at (1024, 256): 136.8 MB -> 0.0408 ms; 5.86 Gflop ->
// 0.0875 ms, so the operations bound it, and one system alone is 11.3 us of
// one SM's f32 rate) the blocked route (spd_blocked.cuh, shared with the
// training solve) runs a system's k^3/6 multiply-adds as rank-32 updates of
// 32 x 32 tiles from registers and keeps its k pivots on one warp.  A serving
// block is 8 waves of one system an SM at k = 256, and a single query one
// system on one SM, so the time is a system's: 512 threads a system share the
// tile updates more widely than 256, which leave room for two blocks an SM up
// to k = 192.
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
// Both routes use fused multiply-adds and a reciprocal (square root) of the
// pivot, so they agree with spd_solve_plain (ops/spd_solve.py) to rounding,
// not to the bit.

#include "spd_blocked.cuh"
#include "spd_register.cuh"

namespace {

// ---------------------------------------------------------------------------
// the blocked route: spd_blocked.cuh, one system a block of 256 or 512 threads
// ---------------------------------------------------------------------------

template <int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
spd_solve_blocked_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, int k,
                         int vec4) {
  lkt_blk::solve_system<NT>(A, y, x, k, vec4 != 0);
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

// The blocked route, 1 <= k <= 256, over `threads` (256 or 512) threads a system.
extern "C" int lkt_spd_solve_blocked_f32(const float* A, const float* y, float* x, long long B, int k, int threads,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == 256) return lkt_blk::launch<256>(spd_solve_blocked_kernel<256, 2>, A, y, x, B, k, st);
  if (threads == 512) return lkt_blk::launch<512>(spd_solve_blocked_kernel<512, 1>, A, y, x, B, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the blocked route's
// instance over `threads` threads a system, as compiled.
extern "C" int lkt_spd_solve_blocked_info(int threads, int* regs, int* local_bytes) {
  if (threads == 256) return lkt_blk::info(spd_solve_blocked_kernel<256, 2>, regs, local_bytes);
  if (threads == 512) return lkt_blk::info(spd_solve_blocked_kernel<512, 1>, regs, local_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
