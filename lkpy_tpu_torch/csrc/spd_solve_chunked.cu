// Batched small SPD solve for ALS training, x[b] = A[b]^-1 y[b], for Hopper
// (sm_90a).  Two routes, chosen from k alone by the Python wrapper
// (ops/spd_solve_chunked.py::solve_route):
//   k <= 128: the system held in registers (lkt_spd_solve_chunked_reg_f32);
//   129 <= k <= 256: the blocked Cholesky of spd_blocked.cuh, one block of
//             256 threads a system up to k = 192 (two blocks an SM) and 512
//             threads above (lkt_spd_solve_chunked_blocked_f32; it takes any
//             k <= 256).
//
// Replaces the TPU kernel lkpy_tpu/ops/pallas_gj.py::_gj_block_kernel
// (entry point spd_solve_lanes_chunked, rank-8 blocked Gauss-Jordan on the
// bordered tableau, batch on the lanes): the training solve of every chunk
// of every half-epoch (ops/als.py::_solve_chunk <- _run_half <- als_epoch <-
// models/als.py::ALSTrainerBase.train_epoch), in both ALS modes.
//
// Contract: A is (N, k, k) f32 row-major and symmetric positive definite
// (only its lower triangle is read), y is (N, k) f32, x is (N, k) f32, and
// 1 <= k <= 256.  The TPU kernel's (C, k, k, B) batch-last layout was a lane
// constraint of the TPU; here the C chunks of B systems come flattened,
// batch first.  No pivoting, as for LAPACK sposv: a zero or negative pivot
// gives NaN in that system's x only (explicit ALS's padded dummy rows have
// A = 0); systems share no state, so their neighbours are not disturbed.
//
// Bound at the training path's largest chunk (N = 30,024 systems, k = 64):
//   bytes: A's lower triangle, y and x once: N*(k(k+1)/2 + 2k)*4 =
//   265 MB -> 79 us at 3.35 TB/s;
//   f32 work: about k^3/3 + 2k^2 = 95.6k flops per system, 2.87 Gflop ->
//   43 us at 67 TFLOP/s.
// So the solve is bound by reading the lower triangle once.
//
// Bound at the widest chunk the tuner's k = 256 epochs give (N = 29,936):
//   bytes: 29,936 * (32,896 + 512) * 4 = 4.00 GB -> 1.19 ms;
//   f32 work: k^3/3 + 2k^2 = 5.72 Mflop a system, 171 Gflop -> 2.56 ms.
// Here the operations bound it.  The blocked route (spd_blocked.cuh) puts a
// system in a block, loads the lower triangle into 32 x 32 tiles with
// cp.async and runs the k^3/6 multiply-adds of the trailing updates as
// rank-32 tile updates from registers (two 16-byte shared loads feed 16
// fmaf), the k pivots on one warp in registers.
//
// The register route (spd_register.cuh, which the fold-in solve shares).
// T = PR x PC threads hold a system's lower triangle in registers through an
// LDL^T elimination with the forward substitution riding along, the pivot
// column passing through a small doubled buffer in shared memory (one
// barrier a step), then the back substitution over w in shared memory: 12
// shared loads feed up to 72 fused multiply-adds at K = 64.
// The mappings here: one warp as 8 x 4 up to K = 64, four systems a block;
// 8 x 8 threads at K = 96 and 16 x 8 at K = 128, one system a block.  The
// padded width K is one of {32, 64, 96, 128}; a k between two widths is
// padded inside the kernel.
//
// Occupancy: shared memory is 264 floats a system at K = 64 (4.1 KB a block
// of four warps), so registers set it.  The K = 64 instance is held to 128
// registers a thread (__launch_bounds__(128, 4)): 65,536 / (128 * 32) = 16
// warps, 16 systems, an SM.  The 72 slots, 8 z, 8 + 16 step operands and the
// addressing leave no room for a 24-warp (80-register) build.
//
// Arithmetic: the register route multiplies by a correctly rounded reciprocal
// of the pivot and the blocked route by a reciprocal square root, both
// contracting into fmaf, so they agree with spd_solve_chunked_plain
// (ops/spd_solve_chunked.py) to rounding, not to the bit.  A pivot that is
// not positive makes either route's reciprocal NaN.

#include "spd_blocked.cuh"
#include "spd_register.cuh"

namespace {

// ---------------------------------------------------------------------------
// the register route: spd_register.cuh, with the training solve's mappings
// ---------------------------------------------------------------------------

using lkt_reg::Cfg;

template <class C, int MIN_BLOCKS>
__global__ void __launch_bounds__(C::T* C::SPB, MIN_BLOCKS)
spd_solve_chunked_reg_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, long long n,
                             int k, int vec) {
  lkt_reg::solve_system<C>(A, y, x, n, k, vec);
}

template <class C, int MIN_BLOCKS>
int launch_reg(const float* A, const float* y, float* x, long long n, int k, cudaStream_t stream) {
  return lkt_reg::launch<C>(spd_solve_chunked_reg_kernel<C, MIN_BLOCKS>, A, y, x, n, k, stream);
}

// one warp a system and four systems a block up to K = 64; one system a block above
using Cfg32 = Cfg<32, 8, 4>;
using Cfg64 = Cfg<64, 8, 4>;
using Cfg96 = Cfg<96, 8, 8>;
using Cfg128 = Cfg<128, 16, 8>;
constexpr int kMaxRegK = 128;

// ---------------------------------------------------------------------------
// the blocked route: spd_blocked.cuh, one system a block
// ---------------------------------------------------------------------------

template <int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
spd_solve_chunked_blocked_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, int k,
                                 int vec4) {
  lkt_blk::solve_system<NT>(A, y, x, k, vec4 != 0);
}

}  // namespace

// The register route, 1 <= k <= 128.
extern "C" int lkt_spd_solve_chunked_reg_f32(const float* A, const float* y, float* x, long long n, int k, void* stream) {
  if (n <= 0 || k < 1 || k > kMaxRegK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch_reg<Cfg32, 8>(A, y, x, n, k, st);
  if (k <= 64) return launch_reg<Cfg64, 4>(A, y, x, n, k, st);
  if (k <= 96) return launch_reg<Cfg96, 1>(A, y, x, n, k, st);
  return launch_reg<Cfg128, 1>(A, y, x, n, k, st);
}

// Registers a thread, static shared memory a block, threads a block and local
// (spill) bytes a thread of the register route's instance for width k, as
// compiled.
extern "C" int lkt_spd_solve_chunked_reg_info(int k, int* regs, int* smem_bytes, int* threads, int* local_bytes) {
  if (k <= 32) return lkt_reg::info<Cfg32>(spd_solve_chunked_reg_kernel<Cfg32, 8>, regs, smem_bytes, threads, local_bytes);
  if (k <= 64) return lkt_reg::info<Cfg64>(spd_solve_chunked_reg_kernel<Cfg64, 4>, regs, smem_bytes, threads, local_bytes);
  if (k <= 96) return lkt_reg::info<Cfg96>(spd_solve_chunked_reg_kernel<Cfg96, 1>, regs, smem_bytes, threads, local_bytes);
  return lkt_reg::info<Cfg128>(spd_solve_chunked_reg_kernel<Cfg128, 1>, regs, smem_bytes, threads, local_bytes);
}

// The blocked route, 1 <= k <= 256: 256 threads a system (two blocks an SM)
// up to k = 192, 512 above, where one block fills an SM's shared memory.
extern "C" int lkt_spd_solve_chunked_blocked_f32(const float* A, const float* y, float* x, long long n, int k,
                                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 192) return lkt_blk::launch<512>(spd_solve_chunked_blocked_kernel<512, 1>, A, y, x, n, k, st);
  return lkt_blk::launch<256>(spd_solve_chunked_blocked_kernel<256, 2>, A, y, x, n, k, st);
}
