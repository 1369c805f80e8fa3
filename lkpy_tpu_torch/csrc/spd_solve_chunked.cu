// Batched small SPD solve for ALS training, x[b] = A[b]^-1 y[b], for Hopper
// (sm_90a).  Two routes, chosen from k alone by the Python wrapper
// (ops/spd_solve_chunked.py::solve_route):
//   k <= 128: the system held in registers (lkt_spd_solve_chunked_reg_f32);
//   k <= 256: the system held in shared memory, one warp per system
//             (lkt_spd_solve_chunked_shared_f32), the general route.
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
// So the solve is bound by reading the lower triangle once.  What kept the
// shared-memory route far from that is not device memory but the k
// dependent steps a warp walks through shared memory: every entry of the
// trailing update costs three shared loads, a store and a walk of the packed
// triangle's index for one multiply and subtract.
//
// The register route (spd_register.cuh, which the fold-in solve shares).
// T = PR x PC threads hold a system's lower triangle in registers through an
// LDL^T elimination with the forward substitution riding along, the pivot
// column passing through a small doubled buffer in shared memory (one
// barrier a step), then the back substitution over w in shared memory: 12
// shared loads feed up to 72 fused multiply-adds at K = 64, where the
// shared-memory route needs four shared accesses per multiply-subtract.
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
// of the pivot and contracts into fmaf, so it agrees with
// spd_solve_chunked_plain (ops/spd_solve_chunked.py) to rounding, not to the
// bit.  The shared-memory route keeps the plain version's operation order
// with __fmul_rn/__fsub_rn/__fdiv_rn and rounds like it, operation for
// operation.  A pivot that is not positive makes the register route's
// reciprocal NaN, which is what sqrtf of it gives on the other route.

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

// ---------------------------------------------------------------------------
// the shared-memory route: one warp per system, any k <= 256
// ---------------------------------------------------------------------------
//
// A block holds as many systems as the shared-memory budget allows, at most
// 8 (8 warps): 8 at k = 64 (68.6 KB, above the 48 KB default, so the launcher
// raises the block's limit), 6 at k = 128, 1 at k = 256 (132.6 KB).
//
// Layout per warp (dynamic shared memory):
//   L  packed lower triangle, row i starts at i*(i+1)/2: k(k+1)/2 floats;
//   z  the right-hand side, turned into L^-1 y during the factorisation and
//      into x during the back substitution: k floats.
//
// Arithmetic: right-looking Cholesky with the forward substitution folded
// into each step, then the back substitution with L^T, in the operation
// order of spd_solve_chunked_plain.  Products and differences use
// __fmul_rn/__fsub_rn and quotients __fdiv_rn, so nvcc does not contract
// them into fused multiply-adds.

constexpr int kMaxK = 256;
constexpr int kMaxRegK = 128;
constexpr int kMaxSystemsPerBlock = 8;
// shared memory a Hopper block may use after opting in (227 KB)
constexpr size_t kSmemPerBlock = 232448;

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__host__ __device__ __forceinline__ int system_floats(int k) { return tri(k) + k; }

__global__ void spd_solve_chunked_kernel(const float* __restrict__ A, const float* __restrict__ y,
                                         float* __restrict__ x, long long n, int k) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  // the block has no block-wide barrier, so a warp without a system leaves
  if (b >= n) return;

  float* L = smem + static_cast<size_t>(warp) * system_floats(k);
  float* z = L + tri(k);

  // lower triangle, row by row, lanes along the row (coalesced)
  const float* Ab = A + b * k * k;
  for (int i = 0; i < k; ++i) {
    const float* Ai = Ab + static_cast<size_t>(i) * k;
    float* Li = L + tri(i);
    for (int c = lane; c <= i; c += 32) Li[c] = Ai[c];
  }
  for (int i = lane; i < k; i += 32) z[i] = y[b * k + i];
  __syncwarp();

  // right-looking Cholesky, forward substitution folded into each step
  for (int j = 0; j < k; ++j) {
    const float d = sqrtf(L[tri(j) + j]);
    const float zj = __fdiv_rn(z[j], d);
    for (int i = j + 1 + lane; i < k; i += 32) L[tri(i) + j] = __fdiv_rn(L[tri(i) + j], d);
    __syncwarp();
    if (lane == 0) {
      L[tri(j) + j] = d;
      z[j] = zj;
    }
    for (int i = j + 1 + lane; i < k; i += 32) z[i] = __fsub_rn(z[i], __fmul_rn(L[tri(i) + j], zj));
    // trailing update of the lower triangle, rows and columns j+1..k-1,
    // flattened over the warp: lane t takes entries t, t+32, ... of the
    // packed trailing triangle, whose entry (r, c) is L[j+1+r][j+1+c]
    const int total = tri(k - j - 1);
    int r = 0;
    int c = lane;
    while (c > r) c -= ++r;
    for (int t = lane; t < total; t += 32) {
      const int i = j + 1 + r;
      const int cc = j + 1 + c;
      float* p = L + tri(i) + cc;
      *p = __fsub_rn(*p, __fmul_rn(L[tri(i) + j], L[tri(cc) + j]));
      c += 32;
      while (c > r) c -= ++r;
    }
    __syncwarp();
  }

  // back substitution with L^T; x[j] replaces z[j] once nothing reads it
  for (int j = k - 1; j >= 0; --j) {
    const float* Lj = L + tri(j);
    const float xj = __fdiv_rn(z[j], Lj[j]);
    for (int i = lane; i < j; i += 32) z[i] = __fsub_rn(z[i], __fmul_rn(Lj[i], xj));
    __syncwarp();
    if (lane == 0) z[j] = xj;
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) x[b * k + i] = z[i];
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

// The shared-memory route, 1 <= k <= 256.
extern "C" int lkt_spd_solve_chunked_shared_f32(const float* A, const float* y, float* x, long long n, int k,
                                                void* stream) {
  if (n <= 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_system = static_cast<size_t>(system_floats(k)) * sizeof(float);
  long long systems = static_cast<long long>(kSmemPerBlock / per_system);
  if (systems > kMaxSystemsPerBlock) systems = kMaxSystemsPerBlock;
  if (systems > n) systems = n;
  const long long blocks = (n + systems - 1) / systems;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(systems) * per_system;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(spd_solve_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spd_solve_chunked_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * systems), smem,
                             static_cast<cudaStream_t>(stream)>>>(A, y, x, n, k);
  return static_cast<int>(cudaGetLastError());
}
