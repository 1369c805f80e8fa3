// Batched small SPD solve for ALS training, x[b] = A[b]^-1 y[b], for Hopper
// (sm_90a): one warp per system, several systems per thread block.
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
// batch first, and k is taken as it is (no padding to a multiple of 8).  No
// pivoting, as for LAPACK sposv: a zero or negative pivot gives NaN or inf in
// that system's x only (explicit ALS's padded dummy rows have A = 0).
//
// Bound at the training path's largest chunk (N = 30,024 systems, k = 64):
//   bytes: A's lower triangle, y and x once: N*(k(k+1)/2 + 2k)*4 =
//   265 MB -> 79 us at 3.35 TB/s;
//   f32 work: about k^3/3 + 2k^2 = 95.6k flops per system, 2.87 Gflop ->
//   43 us at 67 TFLOP/s.
// So the solve is bound by reading the lower triangle once.  This first
// form reads it once with coalesced row loads and keeps each system in
// shared memory for the whole factorisation; its time is set by the k
// dependent steps each warp walks through shared memory, not by device
// memory.  Holding a system in registers, or splitting one system over
// fewer lanes, is the way to the bound and is later work.
//
// Design, against B2's kernel (csrc/spd_solve.cu, one block per system, two
// __syncthreads per step): training hands over tens of thousands of systems
// a launch, so here a warp owns a system and its steps are separated by
// __syncwarp only.  A block holds as many systems as the shared-memory
// budget allows, at most 8 (8 warps): 8 at k = 64 (68.6 KB, above the 48 KB
// default, so the launcher raises the block's limit), 6 at k = 128, 1 at
// k = 256 (132.6 KB).
//
// Layout per warp (dynamic shared memory):
//   L  packed lower triangle, row i starts at i*(i+1)/2: k(k+1)/2 floats;
//   z  the right-hand side, turned into L^-1 y during the factorisation and
//      into x during the back substitution: k floats.
//
// Arithmetic: right-looking Cholesky with the forward substitution folded
// into each step, then the back substitution with L^T, in the operation
// order of spd_solve_chunked_plain (ops/spd_solve_chunked.py).  Products and
// differences use __fmul_rn/__fsub_rn and quotients __fdiv_rn, so nvcc does
// not contract them into fused multiply-adds: kernel and plain version round
// alike, operation for operation.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 256;
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

extern "C" int lkt_spd_solve_chunked_f32(const float* A, const float* y, float* x, long long n, int k,
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
