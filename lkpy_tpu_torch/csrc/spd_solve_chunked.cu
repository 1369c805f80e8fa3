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
// The register route.  T = PR x PC threads own a system (one warp as 8 x 4
// up to K = 64; 8 x 8 threads at K = 96 and 16 x 8 at K = 128, one system a
// block there).  The kernel is a template over the padded width K in
// {32, 64, 96, 128}; a k between two widths is padded inside the kernel
// (rows and columns k..K-1 load as zero and their elimination steps are
// skipped: the same as a bordering identity block, without touching device
// memory).  Thread (pr, pc) holds rows i = a*PR + pr and columns
// c = g*4*PC + 4*pc + r (r = 0..3: four neighbouring columns, so A loads as
// 16 bytes a thread, 64 contiguous bytes a row over the four pc of a warp,
// whole 32-byte sectors; an even k that is no multiple of 4, the explicit
// path's 50, loads as two 8-byte halves, an odd k float by float).  Every
// elimination step is its own template
// instance, so each register index is a compile-time constant, and only the
// slots that can hold a lower-triangle entry exist: 72 registers a thread at
// K = 64.
//
// A step j eliminates column j as in an LDL^T factorisation (no square
// root): the threads that hold column j write it, the pivot and z_j to a
// K + 4 float buffer in shared memory; after one barrier every thread reads
// the pivot, the entries of its own 8 rows (one load each, a broadcast among
// the threads of a row) and of its own columns (16 bytes a load), scales the
// row entries by -1/pivot and updates its trailing slots with one fmaf each:
// 12 shared loads feed up to 72 fused multiply-adds, where the shared-memory
// route needs four shared accesses per multiply-subtract.  Rows and columns
// <= j read as zero from the buffer, so finished entries are left alone
// without a predicate.  The buffer is doubled, so a step needs one barrier.
// The forward substitution rides along (z lives in registers beside the
// rows); the back substitution walks w in shared memory, the threads that
// hold row j taking x_j out of the entries before it.
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>
#include <utility>

namespace {

// ---------------------------------------------------------------------------
// the register route
// ---------------------------------------------------------------------------

template <int K_, int PR_, int PC_>
struct Cfg {
  static constexpr int K = K_;
  static constexpr int PR = PR_;                  // threads along the rows
  static constexpr int PC = PC_;                  // threads along the columns
  static constexpr int T = PR * PC;               // threads a system
  static constexpr int NA = K / PR;               // row slots a thread
  static constexpr int CP = 4 * PC;               // the columns' period
  static constexpr int NG = K / CP;               // groups of four columns a thread
  static constexpr int NB = 4 * NG;               // column slots a thread
  static constexpr int SPB = T == 32 ? 4 : 1;     // systems a block
  static constexpr int BUF = K + 4;               // a column, then the pivot and z_j
  static constexpr int SYS_FLOATS = 2 * BUF + 2 * K;  // two buffers, 1/pivot, w
  static constexpr int XR = (K + T - 1) / T;      // entries of x a thread carries out
  static_assert(K % PR == 0 && K % CP == 0 && T % 32 == 0, "the widths divide over the threads");

  __host__ __device__ static constexpr int max_row(int a) { return a * PR + PR - 1; }
  __host__ __device__ static constexpr int min_col(int b) { return (b / 4) * CP + b % 4; }
  __host__ __device__ static constexpr int max_col(int b) { return (b / 4) * CP + CP - 4 + b % 4; }
  // a slot exists if some thread's entry there lies in the lower triangle
  __host__ __device__ static constexpr bool stored(int a, int b) { return max_row(a) >= min_col(b); }
};

template <class C>
struct Sys {
  float v[C::NA][C::NB];  // the thread's entries of A, then of the factor
  float z[C::NA];         // the right-hand side at the thread's rows
};

template <class C>
__device__ __forceinline__ void sys_sync() {
  if constexpr (C::T == 32) {
    __syncwarp();
  } else {
    __syncthreads();  // one system a block
  }
}

template <class C>
__device__ __forceinline__ void load_system(Sys<C>& s, const float* __restrict__ Ab, const float* __restrict__ yb, int k,
                                            int vec, int pr, int pc) {
#pragma unroll
  for (int a = 0; a < C::NA; ++a) {
    const int i = a * C::PR + pr;
    s.z[a] = i < k ? __ldg(yb + i) : 0.f;
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      if (C::stored(a, 4 * g)) {
        const int c0 = g * C::CP + 4 * pc;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < k && c0 <= i) {
          const float* p = Ab + static_cast<size_t>(i) * k + c0;
          if (vec == 4) {  // k % 4 == 0 and A aligned to 16 bytes, so c0 + 3 < k
            val = __ldcs(reinterpret_cast<const float4*>(p));
          } else if (vec == 2) {  // k even and A aligned to 8 bytes, so c0 + 1 < k, and c0 + 3 < k where c0 + 2 <= i
            const float2 lo = __ldcs(reinterpret_cast<const float2*>(p));
            val.x = lo.x;
            val.y = lo.y;
            if (c0 + 2 <= i) {
              const float2 hi = __ldcs(reinterpret_cast<const float2*>(p + 2));
              val.z = hi.x;
              val.w = hi.y;
            }
          } else {
            val.x = __ldg(p);
            if (c0 + 1 <= i) val.y = __ldg(p + 1);
            if (c0 + 2 <= i) val.z = __ldg(p + 2);
            if (c0 + 3 <= i) val.w = __ldg(p + 3);
          }
        }
        // the upper triangle is not part of the contract: zero, whatever A holds there
        if (C::stored(a, 4 * g + 0)) s.v[a][4 * g + 0] = c0 + 0 <= i ? val.x : 0.f;
        if (C::stored(a, 4 * g + 1)) s.v[a][4 * g + 1] = c0 + 1 <= i ? val.y : 0.f;
        if (C::stored(a, 4 * g + 2)) s.v[a][4 * g + 2] = c0 + 2 <= i ? val.z : 0.f;
        if (C::stored(a, 4 * g + 3)) s.v[a][4 * g + 3] = c0 + 3 <= i ? val.w : 0.f;
      }
    }
  }
}

// Elimination step J: column J, its pivot and z_J go through shared memory,
// every thread updates its trailing slots and its z.
template <class C, int J>
__device__ __forceinline__ void factor_step(Sys<C>& s, float* buf2, float* dinv, int pr, int pc, int t) {
  constexpr int PCJ = (J / 4) % C::PC;
  constexpr int BJ = (J / C::CP) * 4 + J % 4;
  constexpr int AJ = J / C::PR;
  constexpr int PRJ = J % C::PR;
  float* buf = buf2 + (J & 1) * C::BUF;
  if (pc == PCJ) {
#pragma unroll
    for (int a = 0; a < C::NA; ++a) {
      // rows J-1 and J must read as zero from this buffer, whose last use was step J-2
      if (C::max_row(a) >= J - 1) {
        const int i = a * C::PR + pr;
        float val = 0.f;
        if (C::max_row(a) > J) val = i > J ? s.v[a][BJ] : 0.f;
        buf[i] = val;
      }
    }
    if (pr == PRJ) {
      buf[C::K] = s.v[AJ][BJ];
      buf[C::K + 1] = s.z[AJ];
    }
  }
  sys_sync<C>();
  const float2 pz = *reinterpret_cast<const float2*>(buf + C::K);
  const float invp = pz.x > 0.f ? __frcp_rn(pz.x) : __int_as_float(0x7fc00000);
  if (t == 0) dinv[J] = invp;
  float cc[C::NB];
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
    if (g * C::CP + C::CP - 1 > J) {
      const float4 c4 = *reinterpret_cast<const float4*>(buf + g * C::CP + 4 * pc);
      cc[4 * g + 0] = c4.x;
      cc[4 * g + 1] = c4.y;
      cc[4 * g + 2] = c4.z;
      cc[4 * g + 3] = c4.w;
    }
  }
#pragma unroll
  for (int a = 0; a < C::NA; ++a) {
    if (C::max_row(a) > J) {
      const float sa = -buf[a * C::PR + pr] * invp;
      s.z[a] = fmaf(sa, pz.y, s.z[a]);
#pragma unroll
      for (int b = 0; b < C::NB; ++b) {
        if (C::stored(a, b) && C::max_col(b) > J) s.v[a][b] = fmaf(sa, cc[b], s.v[a][b]);
      }
    }
  }
}

// Back-substitution step J: x_J from w_J, then the threads of row J take
// x_J out of the entries before it.
template <class C, int J>
__device__ __forceinline__ void back_step(const Sys<C>& s, float* w, const float* dinv, float (&xr)[C::XR], int pr, int pc,
                                          int t) {
  constexpr int AJ = J / C::PR;
  constexpr int PRJ = J % C::PR;
  const float xj = w[J] * dinv[J];
  if (t == J % C::T) xr[J / C::T] = xj;
  if (J > 0) {
    if (pr == PRJ) {
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        if (g * C::CP < J) {
          float4* wp = reinterpret_cast<float4*>(w + g * C::CP + 4 * pc);
          float4 wv = *wp;
          const int c0 = g * C::CP + 4 * pc;
          if (C::stored(AJ, 4 * g + 0)) wv.x = fmaf(c0 + 0 < J ? -s.v[AJ][4 * g + 0] : 0.f, xj, wv.x);
          if (C::stored(AJ, 4 * g + 1)) wv.y = fmaf(c0 + 1 < J ? -s.v[AJ][4 * g + 1] : 0.f, xj, wv.y);
          if (C::stored(AJ, 4 * g + 2)) wv.z = fmaf(c0 + 2 < J ? -s.v[AJ][4 * g + 2] : 0.f, xj, wv.z);
          if (C::stored(AJ, 4 * g + 3)) wv.w = fmaf(c0 + 3 < J ? -s.v[AJ][4 * g + 3] : 0.f, xj, wv.w);
          *wp = wv;
        }
      }
    }
    sys_sync<C>();
  }
}

template <class C, int... Js>
__device__ __forceinline__ void factor_all(Sys<C>& s, float* buf2, float* dinv, int k, int pr, int pc, int t,
                                           std::integer_sequence<int, Js...>) {
  // the steps of the padding (J >= k) are skipped: k is the same for every thread
  ((Js < k ? factor_step<C, Js>(s, buf2, dinv, pr, pc, t) : void()), ...);
}

template <class C, int... Js>
__device__ __forceinline__ void back_all(const Sys<C>& s, float* w, const float* dinv, float (&xr)[C::XR], int k, int pr,
                                         int pc, int t, std::integer_sequence<int, Js...>) {
  ((C::K - 1 - Js < k ? back_step<C, C::K - 1 - Js>(s, w, dinv, xr, pr, pc, t) : void()), ...);
}

template <class C, int MIN_BLOCKS>
__global__ void __launch_bounds__(C::T* C::SPB, MIN_BLOCKS)
spd_solve_chunked_reg_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, long long n,
                             int k, int vec) {
  __shared__ __align__(16) float smem[C::SPB * C::SYS_FLOATS];
  const int sys = threadIdx.x / C::T;
  const int t = threadIdx.x % C::T;
  const long long b = static_cast<long long>(blockIdx.x) * C::SPB + sys;
  // warps of one block share no barrier when each has its own system
  if (b >= n) return;
  const int pr = t / C::PC;
  const int pc = t % C::PC;
  float* buf2 = smem + sys * C::SYS_FLOATS;
  float* dinv = buf2 + 2 * C::BUF;
  float* w = dinv + C::K;

  Sys<C> s;
  load_system<C>(s, A + b * k * k, y + b * k, k, vec, pr, pc);
  factor_all<C>(s, buf2, dinv, k, pr, pc, t, std::make_integer_sequence<int, C::K>{});

  if (pc == 0) {
#pragma unroll
    for (int a = 0; a < C::NA; ++a) w[a * C::PR + pr] = s.z[a];
  }
  sys_sync<C>();
  float xr[C::XR];
  back_all<C>(s, w, dinv, xr, k, pr, pc, t, std::make_integer_sequence<int, C::K>{});
#pragma unroll
  for (int q = 0; q < C::XR; ++q) {
    const int i = q * C::T + t;
    if (i < k) x[b * k + i] = xr[q];
  }
}

template <class C, int MIN_BLOCKS>
int launch_reg(const float* A, const float* y, float* x, long long n, int k, cudaStream_t stream) {
  const long long blocks = (n + C::SPB - 1) / C::SPB;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // floats a load of A takes: a row starts at a multiple of k floats
  const uintptr_t at = reinterpret_cast<uintptr_t>(A);
  const int vec = (k % 4 == 0 && at % 16 == 0) ? 4 : (k % 2 == 0 && at % 8 == 0) ? 2 : 1;
  spd_solve_chunked_reg_kernel<C, MIN_BLOCKS>
      <<<static_cast<unsigned>(blocks), C::T * C::SPB, 0, stream>>>(A, y, x, n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

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
  cudaFuncAttributes a;
  cudaError_t e;
  if (k <= 32) {
    e = cudaFuncGetAttributes(&a, spd_solve_chunked_reg_kernel<Cfg32, 8>);
    *threads = Cfg32::T * Cfg32::SPB;
  } else if (k <= 64) {
    e = cudaFuncGetAttributes(&a, spd_solve_chunked_reg_kernel<Cfg64, 4>);
    *threads = Cfg64::T * Cfg64::SPB;
  } else if (k <= 96) {
    e = cudaFuncGetAttributes(&a, spd_solve_chunked_reg_kernel<Cfg96, 1>);
    *threads = Cfg96::T * Cfg96::SPB;
  } else {
    e = cudaFuncGetAttributes(&a, spd_solve_chunked_reg_kernel<Cfg128, 1>);
    *threads = Cfg128::T * Cfg128::SPB;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
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
