// The register route of the batched small SPD solve, x[b] = A[b]^-1 y[b],
// shared by the training solve (spd_solve_chunked.cu) and the fold-in solve
// (spd_solve.cu).  Each of the two sources wraps solve_system<C> in a
// __global__ kernel of its own name and picks the thread mappings (Cfg) it
// compiles; the arithmetic, the loads and the layout are the same.
//
// T = PR x PC threads own a system.  The code is a template over the padded
// width K; a k between two widths is padded inside the kernel (rows and
// columns k..K-1 load as zero and their elimination steps are skipped: the
// same as a bordering identity block, without touching device memory).
// Thread (pr, pc) holds rows i = a*PR + pr and columns
// c = g*4*PC + 4*pc + r (r = 0..3: four neighbouring columns, so A loads as
// 16 bytes a thread, whole 32-byte sectors; an even k that is no multiple of
// 4 loads as two 8-byte halves, an odd k float by float).  Every elimination
// step is its own template instance, so each register index is a
// compile-time constant, and only the slots that can hold a lower-triangle
// entry exist.
//
// A step j eliminates column j as in an LDL^T factorisation (no square
// root): the threads that hold column j write it, the pivot and z_j to a
// K + 4 float buffer in shared memory; after one barrier every thread reads
// the pivot, the entries of its own rows (one load each, a broadcast among
// the threads of a row) and of its own columns (16 bytes a load), scales the
// row entries by -1/pivot and updates its trailing slots with one fmaf each.
// Rows and columns <= j read as zero from the buffer, so finished entries
// are left alone without a predicate.  The buffer is doubled, so a step
// needs one barrier.  The forward substitution rides along (z lives in
// registers beside the rows); the back substitution walks w in shared
// memory, the threads that hold row j taking x_j out of the entries before
// it.
//
// The look-ahead step (Cfg's AHEAD, the fold-in solve's).  A small batch
// is less than one wave of the card, so its time is one system's chain of
// dependent steps, and the step above puts everything on that chain: the
// store of the column, the barrier, the loads, a reciprocal in every thread
// and all the fused multiply-adds before the next column can be stored.
// With AHEAD a step first updates the one slot that holds column j+1 and
// publishes that column for the next step at once, the pivot's thread
// computing the reciprocal (the hardware's approximation and one Newton
// step) and storing it in the pivot's place; the rest of the trailing update
// and the step's barrier follow in the shadow of that store.  The chain from
// step to step is then a load, a multiply, one fmaf, the reciprocal and a
// store.
//
// The barrier is the system's own: __syncwarp() where a warp holds the
// system, __syncthreads() where the block holds one system, and a named
// barrier (bar.sync with the system's id and T threads) where a block holds
// several systems of more than one warp each.  A system past the end of the
// batch leaves as a whole, so no barrier waits for it.
//
// Arithmetic: a reciprocal of the pivot (correctly rounded, or with AHEAD
// within an ulp of that) and fmaf, so the route agrees with the plain
// version (ops/spd_solve.py::spd_solve_plain) to rounding, not to the bit.
// A pivot that is not positive makes the reciprocal NaN, which then fills
// that system's x and no other.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>
#include <utility>

namespace lkt_reg {

template <int K_, int PR_, int PC_, int SPB_ = (PR_ * PC_ == 32 ? 4 : 1), bool AHEAD_ = false>
struct Cfg {
  static constexpr int K = K_;
  static constexpr int PR = PR_;                  // threads along the rows
  static constexpr int PC = PC_;                  // threads along the columns
  static constexpr int T = PR * PC;               // threads a system
  static constexpr int NA = K / PR;               // row slots a thread
  static constexpr int CP = 4 * PC;               // the columns' period
  static constexpr int NG = K / CP;               // groups of four columns a thread
  static constexpr int NB = 4 * NG;               // column slots a thread
  static constexpr int SPB = SPB_;                // systems a block
  static constexpr bool AHEAD = AHEAD_;           // the elimination sends the next column ahead
  static constexpr int BUF = K + 4;               // a column, then the pivot (or its reciprocal) and z_j
  static constexpr int SYS_FLOATS = 2 * BUF + 2 * K;  // two buffers, 1/pivot, w
  static constexpr int XR = (K + T - 1) / T;      // entries of x a thread carries out
  static_assert(K % PR == 0 && K % CP == 0 && T % 32 == 0, "the widths divide over the threads");
  // named barriers 1..15 serve the systems of a block; 0 is __syncthreads()
  static_assert(SPB >= 1 && (T == 32 || SPB <= 15), "a system of several warps needs a barrier of its own");

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

// The barrier among the T threads of system `sys` of the block.
template <class C>
__device__ __forceinline__ void sys_sync(int sys) {
  if constexpr (C::T == 32) {
    __syncwarp();
  } else if constexpr (C::SPB == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" : : "r"(sys + 1), "r"(C::T) : "memory");
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
__device__ __forceinline__ void factor_step(Sys<C>& s, float* buf2, float* dinv, int sys, int pr, int pc, int t) {
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
  sys_sync<C>(sys);
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

// The reciprocal of a pivot on the look-ahead step's chain: the hardware's
// approximation and one Newton step, within an ulp of __frcp_rn's correctly
// rounded result, which took 0.11 us of every step at K = 64 on an H100;
// NaN for a pivot that is not positive.
__device__ __forceinline__ float pivot_reciprocal(float p) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
  r = fmaf(fmaf(-p, r, 1.f), r, r);
  return p > 0.f ? r : __int_as_float(0x7fc00000);
}

// Column J as it stands, the reciprocal of its pivot and z_J go to the
// buffer of step J; the pivot's thread also keeps the reciprocal in dinv.
template <class C, int J>
__device__ __forceinline__ void publish_column(const Sys<C>& s, float* buf2, float* dinv, int pr, int pc) {
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
      const float invp = pivot_reciprocal(s.v[AJ][BJ]);
      buf[C::K] = invp;
      buf[C::K + 1] = s.z[AJ];
      dinv[J] = invp;
    }
  }
}

// Elimination step J with the next column sent ahead: the buffer of step J
// holds column J, 1/pivot and z_J since the step before.  Every thread
// scales its rows, updates z and the slot that column J+1 lies in; the
// threads that hold column J+1 publish it at once, its pivot's thread the
// reciprocal with it; the rest of the trailing update follows, and the
// step's one barrier comes last.  So the chain from one step to the next is
// a load, a multiply, one fmaf, the reciprocal and a store, and the other
// fused multiply-adds run in its shadow.
template <class C, int J>
__device__ __forceinline__ void factor_step_ahead(Sys<C>& s, float* buf2, float* dinv, int sys, int pr, int pc) {
  constexpr int B1 = ((J + 1) / C::CP) * 4 + (J + 1) % 4;  // the slot of column J+1
  constexpr bool AHEAD = J + 1 < C::K;
  const float* buf = buf2 + (J & 1) * C::BUF;
  const float2 pz = *reinterpret_cast<const float2*>(buf + C::K);
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
  float sa[C::NA];
#pragma unroll
  for (int a = 0; a < C::NA; ++a) {
    if (C::max_row(a) > J) {
      sa[a] = -buf[a * C::PR + pr] * pz.x;
      s.z[a] = fmaf(sa[a], pz.y, s.z[a]);
      if (AHEAD && C::stored(a, B1)) s.v[a][B1] = fmaf(sa[a], cc[B1], s.v[a][B1]);
    }
  }
  if constexpr (AHEAD) publish_column<C, J + 1>(s, buf2, dinv, pr, pc);
#pragma unroll
  for (int a = 0; a < C::NA; ++a) {
    if (C::max_row(a) > J) {
#pragma unroll
      for (int b = 0; b < C::NB; ++b) {
        if (C::stored(a, b) && C::max_col(b) > J && !(AHEAD && b == B1)) s.v[a][b] = fmaf(sa[a], cc[b], s.v[a][b]);
      }
    }
  }
  sys_sync<C>(sys);
}

// Back-substitution step J: x_J from w_J, then the threads of row J take
// x_J out of the entries before it.
template <class C, int J>
__device__ __forceinline__ void back_step(const Sys<C>& s, float* w, const float* dinv, float (&xr)[C::XR], int sys, int pr,
                                          int pc, int t) {
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
    sys_sync<C>(sys);
  }
}

template <class C, int... Js>
__device__ __forceinline__ void factor_all(Sys<C>& s, float* buf2, float* dinv, int k, int sys, int pr, int pc, int t,
                                           std::integer_sequence<int, Js...>) {
  // the steps of the padding (J >= k) are skipped: k is the same for every thread
  ((Js < k ? factor_step<C, Js>(s, buf2, dinv, sys, pr, pc, t) : void()), ...);
}

template <class C, int... Js>
__device__ __forceinline__ void factor_all_ahead(Sys<C>& s, float* buf2, float* dinv, int k, int sys, int pr, int pc,
                                                 std::integer_sequence<int, Js...>) {
  publish_column<C, 0>(s, buf2, dinv, pr, pc);
  sys_sync<C>(sys);
  // a skipped step's column (J >= k, the padding) may have been published by the step before: nothing reads it
  ((Js < k ? factor_step_ahead<C, Js>(s, buf2, dinv, sys, pr, pc) : void()), ...);
}

template <class C, int... Js>
__device__ __forceinline__ void back_all(const Sys<C>& s, float* w, const float* dinv, float (&xr)[C::XR], int k, int sys,
                                         int pr, int pc, int t, std::integer_sequence<int, Js...>) {
  ((C::K - 1 - Js < k ? back_step<C, C::K - 1 - Js>(s, w, dinv, xr, sys, pr, pc, t) : void()), ...);
}

// The whole solve of the block's systems; the body of a kernel launched with
// C::T * C::SPB threads a block and ceil(n / C::SPB) blocks.
template <class C>
__device__ __forceinline__ void solve_system(const float* __restrict__ A, const float* __restrict__ y,
                                             float* __restrict__ x, long long n, int k, int vec) {
  __shared__ __align__(16) float smem[C::SPB * C::SYS_FLOATS];
  const int sys = threadIdx.x / C::T;
  const int t = threadIdx.x % C::T;
  const long long b = static_cast<long long>(blockIdx.x) * C::SPB + sys;
  // the systems of a block share no barrier, so one past the end leaves whole
  if (b >= n) return;
  const int pr = t / C::PC;
  const int pc = t % C::PC;
  float* buf2 = smem + sys * C::SYS_FLOATS;
  float* dinv = buf2 + 2 * C::BUF;
  float* w = dinv + C::K;

  Sys<C> s;
  load_system<C>(s, A + b * k * k, y + b * k, k, vec, pr, pc);
  if constexpr (C::AHEAD) {
    factor_all_ahead<C>(s, buf2, dinv, k, sys, pr, pc, std::make_integer_sequence<int, C::K>{});
  } else {
    factor_all<C>(s, buf2, dinv, k, sys, pr, pc, t, std::make_integer_sequence<int, C::K>{});
  }

  if (pc == 0) {
#pragma unroll
    for (int a = 0; a < C::NA; ++a) w[a * C::PR + pr] = s.z[a];
  }
  sys_sync<C>(sys);
  float xr[C::XR];
  back_all<C>(s, w, dinv, xr, k, sys, pr, pc, t, std::make_integer_sequence<int, C::K>{});
#pragma unroll
  for (int q = 0; q < C::XR; ++q) {
    const int i = q * C::T + t;
    if (i < k) x[b * k + i] = xr[q];
  }
}

// Launch `kernel`, a __global__ wrapper of solve_system<C>, over n systems.
template <class C, class Kernel>
int launch(Kernel kernel, const float* A, const float* y, float* x, long long n, int k, cudaStream_t stream) {
  const long long blocks = (n + C::SPB - 1) / C::SPB;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // floats a load of A takes: a row starts at a multiple of k floats
  const uintptr_t at = reinterpret_cast<uintptr_t>(A);
  const int vec = (k % 4 == 0 && at % 16 == 0) ? 4 : (k % 2 == 0 && at % 8 == 0) ? 2 : 1;
  kernel<<<static_cast<unsigned>(blocks), C::T * C::SPB, 0, stream>>>(A, y, x, n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, static shared memory a block, threads a block and local
// (spill) bytes a thread of `kernel` as compiled.
template <class C, class Kernel>
int info(Kernel kernel, int* regs, int* smem_bytes, int* threads, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = C::T * C::SPB;
  *regs = a.numRegs;
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace lkt_reg
