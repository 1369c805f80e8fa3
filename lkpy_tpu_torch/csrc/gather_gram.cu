// Gather and ALS normal equations in one kernel, for Hopper (sm_90a).
//
// Replaces, on the routes where the gathered factor rows only feed the
// normal equations, the TPU row gather benchmarks/probe_gather.py::make_pallas.f
// (whose port is csrc/gather_rows.cu) together with the XLA gather and einsum
// that form the equations in lkpy_tpu/ops/als.py (solve_implicit_bucket and
// solve_explicit_bucket :117-159, _gram_scan_implicit/_gram_scan_explicit
// :309-358).  On the port's path: every training chunk of both ALS modes
// (ops/als.py::_solve_chunk), every fold-in block of serving
// (solve_*_bucket) and every per-query fold-in (solve_row_*).
//
// Function, for each row b of a (B, P) bucket, with g_p = right[cols[b, p]]
// and m_p = mask[b, p]:
//   implicit:  A = otor + sum_p c_p m_p g_p g_p^T,   y = sum_p (c_p + 1) m_p g_p
//   explicit:  A = sum_p m_p g_p g_p^T + reg n_b I,  y = sum_p m_p v_p g_p,
//              n_b = sum_p m_p
// Only A's lower triangle is defined (the solves that read A read nothing
// else): the FMA route leaves the upper triangle as it was, the tensor route
// writes some of it (A's own sums, next to the diagonal).  A slot whose
// mask is false is never read from the table (its column number may be
// anything) and adds nothing.  Every column number of a slot whose mask is
// true must lie in [0, n); one outside is a device assertion.
//
// Contract: right is (n, k) f32, rows ld >= k floats apart, unit stride in a
// row, 1 <= k <= 256; cols (B, P) int32 or int64, vals (B, P) f32 and mask
// (B, P) bool (one byte), all contiguous; otor (k, k) f32 contiguous in
// implicit mode (16-byte aligned on the tensor route); A (B, k, k) and y
// (B, k) f32, contiguous.  The copy width W (4, 2 or 1 floats) must divide
// k and ld, and the table must be 4 W-byte aligned.  A launch that splits
// rows (lkt_gather_gram_plan gives S > 1) also takes a workspace of
// ws_floats floats and sync_ints int32 set to 0.
//
// Bound.  Per real entry (mask true), k(k+1)/2 multiply-adds for A's lower
// triangle and k for y: at k = 64, 4,288 flops an entry, so 1.56e10 entries/s
// at 67 TFLOP/s, the f32 rate outside the tensor cores (the yardstick of
// train.gather_gram_roofline, whatever unit does the work); the bytes (the
// chunk's cols, vals and mask, the 7 MB table read once, A's lower triangle
// and y written once) take under half that time, except in buckets of rows
// under about 60 entries, where writing A weighs as much.  So the kernel is
// bound by operations.  The gathered rows never reach device memory: the
// unfused route wrote them, then a weighted copy, and read both back in two
// batched products.
//
// Two routes (tensor_route; ops/gather_gram.py::tensor_route mirrors it):
// copy width 4 at k <= 64 (k % 4 == 0 on a 16-byte aligned table whose rows
// lie a multiple of 4 floats apart: every shape of the port's training and
// serving at k = 64) takes the tensor cores, gather_gram_tc_kernel; widths
// 2 and 1 (k = 50, or a table view at an odd offset) and k > 64 take the f32
// FMA kernel, gather_gram_kernel.  Both cut each row's slots into S segments
// of L slots (a block a segment of a row, and of a 64 x 64 tile of A's lower
// triangle on the FMA route: kt(kt+1)/2 tiles, kt = ceil(k / 64)), stage 32
// entries a step in shared memory with cp.async (a masked slot zero-filled
// by the copy itself, no read) and stop at the segment's last real slot, so
// the padding after a prefix mask costs nothing.
//
// Tensor route.  A stage of 32 entries is X (32 x 64) in shared memory, rows
// 72 floats apart so that a fragment's 32 reads hit 32 banks; a ring of three
// stages, one barrier a stage, a stage's slots read three stages and its
// copies issued two stages ahead of its sum.  A updates as
// A += (diag(c) X)^T X with the entries as the product's depth:
// mma.sync.m16n8k8 in TF32 with f32 accumulators, in three passes.  Each
// operand is split as big = tf32(x), small = tf32(x - big), and small.big +
// big.small + big.big is summed (the technique of csrc/mips_topk.cu's
// tensor-core kernel); the dropped small.small term is 2^-22 of a product, so
// f32's accuracy stays, where a single pass keeps 2^-11.  The weight c (1 in
// explicit mode) scales the A operand in f32 before its split.  Two warps own
// 16-row strips, (0, 3) and (1, 2); strip r takes the 8-column fragments
// 0..2r+1, so each warp sums 10 and none lies wholly above the diagonal.  A
// lane reads its fragment values once as f32 and splits them in registers:
// at k = 64 a value feeds one or two warps, so splitting as it is staged
// would cost as many conversions and a second pass over shared memory.  The
// tensor cores add a product to an accumulator after aligning both to the
// larger exponent and dropping the bits below, not rounding them, so a long
// sum in one accumulator drifts toward zero: each stage sums into fresh
// fragments that are then added to the running sums in f32 (round to
// nearest).  y is summed from the same f32 values with fused multiply-adds,
// each lane over its entries, then across the four lanes of a fragment row.
// At the end the ring, now free, holds the tile row-major, and the rows are
// written in whole 16-byte pieces with otor's added (those pieces that hold a
// column on or under the diagonal; their columns above it get A's own
// symmetric sums), where fragment-shaped 8-byte stores and reads of otor took
// a third of a short row's time.  A strip wholly past k is skipped.
//
// FMA route.  Each thread owns a 4 x 4 micro-tile of a tile in registers (on
// a diagonal tile only those on or under the diagonal: a k = 64 row takes
// 136 threads), two stages in flight.  Per entry a thread reads two float4
// and one float2 from shared memory for 16 fused multiply-adds.
//
// Segments.  The item half's widest buckets hold a few rows of up to 90,000
// entries (8 rows of 158,240 slots): one block a row walked them in series
// on 8 of the 132 SMs and took most of the epoch.  So where the bucket's
// blocks would not fill the card twice over and its rows are wider than
// 256 slots, or a row is wider than 2,048 slots, the host splits each row
// into S segments of 256 to 2,048 slots (a serving block or a single
// query, split, lost more to the workspace's zeroing and the second pass
// than it gained): every block writes its partial sums to the workspace,
// and the last block of a (row, tile) to finish, found by an integer
// counter, adds the S partials in segment order and writes A and y.  The
// plan counts the blocks of the kernel that the width's launches take.
// Both routes sum a segment's entries in a fixed order (mma.sync adds in a
// fixed order) and the partials in a fixed order, so two launches agree to
// the bit (the counter and the real-entry count are integers); the two
// levels also keep a 90,000-entry row within float32 rounding of a blocked
// sum.  The tables of the path (7 to 35 MB) stay in the 50 MB L2, so the
// copies mostly hit L2.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, profiler time, the FMA form at
// width 4 as it was in turns in the same calls; float64 error as a share of
// the largest magnitude): the training cell's user chunk (25,896, 48)
// 0.389 ms against 0.464, a split user bucket (1,312, 1,072) 0.325 against
// 0.457, the widest item chunk (40, 79,120) 0.609 against 1.044 (29 % of the
// bound against 17 %), a serving block (1,024, 256) 0.061 against 0.065, a
// single query (1, 103) 0.0143 against 0.0127 (one block: the chain of
// reads, not the sums, sets it); errors 2e-7 to 5e-7, the FMA route's 2e-7
// to 8e-7.  Tried and measured: one accumulator for the whole segment (no
// fresh fragments a stage) read 2.2e-5 at the widest item chunk, outside the
// 1e-5 the card's tests hold, and gained 6 %; blocks that walk 8 rows as one
// stream of stages, four warps of 5 fragments, and a register cap of 128
// (which spills) were slower, as were the tensor cores at k > 64 (two warps
// of 16 fragments on an off-diagonal tile, or four of 8: 6.3 to 9.6 ms at
// (29,936, 120) and k = 128 against the FMA kernel's 3.7), so k > 64 keeps
// the FMA kernel.  In the training epoch (52 launches, all on the tensor
// route) G's device time fell 1.44 times: its split launches 1.65 times,
// its unsplit ones, rows of 20 to about 1,000 entries, 1.16 times.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (ops/_build.py); the Python wrapper is ops/gather_gram.py.

#include <algorithm>
#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // A's tile edge
constexpr int kStage = 32;         // entries staged a step
constexpr int kBigThreads = 256;   // FMA route: a 64 x 64 off-diagonal tile's micro-tiles
constexpr int kMaxSegment = 2048;  // slots a segment at most
constexpr int kMinSegment = 256;   // slots a segment at least, where rows are split to fill the card
constexpr int kWaves = 2;          // resident blocks' worth a launch should give
constexpr int kTcRow = kTile + 8;  // tensor route: floats a staged row (fragment reads hit 32 banks)
constexpr int kRing = 3;           // tensor route: stages in the ring
constexpr int kTcThreads = 64;     // tensor route: two warps a block
constexpr int kTcFrags = 10;       // tensor route: fragments a warp (of the lower triangle's 20)

struct Args {
  const float* right;
  long long ld;
  long long n;
  const void* cols;
  const float* vals;
  const unsigned char* mask;
  int P;
  const float* otor;  // implicit mode only
  float reg;          // explicit mode only
  int k;
  float* A;
  float* y;
  int sw;     // FMA route: floats a staged segment row (a multiple of 4)
  int segs;   // FMA route: staged segments a buffer: 1 when k <= 64, else 2
  int S;      // segments a row
  int L;      // slots a segment (a multiple of kStage)
  float* ws;  // S > 1: partial sums, q floats a block, in (row, tile, segment) order
  int* sync;  // S > 1: for each (row, tile), the blocks done and the real slots they saw
  int q;
};

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wait_one_group() { wait_groups<1>(); }

// Copy W floats to shared memory, or zeros where live is false (no read).
template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned bytes = live ? 4u * W : 0u;
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  } else if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  }
}

// Tile t of the lower triangle of tiles, row by row: (I, J) with J <= I.
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  J = t - I * (I + 1) / 2;
}

// The segment's last real slot + 1 and its count of real slots, by the whole
// block (integers: exact in any order); both from s_last and s_count after
// the next barrier.
__device__ __forceinline__ void scan_segment(const unsigned char* mrow, int lo, int hi, int* s_last, int* s_count) {
  int last = lo, cnt = 0;
  for (int p = lo + static_cast<int>(threadIdx.x); p < hi; p += blockDim.x) {
    if (mrow[p]) last = p + 1, ++cnt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(s_last, last);
    atomicAdd(s_count, cnt);
  }
}

// ---------------------------------------------------------------------------
// FMA route (copy widths 2 and 1, and k > 64)
// ---------------------------------------------------------------------------

template <typename Index, bool kImplicit, int W, bool kSplit>
__global__ void __launch_bounds__(kBigThreads) gather_gram_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const g = reinterpret_cast<float*>(smem4);                               // [2][segs][kStage][sw]
  float2* const wgt = reinterpret_cast<float2*>(g + 2 * a.segs * kStage * a.sw);  // [2][kStage]
  __shared__ int s_last, s_count, s_final;

  const int tid = threadIdx.x;
  const long long b = kSplit ? blockIdx.x / a.S : blockIdx.x;
  const int seg = static_cast<int>(blockIdx.x - b * a.S);
  const int lo = kSplit ? seg * a.L : 0, hi = kSplit ? min(a.P, lo + a.L) : a.P;
  int I, J;
  tile_of(blockIdx.y, I, J);
  const int k = a.k;
  const int i0 = I * kTile, j0 = J * kTile;
  const int mi = min(kTile, k - i0), mj = min(kTile, k - j0);
  const bool diag = I == J;
  const int nti = (mi + 3) / 4, ntj = (mj + 3) / 4;
  const int count = diag ? nti * (nti + 1) / 2 : nti * ntj;
  const bool active = tid < count;
  int ti = 0, tj = 0;
  if (diag) {
    while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
    tj = tid - ti * (ti + 1) / 2;
  } else {
    ti = tid / ntj;
    tj = tid - ti * ntj;
  }

  const long long row = b * a.P;
  const unsigned char* const mrow = a.mask + row;
  const Index* const crow = static_cast<const Index*>(a.cols) + row;
  const float* const vrow = a.vals + row;

  // the segment's last real slot and its count of real slots (integers: exact in any order)
  if (tid == 0) s_last = lo, s_count = 0;
  __syncthreads();
  scan_segment(mrow, lo, hi, &s_last, &s_count);
  // columns past k of a staged segment row stay zero (they feed only outputs that are not written)
  for (int c = tid; c < 2 * a.segs * kStage; c += blockDim.x) {
    const int width = (c / kStage) % a.segs == 0 ? mi : mj;
    for (int x = width; x < a.sw; ++x) g[c * a.sw + x] = 0.0f;
  }
  __syncthreads();
  const int pend = s_last;
  int real = s_count;

  const int nch0 = mi / W, nch1 = diag ? 0 : mj / W;  // k % W == 0, so a segment is whole vectors
  const int per_entry = nch0 + nch1;

  auto issue = [&](int step, int buf) {
    const int p0 = lo + step * kStage;
    const int total = kStage * per_entry;
    for (int c = tid; c < total; c += blockDim.x) {
      const int q = c / per_entry;
      const int r = c - q * per_entry;
      const int s = r < nch0 ? 0 : 1;
      const int ch = s == 0 ? r : r - nch0;
      const int p = p0 + q;
      if (p >= pend) continue;
      const bool live = mrow[p] != 0;
      const float* src = a.right;
      if (live) {
        const long long col = static_cast<long long>(crow[p]);
        assert(col >= 0 && col < a.n);
        src = a.right + col * a.ld + (s == 0 ? i0 : j0) + ch * W;
      }
      copy_async<W>(g + ((buf * a.segs + s) * kStage + q) * a.sw + ch * W, src, live);
    }
    if (tid < kStage) {
      const int p = p0 + tid;
      float wa = 0.0f, wy = 0.0f;
      if (p < pend && mrow[p]) {
        const float v = vrow[p];
        if constexpr (kImplicit) {
          wa = v;
          wy = v + 1.0f;
        } else {
          wa = 1.0f;
          wy = v;
        }
      }
      wgt[buf * kStage + tid] = make_float2(wa, wy);
    }
  };

  float acc[4][4];
  float yacc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    yacc[u] = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  }
  const bool do_y = active && J == 0 && tj == 0;

  const int steps = (pend - lo + kStage - 1) / kStage;
  if (steps > 0) issue(0, 0);
  commit_group();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) issue(step + 1, buf ^ 1);
    commit_group();
    wait_one_group();
    __syncthreads();
    if (active) {
      const int n_here = min(kStage, pend - lo - step * kStage);
      const float* gi = g + (buf * a.segs) * kStage * a.sw + 4 * ti;
      const float* gj = g + (buf * a.segs + (diag ? 0 : 1)) * kStage * a.sw + 4 * tj;
      const float2* w = wgt + buf * kStage;
#pragma unroll 4
      for (int q = 0; q < n_here; ++q) {
        const float2 wq = w[q];
        const float4 x4 = *reinterpret_cast<const float4*>(gi + q * a.sw);
        const float4 z4 = *reinterpret_cast<const float4*>(gj + q * a.sw);
        float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const float z[4] = {z4.x, z4.y, z4.z, z4.w};
        if (do_y) {
#pragma unroll
          for (int u = 0; u < 4; ++u) yacc[u] = fmaf(wq.y, x[u], yacc[u]);
        }
        if constexpr (kImplicit) {
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] *= wq.x;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(x[u], z[v], acc[u][v]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (kSplit) {
    // hand the partial sums over; the last block of this (row, tile) adds them up in segment order
    const long long rt = b * gridDim.y + blockIdx.y;
    float* const mine = a.ws + (rt * a.S + seg) * a.q;
    if (active) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) mine[tid * 16 + u * 4 + v] = acc[u][v];
        if (do_y) mine[blockDim.x * 16 + 4 * ti + u] = yacc[u];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(a.sync + 2 * rt + 1, real);
      __threadfence();
      s_final = atomicAdd(a.sync + 2 * rt, 1) == a.S - 1;
    }
    __syncthreads();
    if (!s_final) return;
    __threadfence();
    if (tid == 0) s_count = atomicAdd(a.sync + 2 * rt + 1, 0);
    __syncthreads();
    real = s_count;
    if (active) {
      const float* part = a.ws + rt * a.S * a.q;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = __ldcg(part + tid * 16 + u * 4 + v);
        if (do_y) yacc[u] = __ldcg(part + blockDim.x * 16 + 4 * ti + u);
      }
      for (int s = 1; s < a.S; ++s) {
        part += a.q;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += __ldcg(part + tid * 16 + u * 4 + v);
          if (do_y) yacc[u] += __ldcg(part + blockDim.x * 16 + 4 * ti + u);
        }
      }
    }
  }

  if (!active) return;
  float* const Ab = a.A + b * static_cast<long long>(k) * k;
  const float diag_add = kImplicit ? 0.0f : a.reg * static_cast<float>(real);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * ti + u;
    if (i >= k) break;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tj + v;
      if (j < k && j <= i) {
        float add;
        if constexpr (kImplicit) {
          add = a.otor[i * k + j];
        } else {
          add = i == j ? diag_add : 0.0f;
        }
        Ab[i * k + j] = acc[u][v] + add;
      }
    }
    if (do_y) a.y[b * k + i] = yacc[u];
  }
}

// ---------------------------------------------------------------------------
// Tensor route (copy width 4, k <= 64): three-pass TF32 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// x as big = tf32(x) and small = tf32(x - big).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += A B for a 16 x 8 fragment of A, 8 entries deep.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = A B: the first product of a stage's fresh fragments.
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// A warp's fragments of A: strip S0's 8-column fragments 0 .. N0 - 1 in places
// 0 .. N0 - 1, then strip S1's 0 .. N1 - 1.  Warp 0 takes strips (0, 3), warp
// 1 (1, 2): strip r takes fragments 0 .. 2r + 1, so each warp sums 10 and
// none lies wholly above the diagonal.
template <int S0_, int N0_, int S1_, int N1_>
struct Strips {
  static constexpr int S0 = S0_, N0 = N0_, S1 = S1_, N1 = N1_;
};

template <typename Fn>
__device__ __forceinline__ void for_warp(int warp, Fn&& fn) {
  if (warp == 0) {
    fn(Strips<0, 2, 3, 8>{});
  } else {
    fn(Strips<1, 4, 2, 6>{});
  }
}

// One pass over a strip's N fragments (places F0 ..).
template <int N, int F0, bool kFirst, int NB>
__device__ __forceinline__ void tc_pass(float (&c)[kTcFrags][4], const uint32_t (&a)[4], const uint32_t (&b0)[NB],
                                        const uint32_t (&b1)[NB]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if constexpr (kFirst) {
      mma_tf32_first(c[F0 + n], a, b0[n], b1[n]);
    } else {
      mma_tf32(c[F0 + n], a, b0[n], b1[n]);
    }
  }
}

// Eight entries of a stage into a warp's fragments.  x: this lane's entry t
// at column g of the staged rows (entry t + 4 lies 4 rows further).  A lane
// holds B values (t | t + 4, 8n + g) and, among them, A values (t | t + 4,
// 16 s + g | 16 s + 8 + g): the fragment layouts of m16n8k8.  The weight
// (w.x) scales the A operand in f32 before its split; y (weight w.y) is
// summed from the f32 A values.
template <class G, bool kImplicit, bool kFirst>
__device__ __forceinline__ void tc_step(const float* x, float2 w0, float2 w1, float (&c)[kTcFrags][4],
                                        float (&ysum)[4], bool live0, bool live1) {
  constexpr int NB = G::N0 > G::N1 ? G::N0 : G::N1;
  float x0[NB], x1[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    x0[n] = x[8 * n];
    x1[n] = x[4 * kTcRow + 8 * n];
  }
  float av[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = h == 0 ? G::S0 : G::S1;
    av[h][0] = x0[2 * s];
    av[h][1] = x0[2 * s + 1];
    av[h][2] = x1[2 * s];
    av[h][3] = x1[2 * s + 1];
    ysum[2 * h] = fmaf(w1.y, av[h][2], fmaf(w0.y, av[h][0], ysum[2 * h]));
    ysum[2 * h + 1] = fmaf(w1.y, av[h][3], fmaf(w0.y, av[h][1], ysum[2 * h + 1]));
  }
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split(kImplicit ? av[h][e] * (e < 2 ? w0.x : w1.x) : av[h][e], ab[h][e], as[h][e]);
  }
  uint32_t bb0[NB], bs0[NB], bb1[NB], bs1[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    split(x0[n], bb0[n], bs0[n]);
    split(x1[n], bb1[n], bs1[n]);
  }
  // small.big, big.small, big.big: the small terms enter a stage's fragments first
  if (live0) tc_pass<G::N0, 0, kFirst>(c, as[0], bb0, bb1);
  if (live1) tc_pass<G::N1, G::N0, kFirst>(c, as[1], bb0, bb1);
  if (live0) tc_pass<G::N0, 0, false>(c, ab[0], bs0, bs1);
  if (live1) tc_pass<G::N1, G::N0, false>(c, ab[1], bs0, bs1);
  if (live0) tc_pass<G::N0, 0, false>(c, ab[0], bb0, bb1);
  if (live1) tc_pass<G::N1, G::N0, false>(c, ab[1], bb0, bb1);
}

// A stage of n_here entries (xs: its staged rows; w: its weights) into
// fresh fragments, then added to acc.
template <class G, bool kImplicit>
__device__ __forceinline__ void tc_stage(const float* xs, const float2* w, int n_here, float (&acc)[kTcFrags][4],
                                         float (&ysum)[4], bool live0, bool live1, int g, int t) {
  float c[kTcFrags][4];
  const float* x = xs + t * kTcRow + g;
  tc_step<G, kImplicit, true>(x, w[t], w[t + 4], c, ysum, live0, live1);
#pragma unroll
  for (int ks = 1; ks < kStage / 8; ++ks) {
    if (8 * ks < n_here) {
      tc_step<G, kImplicit, false>(x + 8 * ks * kTcRow, w[8 * ks + t], w[8 * ks + t + 4], c, ysum, live0, live1);
    }
  }
#pragma unroll
  for (int f = 0; f < G::N0 + G::N1; ++f) {
    if (f < G::N0 ? live0 : live1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] += c[f][e];
    }
  }
}

// A warp's fragments into the tile in shared memory (row-major, kTcRow
// floats a row): fragment (s, n) holds rows 16 s + g (+ 8), columns
// 8 n + 2 t (+ 1).
template <class G>
__device__ __forceinline__ void tc_scatter(const float (&acc)[kTcFrags][4], float* tile, int g, int t) {
#pragma unroll
  for (int f = 0; f < G::N0 + G::N1; ++f) {
    const int s = f < G::N0 ? G::S0 : G::S1;
    const int n = f < G::N0 ? f : f - G::N0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float2*>(tile + (16 * s + 8 * r + g) * kTcRow + 8 * n + 2 * t) =
          make_float2(acc[f][2 * r], acc[f][2 * r + 1]);
    }
  }
}

template <typename Index, bool kImplicit, bool kSplit>
__global__ void __launch_bounds__(kTcThreads) gather_gram_tc_kernel(const Args a) {
  constexpr int kPer = kStage * 16 / kTcThreads;  // entries a thread stages a step: 16 threads an entry, 16 bytes each
  constexpr int kBuf = kStage * kTcRow;
  extern __shared__ float4 smem4[];
  float* const g = reinterpret_cast<float*>(smem4);                 // [kRing][kStage][kTcRow]
  float2* const wgt = reinterpret_cast<float2*>(g + kRing * kBuf);  // [kRing][kStage]
  __shared__ int s_last, s_count, s_final;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int fg = lane >> 2, ft = lane & 3;  // a lane's row in its fragments, and its place in the row
  const long long b = kSplit ? blockIdx.x / a.S : blockIdx.x;
  const int seg = static_cast<int>(blockIdx.x - b * a.S);
  const int lo = kSplit ? seg * a.L : 0, hi = kSplit ? min(a.P, lo + a.L) : a.P;
  const int k = a.k;

  const long long row = b * a.P;
  const unsigned char* const mrow = a.mask + row;
  const Index* const crow = static_cast<const Index*>(a.cols) + row;
  const float* const vrow = a.vals + row;

  // Staging: this thread copies 16 bytes (columns 4 c4 ..) of entries
  // tid / 16 + 4 m of each stage.  A stage's slots are read (fetch) three
  // stages ahead and its copies issued (stage) two stages ahead of its sum.
  // Slots in [pend, hi) are all masked, so hi bounds the reads and the first
  // stage's need not wait for the segment's scan.
  const int c4 = tid % 16;
  const bool copies = 4 * c4 < k;
  float* const dst0 = g + (tid / 16) * kTcRow + 4 * c4;
  Index slot_col[kPer];
  unsigned slot_live = 0;
  float2 slot_w = make_float2(0.0f, 0.0f);
  auto fetch = [&](int step) {
    const int p0 = lo + step * kStage + tid / 16;
    slot_live = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int p = p0 + m * (kTcThreads / 16);
      slot_col[m] = p < hi ? crow[p] : Index(0);
      slot_live |= static_cast<unsigned>(p < hi && mrow[p] != 0) << m;
    }
    if (tid < kStage) {
      const int p = lo + step * kStage + tid;
      slot_w = make_float2(0.0f, 0.0f);
      if (p < hi && mrow[p]) {
        const float v = vrow[p];
        slot_w = kImplicit ? make_float2(v, v + 1.0f) : make_float2(1.0f, v);
      }
    }
  };
  auto stage = [&](int step) {
    const int buf = step % kRing;
    if (copies) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const bool live = (slot_live >> m) & 1u;
        const float* src = a.right;
        if (live) {
          const long long col = static_cast<long long>(slot_col[m]);
          assert(col >= 0 && col < a.n);
          src = a.right + col * a.ld + 4 * c4;
        }
        // every slot of the stage is written: a fragment reads whole groups of 8 entries
        copy_async<4>(dst0 + buf * kBuf + m * (kTcThreads / 16) * kTcRow, src, live);
      }
    }
    if (tid < kStage) wgt[buf * kStage + tid] = slot_w;
  };

  if (tid == 0) s_last = lo, s_count = 0;
  fetch(0);
  __syncthreads();
  scan_segment(mrow, lo, hi, &s_last, &s_count);
  // columns past k of a staged row stay zero (they feed only outputs that are not written)
  for (int c = tid; c < kRing * kStage; c += kTcThreads) {
    for (int x = k; x < kTile; ++x) g[c * kTcRow + x] = 0.0f;
  }
  __syncthreads();
  const int pend = s_last;
  int real = s_count;

  float acc[kTcFrags][4];
#pragma unroll
  for (int f = 0; f < kTcFrags; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;
  }
  float ysum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const int steps = (pend - lo + kStage - 1) / kStage;
  if (0 < steps) stage(0);
  commit_group();
  if (1 < steps) {
    fetch(1);
    stage(1);
  }
  commit_group();
  if (2 < steps) fetch(2);
  for (int step = 0; step < steps; ++step) {
    wait_groups<kRing - 2>();
    __syncthreads();  // the stage has landed, and every warp is done with the previous stage's buffer
    if (step + 2 < steps) stage(step + 2);
    commit_group();
    if (step + 3 < steps) fetch(step + 3);
    const float* xs = g + (step % kRing) * kBuf;
    const float2* w = wgt + (step % kRing) * kStage;
    const int n_here = min(kStage, pend - lo - step * kStage);
    for_warp(warp, [&](auto grp) {
      using G = decltype(grp);
      // a strip wholly past k is skipped
      tc_stage<G, kImplicit>(xs, w, n_here, acc, ysum, 16 * G::S0 < k, 16 * G::S1 < k, fg, ft);
    });
  }

  // y: each lane summed its own entries; add the four lanes of a fragment row
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ysum[u] += __shfl_xor_sync(0xffffffffu, ysum[u], 1);
    ysum[u] += __shfl_xor_sync(0xffffffffu, ysum[u], 2);
  }
  // ysum[u], u = 2 h + u', is feature 16 strip_h + 8 u' + fg
  const int strip0 = warp == 0 ? 0 : 1, strip1 = warp == 0 ? 3 : 2;
  auto y_feature = [&](int u) { return 16 * (u < 2 ? strip0 : strip1) + 8 * (u & 1) + fg; };

  if constexpr (kSplit) {
    // hand the partial sums over; the last block of this row to finish adds them up in segment order
    float* const mine = a.ws + (b * a.S + seg) * a.q;
#pragma unroll
    for (int f = 0; f < kTcFrags; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * f + e) * kTcThreads + tid] = acc[f][e];
    }
    if (ft == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) mine[4 * kTcFrags * kTcThreads + y_feature(u)] = ysum[u];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(a.sync + 2 * b + 1, real);
      __threadfence();
      s_final = atomicAdd(a.sync + 2 * b, 1) == a.S - 1;
    }
    __syncthreads();
    if (!s_final) return;
    __threadfence();
    if (tid == 0) s_count = atomicAdd(a.sync + 2 * b + 1, 0);
    __syncthreads();
    real = s_count;
    const float* part = a.ws + b * a.S * a.q;
    for (int s = 0; s < a.S; ++s, part += a.q) {
#pragma unroll
      for (int f = 0; f < kTcFrags; ++f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __ldcg(part + (4 * f + e) * kTcThreads + tid);
          acc[f][e] = s == 0 ? v : acc[f][e] + v;
        }
      }
      if (ft == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = __ldcg(part + 4 * kTcFrags * kTcThreads + y_feature(u));
          ysum[u] = s == 0 ? v : ysum[u] + v;
        }
      }
    }
  }

  if (ft == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (y_feature(u) < k) a.y[b * k + y_feature(u)] = ysum[u];
    }
  }
  // A through the ring, now free: the fragments into a row-major tile, then
  // rows written in whole 16-byte pieces (those holding a column on or under
  // the diagonal; their columns above it hold A's own symmetric sums), otor
  // read in the same pieces
  __syncthreads();
  for_warp(warp, [&](auto grp) { tc_scatter<decltype(grp)>(acc, g, fg, ft); });
  __syncthreads();
  float* const Ab = a.A + b * static_cast<long long>(k) * k;
  const float diag_add = kImplicit ? 0.0f : a.reg * static_cast<float>(real);
  for (int c = tid; c < k * (kTile / 4); c += kTcThreads) {
    const int i = c / (kTile / 4), j = 4 * (c % (kTile / 4));
    if (j > i || j >= k) continue;
    float4 v = *reinterpret_cast<const float4*>(g + i * kTcRow + j);
    if constexpr (kImplicit) {
      const float4 o = __ldg(reinterpret_cast<const float4*>(a.otor + i * k + j));
      v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
    } else {
      v.x += i == j ? diag_add : 0.0f;
      v.y += i == j + 1 ? diag_add : 0.0f;
      v.z += i == j + 2 ? diag_add : 0.0f;
      v.w += i == j + 3 ? diag_add : 0.0f;
    }
    *reinterpret_cast<float4*>(Ab + i * k + j) = v;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int threads_for(int k) {
  if (k > kTile) return kBigThreads;
  const int nt = (k + 3) / 4;
  const int count = nt * (nt + 1) / 2;
  return (count + 31) / 32 * 32;
}

size_t shared_for(int k) {
  const int sw = k > kTile ? kTile : (k + 3) / 4 * 4;
  const int segs = k > kTile ? 2 : 1;
  return 2 * static_cast<size_t>(segs) * kStage * sw * sizeof(float) + 2 * kStage * sizeof(float2);
}

constexpr size_t kTcShared = static_cast<size_t>(kRing) * kStage * kTcRow * sizeof(float) + kRing * kStage * sizeof(float2);

// The route rule: the tensor cores take copy width 4 at k <= 64; the FMA
// kernel takes widths 2 and 1, and k > 64.
bool tensor_route(int k, int W) { return W == 4 && k <= kTile; }

// Floats of partial sums a block of each route hands over in a split launch.
long long fma_partials(int k) { return threads_for(k) * 16LL + kTile; }
long long tc_partials() { return kTcThreads * 4LL * kTcFrags + kTile; }

// Whether the copy width W (floats) fits the table: W divides k and the row
// stride, and the table is 4 W-byte aligned.
bool width_fits(const float* right, long long ld, int k, int W) {
  return (W == 4 || W == 2 || W == 1) && k % W == 0 && ld % W == 0 &&
         reinterpret_cast<std::uintptr_t>(right) % (4u * W) == 0;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

// Blocks at width k the card holds at once: of the tensor route's kernel for
// k <= 64, which every launch at copy width 4 there takes, else of the FMA
// kernel (registers and shared memory set it; the instances differ little).
// Asked once for each.
long long resident_blocks(int k) {
  static int per_sm[2] = {0, 0};
  int& n = per_sm[k > kTile ? 1 : 0];
  if (n == 0) {
    int got = 0;
    const cudaError_t err =
        k > kTile ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, gather_gram_kernel<int, true, 4, false>,
                                                                  threads_for(k), shared_for(k))
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, gather_gram_tc_kernel<int, true, false>,
                                                                  kTcThreads, kTcShared);
    n = err == cudaSuccess && got > 0 ? got : 1;
  }
  return static_cast<long long>(n) * sm_count();
}

// Segments a row (S) and slots a segment (L) for a (B, P) bucket at width k:
// enough segments that the launch fills the card kWaves times over, but
// none narrower than kMinSegment slots (a split costs a workspace, its
// zeroing and a second pass), and none wider than kMaxSegment.
void plan(long long B, int P, int k, int& S, int& L) {
  const int kt = (k + kTile - 1) / kTile;
  const long long blocks = B * (kt * (kt + 1) / 2);
  const long long want = kWaves * resident_blocks(k);
  const long long steps = std::max((P + kStage - 1) / kStage, 1);
  long long s = blocks >= want ? 1 : (want + blocks - 1) / blocks;
  s = std::min<long long>(s, std::max((P + kMinSegment - 1) / kMinSegment, 1));
  s = std::max<long long>(s, (P + kMaxSegment - 1) / kMaxSegment);
  s = std::min(s, steps);
  L = static_cast<int>((steps + s - 1) / s) * kStage;
  S = std::max((P + L - 1) / L, 1);
}

template <typename Index, bool kImplicit>
int launch_tc(Args a, long long B, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B * a.S));
  a.q = static_cast<int>(tc_partials());
  // the instance without segments keeps the registers of the hand-over out of the common case
  if (a.S > 1) {
    gather_gram_tc_kernel<Index, kImplicit, true><<<grid, kTcThreads, kTcShared, stream>>>(a);
  } else {
    gather_gram_tc_kernel<Index, kImplicit, false><<<grid, kTcThreads, kTcShared, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index, bool kImplicit, int W>
int launch_fma(Args a, long long B, cudaStream_t stream) {
  const int kt = (a.k + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(B * a.S), static_cast<unsigned>(kt * (kt + 1) / 2));
  a.sw = a.k > kTile ? kTile : (a.k + 3) / 4 * 4;
  a.segs = a.k > kTile ? 2 : 1;
  a.q = static_cast<int>(fma_partials(a.k));
  if (a.S > 1) {
    gather_gram_kernel<Index, kImplicit, W, true><<<grid, threads_for(a.k), shared_for(a.k), stream>>>(a);
  } else {
    gather_gram_kernel<Index, kImplicit, W, false><<<grid, threads_for(a.k), shared_for(a.k), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index, bool kImplicit>
int dispatch_width(const Args& a, int W, long long B, cudaStream_t stream) {
  if (tensor_route(a.k, W)) return launch_tc<Index, kImplicit>(a, B, stream);
  switch (W) {
    case 4:
      return launch_fma<Index, kImplicit, 4>(a, B, stream);
    case 2:
      return launch_fma<Index, kImplicit, 2>(a, B, stream);
    default:
      return launch_fma<Index, kImplicit, 1>(a, B, stream);
  }
}

template <typename Index>
int dispatch_mode(const Args& a, int W, long long B, cudaStream_t stream) {
  return a.otor != nullptr ? dispatch_width<Index, true>(a, W, B, stream) : dispatch_width<Index, false>(a, W, B, stream);
}

}  // namespace

// How a (B, P) bucket at width k is launched: out[0] the segments a row
// (S), out[1] the slots a segment (L), out[2] the workspace floats and
// out[3] the workspace int32 (both 0 when S == 1).  The workspace holds
// either route's partial sums.
extern "C" void lkt_gather_gram_plan(long long B, int P, int k, long long* out) {
  int S = 1, L = kStage;
  plan(B, P, k, S, L);
  const int kt = (k + kTile - 1) / kTile;
  const long long rt = B * (kt * (kt + 1) / 2);
  const long long q = k > kTile ? fma_partials(k) : std::max(fma_partials(k), tc_partials());
  out[0] = S;
  out[1] = L;
  out[2] = S > 1 ? rt * S * q : 0;
  out[3] = S > 1 ? 2 * rt : 0;
}

// A (B, k, k) lower triangle and y (B, k) of the ALS normal equations; otor
// non-null selects implicit mode, else explicit with reg.  idx_bytes is 4
// (int32 cols) or 8 (int64).  S and L as lkt_gather_gram_plan gives them;
// with S > 1, ws and sync as large as it says and sync all zero.  W is the
// copy width, which must fit the table and with k chooses the route (4 at
// k <= 64: the tensor cores, with otor 16-byte aligned; else the FMA
// kernel).  Returns a CUDA error code (0 when the launch was accepted).
extern "C" int lkt_gather_gram_f32(const float* right, long long ld, long long n, const void* cols, int idx_bytes,
                                   const float* vals, const unsigned char* mask, long long B, int P,
                                   const float* otor, float reg, int k, float* A, float* y, int S, int L, float* ws,
                                   int* sync, int W, void* stream) {
  if (B <= 0 || P < 0 || k < 1 || k > 4 * kTile || ld < k || n < 1 || S < 1 || L < kStage || L % kStage != 0 ||
      B * S > 0x7fffffffLL || static_cast<long long>(S) * L < P || (S > 1 && (ws == nullptr || sync == nullptr)) ||
      !width_fits(right, ld, k, W) ||
      (tensor_route(k, W) && otor != nullptr && reinterpret_cast<std::uintptr_t>(otor) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{right, ld, n, cols, vals, mask, P, otor, reg, k, A, y, 0, 0, S, L, ws, sync, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) return dispatch_mode<int>(a, W, B, s);
  if (idx_bytes == 8) return dispatch_mode<long long>(a, W, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
