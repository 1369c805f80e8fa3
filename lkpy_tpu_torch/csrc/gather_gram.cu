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
// Only A's lower triangle is written (the solves that read A read nothing
// else): the upper triangle of the output is left as it was.  A slot whose
// mask is false is never read from the table (its column number may be
// anything) and adds nothing.  Every column number of a slot whose mask is
// true must lie in [0, n); one outside is a device assertion.
//
// Contract: right is (n, k) f32, rows ld >= k floats apart, unit stride in a
// row, 1 <= k <= 256; cols (B, P) int32 or int64, vals (B, P) f32 and mask
// (B, P) bool (one byte), all contiguous; otor (k, k) f32 contiguous in
// implicit mode; A (B, k, k) and y (B, k) f32, contiguous.  A launch that
// splits rows (lkt_gather_gram_plan gives S > 1) also takes a workspace of
// ws_floats floats and sync_ints int32 set to 0.
//
// Bound.  Per real entry (mask true), k(k+1)/2 multiply-adds for A's lower
// triangle and k for y: at the implicit epoch's largest user chunk (30,024
// rows of P = 120 against the (27,000, 64) item table) about 2 * 2,080 flops
// an entry, 12.7 Gflop -> 0.19 ms at 67 TFLOP/s in f32 outside the tensor
// cores; the bytes (the chunk's cols, vals and mask, the 7 MB table read
// once, A's lower triangle and y written once, 0.27 GB) take 0.08 ms at
// 3.35 TB/s.  So the kernel is bound by operations.  The gathered rows never
// reach device memory: the unfused route wrote them (0.92 GB at that chunk),
// then a weighted copy, and read both back in two batched products.
//
// Design.  A is cut into 64 x 64 tiles of its lower triangle, and each row's
// slots into S segments of L slots; a block computes one tile over one
// segment of one row (grid: B * S x kt(kt+1)/2 tiles, kt = ceil(k / 64); one
// tile for k <= 64).  Each thread owns a 4 x 4 micro-tile of the tile in
// registers: on a diagonal tile only the micro-tiles on or under the
// diagonal, so a k = 64 row takes 136 threads (five warps) and no thread
// computes the upper triangle.  The block walks its segment in steps of
// kStage = 32 entries: it stages the step's factor rows (the tile's one or
// two 64-column segments) in shared memory with cp.async, 16-byte copies
// where the table, its row stride and k allow (else 8 or 4 bytes), two
// buffers deep so the next step's copies fly while this step is summed, and
// the step's weights beside them.  A masked slot is zero-filled by the copy
// itself (no read).  The walk stops at the segment's last real slot, so the
// padding after a prefix mask costs nothing; a mask with holes costs its
// zero-filled slots.  Per entry a thread reads two float4 and one float2
// from shared memory for 16 fused multiply-adds (plus 4 for y on the
// threads of micro-column 0 of the tiles in block-column 0).
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
// counter, adds the S partials in segment order and writes A and y.  A
// segment's sum runs over its entries in order in one thread, and the
// partials are added in a fixed order, so two launches agree to the bit
// (the counter and the real-entry count are integers); the two levels also
// keep a 90,000-entry row within float32 rounding of a blocked sum (one
// running sum fell outside 1e-5 of the plain version).  The tables of the
// path (7 to 35 MB) stay in the 50 MB L2, so the copies mostly hit L2.
//
// Measured on the card against this form: a warp of its own for y, the
// copies' column loads batched two or four at a time, and steps of 64
// entries each came within 5 % either way, and a warp more or a few
// registers more cost a block a SM.  Per entry a warp issues about 23
// instructions for 16 multiply-adds, and the block waits at two barriers a
// step; larger micro-tiles or the tensor cores (three-pass TF32) are the
// next steps.
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
constexpr int kBigThreads = 256;   // a 64 x 64 off-diagonal tile's micro-tiles
constexpr int kMaxSegment = 2048;  // slots a segment at most
constexpr int kMinSegment = 256;   // slots a segment at least, where rows are split to fill the card
constexpr int kWaves = 2;          // resident blocks' worth a launch should give

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
  int sw;     // floats a staged segment row (a multiple of 4)
  int segs;   // staged segments a buffer: 1 when k <= 64, else 2
  int S;      // segments a row
  int L;      // slots a segment (a multiple of kStage)
  float* ws;  // S > 1: partial sums, q floats a block, in (row, tile, segment) order
  int* sync;  // S > 1: for each (row, tile), the blocks done and the real slots they saw
  int q;
};

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_one_group() { asm volatile("cp.async.wait_group 1;\n" ::); }

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
  int last = lo, cnt = 0;
  for (int p = lo + tid; p < hi; p += blockDim.x) {
    if (mrow[p]) last = p + 1, ++cnt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if ((tid & 31) == 0) {
    atomicMax(&s_last, last);
    atomicAdd(&s_count, cnt);
  }
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

// The copy width in floats: 4 when k % 4 == 0 and the table and its row
// stride are 16-byte aligned, else 2 when 8-byte aligned, else 1.
int copy_width(const float* right, long long ld, int k) {
  const auto t = reinterpret_cast<std::uintptr_t>(right);
  if (k % 4 == 0 && ld % 4 == 0 && t % 16 == 0) return 4;
  if (k % 2 == 0 && ld % 2 == 0 && t % 8 == 0) return 2;
  return 1;
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

// Blocks at width k the card holds at once (registers and shared memory set
// it; the instances of the kernel differ little).
long long resident_blocks(int k) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_gram_kernel<int, true, 4, false>, threads_for(k),
                                                    shared_for(k)) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  return static_cast<long long>(per_sm) * sm_count();
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

template <typename Index, bool kImplicit, int W>
int launch(const Args& a, long long B, cudaStream_t stream) {
  const int kt = (a.k + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(B * a.S), static_cast<unsigned>(kt * (kt + 1) / 2));
  // the instance without segments keeps the registers of the hand-over out of the common case
  if (a.S > 1) {
    gather_gram_kernel<Index, kImplicit, W, true><<<grid, threads_for(a.k), shared_for(a.k), stream>>>(a);
  } else {
    gather_gram_kernel<Index, kImplicit, W, false><<<grid, threads_for(a.k), shared_for(a.k), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index, bool kImplicit>
int dispatch_width(const Args& a, long long B, cudaStream_t stream) {
  switch (copy_width(a.right, a.ld, a.k)) {
    case 4:
      return launch<Index, kImplicit, 4>(a, B, stream);
    case 2:
      return launch<Index, kImplicit, 2>(a, B, stream);
    default:
      return launch<Index, kImplicit, 1>(a, B, stream);
  }
}

template <typename Index>
int dispatch_mode(const Args& a, long long B, cudaStream_t stream) {
  return a.otor != nullptr ? dispatch_width<Index, true>(a, B, stream) : dispatch_width<Index, false>(a, B, stream);
}

}  // namespace

// How a (B, P) bucket at width k is launched: out[0] the segments a row
// (S), out[1] the slots a segment (L), out[2] the workspace floats and
// out[3] the workspace int32 (both 0 when S == 1).
extern "C" void lkt_gather_gram_plan(long long B, int P, int k, long long* out) {
  int S = 1, L = kStage;
  plan(B, P, k, S, L);
  const int kt = (k + kTile - 1) / kTile;
  const long long rt = B * (kt * (kt + 1) / 2);
  out[0] = S;
  out[1] = L;
  out[2] = S > 1 ? rt * S * (threads_for(k) * 16LL + kTile) : 0;
  out[3] = S > 1 ? 2 * rt : 0;
}

// A (B, k, k) lower triangle and y (B, k) of the ALS normal equations; otor
// non-null selects implicit mode, else explicit with reg.  idx_bytes is 4
// (int32 cols) or 8 (int64).  S and L as lkt_gather_gram_plan gives them;
// with S > 1, ws and sync as large as it says and sync all zero.  Returns a
// CUDA error code (0 when the launch was accepted).
extern "C" int lkt_gather_gram_f32(const float* right, long long ld, long long n, const void* cols, int idx_bytes,
                                   const float* vals, const unsigned char* mask, long long B, int P,
                                   const float* otor, float reg, int k, float* A, float* y, int S, int L, float* ws,
                                   int* sync, void* stream) {
  if (B <= 0 || P < 0 || k < 1 || k > 4 * kTile || ld < k || n < 1 || S < 1 || L < kStage || L % kStage != 0 ||
      B * S > 0x7fffffffLL || static_cast<long long>(S) * L < P || (S > 1 && (ws == nullptr || sync == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{right, ld, n, cols, vals, mask, P, otor, reg, k, A, y,
               k > kTile ? kTile : (k + 3) / 4 * 4, k > kTile ? 2 : 1, S, L, ws, sync, threads_for(k) * 16 + kTile};
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) return dispatch_mode<int>(a, B, s);
  if (idx_bytes == 8) return dispatch_mode<long long>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The copy width in floats (4, 2 or 1) a launch with this table takes.
extern "C" int lkt_gather_gram_width(const float* right, long long ld, int k) { return copy_width(right, ld, k); }
