// Sparse-dense product out = A @ x for LightGCN's propagation, for Hopper
// (sm_90a).
//
// Replaces cuSPARSE's csrmm (torch.sparse.mm of a CSR matrix), which ran
// every product of ops/graph.py::propagate and its backward.  It replaces no
// TPU kernel: the JAX package propagates with segment sums
// (lkpy_tpu/ops/graph.py), left to XLA.
//
// Function.  A is one orientation of the bipartite adjacency, in CSR form:
// row r of out is the sum over the edges e in [rowptr[r], rowptr[r + 1]) of
// val[e] * x[src[e]], float32 products and float32 sums.  "SU" makes user
// rows from item rows (the forward A @ i and the backward of A^T @ u), "SI"
// item rows from user rows (the forward A^T @ u and the backward of A @ g).
//
// Bound.  The benchmark's bound counts each edge once (its column and value,
// 8 bytes) and each table row read and written once: at MovieLens 20M's
// 20,000,263 edges and k = 64, 202 MB, 60 us at 3.35 TB/s.  What it leaves
// out is the gather: each edge reads a whole source row, 256 bytes, 5.1 GB a
// product.  Rows that one SM reads again come from its L1 or shared memory;
// the others from L2, whose gathers ran at about 3.4 TB/s (a product that
// reads every row from L2, SI without tiles, took 1.5 ms on an H100).  So
// the design is about the reuse of rows inside an SM.
//
// Design.  The plan (ops/graph.py) is built once a graph, on the card.
// * SU, kPull: each user row's edges gather item rows through the read-only
//   path.  Item degrees are skewed (ML-20M's 800 most-rated items hold 77 %
//   of the edges), and the rows of the most-rated items stay in each SM's
//   L1, to which the launch gives all its shared memory.  A mode that copied
//   those 800 rows into shared memory first was 7 % faster at k = 64 (0.49
//   against 0.53 ms a product, about 2 % of a LightGCN step) and 7 % slower
//   at k = 16 (0.19 against 0.18 ms), so SU stages nothing.
// * SI, kTile for the wide rows: user degrees are flat, so no user row is
//   hot for the whole card, but a run of a few hundred consecutive users is
//   hot for the most-rated items.  The plan splits SI in two launches.  The
//   rows of at least 8 edges a block (the most-rated items, 91 % of the
//   edges at ML-20M) are summed tile by tile: tiles of consecutive users
//   with equal edges, at most 200 KB of rows each, a run of tiles a block;
//   the block copies a tile's user rows to shared memory and sums every
//   wide item's edges into that tile, each (tile, item) sum to a scratch
//   row.  The other items are summed whole by kPull, from the read-only
//   path.  spmm_reduce_kernel then adds each wide item's tiles in order.
// * Work: the plan cuts the edges into items, each a run of consecutive
//   whole rows (at most 16, their first edges within one window of 1,024
//   edges; 256 in the tiled launch) or one segment of a longer row (an item
//   row runs to 67,310 edges, so no warp takes a whole long row).  A
//   segment writes its sum to a scratch row, which spmm_reduce_kernel adds
//   in order: the result does not depend on scheduling.  Blocks are
//   persistent, one an SM (512 threads, up to 128 registers); each takes
//   the items whose first edge lies in its share of the edges (kTile: its
//   tiles' items), and its warps take them one at a time from a counter in
//   shared memory.
// * A warp sums a row in groups of L lanes, each lane a 16-byte piece of the
//   row (L = k / 4 rounded up to a power of two: 16 at k = 64, so 2 edges at
//   once; 4 at k = 16, 8 edges at once).  Each lane loads one edge's column
//   and value, 32 edges a batch, coalesced, with streaming loads (so the
//   edge stream does not push the tables out of L2), and the next batch,
//   the next row's first across rows, is in flight while this one is summed;
//   the column and value reach the group by shuffles.  A group issues up to
//   16 row loads before it adds any.  The groups' sums meet by butterfly
//   shuffles in a fixed order and each output row is written once, by one
//   group, with no atomics.
// * k % 4 != 0 takes a scalar form of the same kernel (one float a lane, a
//   warp an edge); k above 128 (32 in the scalar form) runs as launches over
//   column slices.
//
// Contract (lkt_spmm_f32): rowptr (rows + 1) int64; src (nnz) int32, val
// (nnz) f32; the work items
// work_edge and work_row (n_work + 1) int64 and work_slot (n_work) int32
// (-1 for a run of whole rows, else the item's scratch row); row_slot
// (rows) int32 or null: each row's scratch row, else rows are written to
// out; with tiles > 0, tile_src (tiles + 1) int64, each tile's first source
// row, tile_item (tiles + 1) int64, its first work item, src counts from
// the tile's first row, staged is the most rows a tile and blocks the grid (the
// tiles split evenly over it); red_rows (n_red) and red_ptr (n_red + 1)
// int64: out[red_rows[j]] is the sum of scratch rows red_ptr[j] ..
// red_ptr[j + 1] - 1; partial (scratch rows x width) f32; x (n_src rows,
// ld ldx) f32 and out (ld ldo) f32, unit stride in a row.  vec 4 needs
// width, ldx and ldo multiples of 4 and x, out and partial 16-byte aligned,
// and width <= 128; vec 1 needs width <= 32.  staged * width * 4 bytes must
// fit the card's shared memory a block.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (ops/_build.py); the Python wrapper is ops/graph.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// where a launch's source rows come from
enum Mode { kPull = 0, kTile = 1 };

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T ldg(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ T lds(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ void fma(T& a, float v, const T& x) {
    a.x = fmaf(v, x.x, a.x);
    a.y = fmaf(v, x.y, a.y);
    a.z = fmaf(v, x.z, a.z);
    a.w = fmaf(v, x.w, a.w);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ T shfl_xor(const T& a, int m) {
    return make_float4(__shfl_xor_sync(kFull, a.x, m), __shfl_xor_sync(kFull, a.y, m), __shfl_xor_sync(kFull, a.z, m),
                       __shfl_xor_sync(kFull, a.w, m));
  }
  static __device__ __forceinline__ void st(float* p, const T& a) { *reinterpret_cast<float4*>(p) = a; }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T ldg(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T lds(const float* p) { return *p; }
  static __device__ __forceinline__ void fma(T& a, float v, const T& x) { a = fmaf(v, x, a); }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ T shfl_xor(const T& a, int m) { return __shfl_xor_sync(kFull, a, m); }
  static __device__ __forceinline__ void st(float* p, const T& a) { *p = a; }
};

struct Args {
  const long long* rowptr;
  const int* src;
  const float* val;
  long long nnz;
  const long long* work_edge;
  const long long* work_row;
  const int* work_slot;
  long long n_work;
  const int* row_slot;
  const long long* tile_src;
  const long long* tile_item;
  int tiles;
  float* partial;
  const float* x;
  long long ldx;
  int staged;
  float* out;
  long long ldo;
  int width;
};

// The first index i in [lo, hi) with a[i] >= t, or hi.
__device__ long long lower_bound(const long long* a, long long lo, long long hi, long long t) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One batch of 32 edges' columns and values from edge e, up to edge `end`.
__device__ __forceinline__ void load_batch(const Args& p, long long e, long long end, int lane, int& idx, float& v) {
  idx = 0;
  v = 0.f;
  if (e + lane < end) {
    idx = __ldcs(p.src + e + lane);
    v = __ldcs(p.val + e + lane);
  }
}

// Adds the edges [a, b) of one row to acc, their source rows from shared
// memory (STAGED) or through the read-only path.  On entry idx and v hold
// the batch from edge a; on return the batch from edge b, up to `end`, the
// end of the work item: the next batch is in flight while this one is
// summed, across rows too.
template <int VEC, int L, bool STAGED>
__device__ __forceinline__ void add_edges(const Args& p, const float* rows, long long a, long long b, long long end,
                                          int grp, int col, bool live, int lane, int& idx, float& v,
                                          typename Vec<VEC>::T& acc) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int E = 32 / L;      // edges a warp takes at once
  constexpr int STEPS = 32 / E;  // a batch's edges a group takes
  constexpr int CHUNK = 16;      // row loads a group issues before it adds them
  constexpr int CH = STEPS < CHUNK ? STEPS : CHUNK;
  for (long long e0 = a; e0 < b; e0 += 32) {
    const bool more = e0 + 32 < b;
    int idx_next;
    float v_next;
    load_batch(p, more ? e0 + 32 : b, more ? b : end, lane, idx_next, v_next);
    const int n = static_cast<int>(more ? 32 : b - e0);
#pragma unroll
    for (int s0 = 0; s0 < STEPS; s0 += CH) {
      T got[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = (s0 + c) * E + grp;
        const int id = __shfl_sync(kFull, idx, j);
        got[c] = V::zero();
        if (j < n && live) {
          got[c] = STAGED ? V::lds(rows + id * p.width + col * VEC)
                          : V::ldg(p.x + static_cast<long long>(id) * p.ldx + col * VEC);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = (s0 + c) * E + grp;
        const float w = __shfl_sync(kFull, v, j);
        if (j < n) V::fma(acc, w, got[c]);
      }
    }
    idx = idx_next;
    v = v_next;
  }
}

// The sum of the edges [a, b) of one row in the lanes of group 0 (the other
// groups' sums folded in, in a fixed order): in kTile from the tile's rows
// in shared memory, in kPull through the read-only path.
template <int VEC, int L, int MODE>
__device__ __forceinline__ typename Vec<VEC>::T row_sum(const Args& p, const float* rows, long long a, long long b,
                                                        long long end, int grp, int col, bool live, int lane, int& idx,
                                                        float& v) {
  using V = Vec<VEC>;
  typename V::T acc = V::zero();
  add_edges<VEC, L, MODE == kTile>(p, rows, a, b, end, grp, col, live, lane, idx, v, acc);
#pragma unroll
  for (int m = L; m < 32; m <<= 1) V::add(acc, V::shfl_xor(acc, m));
  return acc;
}

// Copies source rows into shared memory: slot s holds x[first + s], for s < count.
template <int VEC>
__device__ __forceinline__ void stage(const Args& p, float* rows, long long first, int count) {
  const int per_row = p.width / VEC;
  const int total = count * per_row;
  for (int q = threadIdx.x; q < total; q += kThreads) {
    const int r = q / per_row;
    const int c = q - r * per_row;
    const float* g = p.x + (first + r) * p.ldx + c * VEC;
    float* s = rows + r * p.width + c * VEC;
    if constexpr (VEC == 4) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(g) : "memory");
    } else {
      *s = __ldg(g);
    }
  }
  if constexpr (VEC == 4) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Work items [next, last) of the block, taken by its warps one at a time.
template <int VEC, int L, int MODE>
__device__ __forceinline__ void run_items(const Args& p, const float* rows, int* next, int last, int lane, int grp,
                                          int col, bool live) {
  using V = Vec<VEC>;
  using T = typename V::T;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(next, 1);
    i = __shfl_sync(kFull, i, 0);
    if (i >= last) break;
    const long long e_lo = p.work_edge[i], e_hi = p.work_edge[i + 1];
    const int slot = p.work_slot[i];
    int idx;
    float v;
    load_batch(p, e_lo, e_hi, lane, idx, v);
    if (slot >= 0) {
      // one segment of a long row, into its scratch row
      const T acc = row_sum<VEC, L, MODE>(p, rows, e_lo, e_hi, e_hi, grp, col, live, lane, idx, v);
      if (grp == 0 && live) V::st(p.partial + static_cast<long long>(slot) * p.width + col * VEC, acc);
    } else {
      // a run of whole rows, each row's end read a row ahead
      const long long r0 = p.work_row[i], r_end = p.work_row[i + 1];
      long long a = e_lo;
      long long b = r0 < r_end ? p.rowptr[r0 + 1] : 0;
      for (long long r = r0; r < r_end; ++r) {
        const long long b_next = r + 1 < r_end ? p.rowptr[r + 2] : 0;
        const T acc = row_sum<VEC, L, MODE>(p, rows, a, b, e_hi, grp, col, live, lane, idx, v);
        float* dst = p.row_slot ? p.partial + static_cast<long long>(p.row_slot[r]) * p.width : p.out + r * p.ldo;
        if (grp == 0 && live) V::st(dst + col * VEC, acc);
        a = b;
        b = b_next;
      }
    }
  }
}

template <int VEC, int L, int MODE>
__global__ void __launch_bounds__(kThreads, 1) spmm_kernel(Args p) {
  extern __shared__ __align__(16) float rows[];
  __shared__ int next;
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;
  const int col = lane % L;
  const bool live = col * VEC < p.width;

  if constexpr (MODE == kTile) {
    // this block's run of tiles, each staged whole, then its items summed
    const int t_end = static_cast<int>(static_cast<long long>(p.tiles) * (blockIdx.x + 1) / gridDim.x);
    for (int t = static_cast<int>(static_cast<long long>(p.tiles) * blockIdx.x / gridDim.x); t < t_end; ++t) {
      __syncthreads();  // the previous tile's rows are no longer read
      const long long first = p.tile_src[t];
      stage<VEC>(p, rows, first, static_cast<int>(p.tile_src[t + 1] - first));
      if (threadIdx.x == 0) {
        next = static_cast<int>(p.tile_item[t]);
        last = static_cast<int>(p.tile_item[t + 1]);
      }
      __syncthreads();
      run_items<VEC, L, MODE>(p, rows, &next, last, lane, grp, col, live);
    }
  } else {
    if (threadIdx.x == 0) {
      // this block's items: those whose first edge lies in its share of the edges
      next = static_cast<int>(lower_bound(p.work_edge, 0, p.n_work, p.nnz * blockIdx.x / gridDim.x));
      last = static_cast<int>(blockIdx.x + 1 == gridDim.x
                                  ? p.n_work
                                  : lower_bound(p.work_edge, 0, p.n_work, p.nnz * (blockIdx.x + 1) / gridDim.x));
    }
    __syncthreads();
    run_items<VEC, L, MODE>(p, rows, &next, last, lane, grp, col, live);
  }
}

// out[red_rows[j]] = the sum of the scratch rows red_ptr[j] .. red_ptr[j + 1] - 1, in order
// (four sums in flight, added at the end in a fixed order).
template <int VEC>
__global__ void __launch_bounds__(256) spmm_reduce_kernel(const float* __restrict__ partial, int width,
                                                         const long long* __restrict__ red_rows,
                                                         const long long* __restrict__ red_ptr, long long n_red,
                                                         float* __restrict__ out, long long ldo) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int per_row = width / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_red * per_row) return;
  const long long j = t / per_row;
  const int c = static_cast<int>(t - j * per_row);
  T acc[4] = {V::zero(), V::zero(), V::zero(), V::zero()};
  const long long s0 = red_ptr[j], s1 = red_ptr[j + 1];
  long long s = s0;
  for (; s + 4 <= s1; s += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) V::add(acc[q], V::ldg(partial + (s + q) * width + c * VEC));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (s + q < s1) V::add(acc[q], V::ldg(partial + (s + q) * width + c * VEC));
  }
  V::add(acc[0], acc[1]);
  V::add(acc[2], acc[3]);
  V::add(acc[0], acc[2]);
  V::st(out + red_rows[j] * ldo + c * VEC, acc[0]);
}

template <int VEC, int L, int MODE>
int launch_main(const Args& p, int blocks, cudaStream_t stream) {
  const size_t smem = MODE == kPull ? 0 : static_cast<size_t>(p.staged) * p.width * sizeof(float);
  auto kernel = spmm_kernel<VEC, L, MODE>;
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 0, max_smem = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  // the staged rows' shared memory, or else all of it as L1 for the gathered rows
  cudaError_t err = MODE == kPull
                        ? cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0)
                        : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks <= 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = sms * (per_sm < 1 ? 1 : per_sm);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int MODE>
int dispatch_lanes(const Args& p, int lanes, int blocks, cudaStream_t stream) {
  if constexpr (VEC == 1) {
    return launch_main<1, 32, MODE>(p, blocks, stream);
  } else {
    switch (lanes) {
      case 1:
        return launch_main<4, 1, MODE>(p, blocks, stream);
      case 2:
        return launch_main<4, 2, MODE>(p, blocks, stream);
      case 4:
        return launch_main<4, 4, MODE>(p, blocks, stream);
      case 8:
        return launch_main<4, 8, MODE>(p, blocks, stream);
      case 16:
        return launch_main<4, 16, MODE>(p, blocks, stream);
      default:
        return launch_main<4, 32, MODE>(p, blocks, stream);
    }
  }
}

template <int VEC>
int dispatch_mode(const Args& p, int lanes, int blocks, cudaStream_t stream) {
  if (p.tiles > 0) return dispatch_lanes<VEC, kTile>(p, lanes, blocks, stream);
  return dispatch_lanes<VEC, kPull>(p, lanes, blocks, stream);
}

}  // namespace

// out = A @ x for one part of one orientation of the adjacency (see the head
// of this file): tiles > 0 stages each tile's source rows (`staged` rows at
// most a tile); blocks > 0 fixes the grid (else as many as fit).  Returns a
// CUDA error code (0 when the launches were accepted).
extern "C" int lkt_spmm_f32(const long long* rowptr, const int* src, const float* val, long long nnz,
                            const long long* work_edge, const long long* work_row, const int* work_slot, long long n_work,
                            const int* row_slot, const long long* tile_src, const long long* tile_item, int tiles,
                            const long long* red_rows, const long long* red_ptr, long long n_red, float* partial,
                            const float* x, long long ldx, int staged, float* out, long long ldo, int width, int vec,
                            int blocks, void* stream) {
  if (n_work < 1 || n_work > 0x7ffffff0LL || width < 1 || tiles < 0 ||
      (tiles > 0 && (tile_src == nullptr || tile_item == nullptr || blocks < 1 || staged < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16 == 0; };
  if (vec == 4) {
    if (width > 128 || width % 4 || ldx % 4 || ldo % 4 || !aligned(x) || !aligned(out) || (n_red > 0 && !aligned(partial))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (vec != 1 || width > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{rowptr, src,   val,     nnz, work_edge, work_row, work_slot, n_work, row_slot,
               tile_src, tile_item, tiles, partial, x, ldx, staged, out, ldo, width};
  const auto s = static_cast<cudaStream_t>(stream);
  int lanes = 32;
  if (vec == 4) {
    lanes = 1;
    while (lanes * 4 < width) lanes <<= 1;
  }
  const int err = vec == 4 ? dispatch_mode<4>(p, lanes, blocks, s) : dispatch_mode<1>(p, lanes, blocks, s);
  if (err != 0 || n_red == 0) return err;
  const long long threads = n_red * (width / vec);
  const long long grid = (threads + 255) / 256;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) {
    spmm_reduce_kernel<4><<<static_cast<unsigned>(grid), 256, 0, s>>>(partial, width, red_rows, red_ptr, n_red, out, ldo);
  } else {
    spmm_reduce_kernel<1><<<static_cast<unsigned>(grid), 256, 0, s>>>(partial, width, red_rows, red_ptr, n_red, out, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}
