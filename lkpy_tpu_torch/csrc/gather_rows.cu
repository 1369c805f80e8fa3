// Row gather, out[m, :] = table[idx[m], :], for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/probe_gather.py::make_pallas.f (the
// bodies _dma_kernel, one async DMA a row with 8 in flight, and
// _vmem_rowcopy_kernel, one dynamic-slice copy a row from a VMEM-resident
// table).  On the port's path it gathers the rows themselves where they are
// wanted: the candidates' item rows of a per-query scorer call
// (models/als.py::ALSBase.__call__).  Where the rows only feed the ALS normal
// equations, csrc/gather_gram.cu gathers them into shared memory instead.
//
// Contract: table is (n, K) f32 whose rows lie ld >= K floats apart with
// unit stride inside a row; idx is M int32 or int64 row numbers, each in
// [0, n); out is (M, K) f32, contiguous and 16-byte aligned.  Any K >= 1.
// The result is a copy: bit-equal to table.index_select(0, idx).  An index
// outside [0, n) is a device assertion, as for index_select.
//
// Bound: the function must write M*K*4 bytes, read M index entries and read
// each table row it touches once.  At the runner's candidates, 26,897 rows
// of the (27,000, 64) item table, that is 6.9 MB written and 7.0 MB read:
// 4.1 us at 3.35 TB/s.  Nothing is computed, so bytes bound it.
//
// Design.  The output is contiguous, so the gather is one flat run of
// 16-byte output units, and a thread takes D of them (a block of 256
// threads 256 * D consecutive units, its lanes on consecutive units, so a
// warp's store writes 512 contiguous bytes).  A unit's four floats come from
// one row when K % 4 == 0, else they may straddle two (K = 50: the 49th and
// 50th floats of one row, the first two of the next); the loads take 16, 8
// or 4 bytes as the table, its row stride and K allow, so an 8-byte table
// still writes whole 16-byte units.  A thread loads all its units' row
// numbers, then all their table vectors, then stores: 4/W * D loads in
// flight a thread.  The unit's row is a 32-bit division (64-bit only for an
// output of 2^32 floats or more).  The grid covers the output once (no
// grid-stride loop), so a small gather starts all its loads in one step; D
// is 1 up to 2^20 units (16 MB), then 4.  Eight units a thread were no
// faster, not even where the table is larger than L2 and its rows come from
// device memory.  The table is read through the read-only path (__ldg); an
// output larger than 32 MB is written with streaming stores (__stcs), a
// smaller one stays in L2 for the product that reads it next.
//
// The first design walked tiles of rows a warp at a time, in one wave of
// blocks from the occupancy query, four vectors in flight a lane: at K = 50
// a tile was 32 rows, so 26,897 rows made only 841 warps, and a 64-bit
// division opened every launch.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (ops/_build.py); the Python wrapper is ops/gather_rows.py.

#include <cassert>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kShallowUnits = 1LL << 20;
constexpr long long kStreamBytes = 32LL << 20;

template <int W>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// One unit: the four floats out[4u .. 4u + 3], as (row, column) pairs of
// W-float vectors.  Off is the offset type (32 or 64 bits).
template <int W, typename Off>
struct Unit {
  static constexpr int kSubs = 4 / W;
  Off row[kSubs];
  int col[kSubs];

  __device__ __forceinline__ Unit(Off u, int K, int vpr4) {
    if constexpr (W == 4) {
      row[0] = u / static_cast<Off>(vpr4);
      col[0] = static_cast<int>(u - row[0] * static_cast<Off>(vpr4)) * 4;
    } else {
      const Off f = u * 4;
      Off r = f / static_cast<Off>(K);
      int c = static_cast<int>(f - r * static_cast<Off>(K));
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        if (c >= K) c -= K, ++r;  // the unit runs into the next row (K >= W)
        row[s] = r;
        col[s] = c;
        c += W;
      }
    }
  }
};

template <int W, int D, bool Wide, typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ table, long long ld, long long n, const Index* __restrict__ idx,
                       float* __restrict__ out, long long units, int tail, int K, int vpr4, bool stream) {
  using Off = std::conditional_t<Wide, unsigned long long, unsigned>;
  using T = typename Vec<W>::T;
  constexpr int kSubs = 4 / W;
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * D) + threadIdx.x;

  long long r[D][kSubs];
  int col[D][kSubs];
  bool live[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const long long u = first + static_cast<long long>(d) * kThreads;
    live[d] = u < units;
    const Unit<W, Off> at(static_cast<Off>(live[d] ? u : 0), K, vpr4);
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      r[d][s] = live[d] ? static_cast<long long>(__ldg(idx + at.row[s])) : 0;
      col[d][s] = at.col[s];
    }
  }
  bool bad = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int s = 0; s < kSubs; ++s) bad |= r[d][s] < 0 || r[d][s] >= n;
  }
  assert(!bad);
  float4 v[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (!live[d]) continue;
    if constexpr (W == 4) {
      v[d] = __ldg(reinterpret_cast<const float4*>(table + r[d][0] * ld + col[d][0]));
    } else {
      float e[4];
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        const T x = __ldg(reinterpret_cast<const T*>(table + r[d][s] * ld + col[d][s]));
        if constexpr (W == 2) {
          e[2 * s] = x.x, e[2 * s + 1] = x.y;
        } else {
          e[s] = x;
        }
      }
      v[d] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  float4* const dst = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (!live[d]) continue;
    const long long u = first + static_cast<long long>(d) * kThreads;
    if (stream) {
      __stcs(dst + u, v[d]);
    } else {
      dst[u] = v[d];
    }
  }
  // the last M*K % 4 floats, one a thread: the threads past the last unit
  // where a thread takes one unit (the launch covers them), else the first
  // block's, after their units
  const long long t = D == 1 ? first - units : (blockIdx.x == 0 ? static_cast<long long>(threadIdx.x) : -1LL);
  if (t >= 0 && t < tail) {
    const long long f = units * 4 + t;
    const long long row = f / K;
    const long long rr = static_cast<long long>(__ldg(idx + row));
    assert(rr >= 0 && rr < n);
    out[f] = __ldg(table + rr * ld + (f - row * K));
  }
}

template <int W, int D, bool Wide, typename Index>
int launch(const float* table, long long ld, long long n, const void* idx, float* out, long long M, int K,
           cudaStream_t stream) {
  const long long floats = M * K;
  const long long units = floats / 4;
  const int tail = static_cast<int>(floats - units * 4);
  const long long per_block = static_cast<long long>(kThreads) * D;
  long long blocks = (units + (D == 1 ? tail : 0) + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool streaming = floats * 4 > kStreamBytes;
  gather_rows_kernel<W, D, Wide, Index><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, ld, n, static_cast<const Index*>(idx), out, units, tail, K, K / 4, streaming);
  return static_cast<int>(cudaGetLastError());
}

// The load width in floats: 4 when K % 4 == 0 and the table and its row
// stride are 16-byte aligned, else 2 when they are 8-byte aligned, else 1.
int vector_width(const float* table, long long ld, int K) {
  const auto t = reinterpret_cast<std::uintptr_t>(table);
  if (K % 4 == 0 && ld % 4 == 0 && t % 16 == 0) return 4;
  if (K % 2 == 0 && ld % 2 == 0 && t % 8 == 0) return 2;
  return 1;
}

// Units a thread: 1 up to kShallowUnits units, else 4.
int depth_for(long long units) { return units <= kShallowUnits ? 1 : 4; }

template <int W, typename Index>
int dispatch_depth(const float* table, long long ld, long long n, const void* idx, float* out, long long M, int K,
                   int depth, cudaStream_t stream) {
  if (M * K >= (1LL << 32)) return launch<W, 4, true, Index>(table, ld, n, idx, out, M, K, stream);
  switch (depth) {
    case 1:
      return launch<W, 1, false, Index>(table, ld, n, idx, out, M, K, stream);
    case 4:
      return launch<W, 4, false, Index>(table, ld, n, idx, out, M, K, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Index>
int dispatch_width(const float* table, long long ld, long long n, const void* idx, float* out, long long M, int K,
                   int depth, cudaStream_t stream) {
  switch (vector_width(table, ld, K)) {
    case 4:
      return dispatch_depth<4, Index>(table, ld, n, idx, out, M, K, depth, stream);
    case 2:
      return dispatch_depth<2, Index>(table, ld, n, idx, out, M, K, depth, stream);
    default:
      return dispatch_depth<1, Index>(table, ld, n, idx, out, M, K, depth, stream);
  }
}

}  // namespace

// out (M, K) = table[idx]; idx_bytes is 4 (int32) or 8 (int64); depth is the
// units a thread (1 or 4), or 0 for the kernel's own choice.  Returns a
// CUDA error code (0 when the launch was accepted).
extern "C" int lkt_gather_rows_f32(const float* table, long long ld, long long n, const void* idx, int idx_bytes,
                                   float* out, long long M, int K, int depth, void* stream) {
  if (M <= 0 || K < 1 || ld < K || n < 1 || reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (depth == 0) depth = depth_for(M * K / 4);
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) return dispatch_width<int>(table, ld, n, idx, out, M, K, depth, s);
  if (idx_bytes == 8) return dispatch_width<long long>(table, ld, n, idx, out, M, K, depth, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The load width in floats (4, 2 or 1) a launch with this table takes (out
// must be 16-byte aligned for any launch).
extern "C" int lkt_gather_rows_width(const float* table, long long ld, const float* out, int K) {
  (void)out;
  return vector_width(table, ld, K);
}

// The units a thread (1 or 4) a launch of M rows of K floats takes when not
// told.
extern "C" int lkt_gather_rows_depth(long long M, int K) { return depth_for(M * K / 4); }
