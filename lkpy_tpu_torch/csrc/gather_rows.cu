// Row gather, out[m, :] = table[idx[m], :], for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/probe_gather.py::make_pallas.f (the
// bodies _dma_kernel, one async DMA a row with 8 in flight, and
// _vmem_rowcopy_kernel, one dynamic-slice copy a row from a VMEM-resident
// table).  On the port's path it is the ALS factor gather G = right[cols]
// (ops/als.py::_gather): every training chunk of both epoch modes and every
// fold-in block of serving.
//
// Contract: table is (n, K) f32 whose rows lie ld >= K floats apart with
// unit stride inside a row; idx is M int32 or int64 row numbers, each in
// [0, n); out is (M, K) f32, contiguous.  Any K >= 1.  The result is a copy:
// bit-equal to table.index_select(0, idx).  An index outside [0, n) is a
// device assertion, as for index_select.
//
// Bound: the function must write M*K*4 bytes, read M index entries and read
// each table row it touches once.  At the implicit epoch's user half, chunk
// (30024, 120) against the (27000, 64) item table, that is 922 MB written
// and 14 MB read: 0.28 ms at 3.35 TB/s.  Nothing is computed, so the bound
// is bytes, and nearly all of them are the output's.
//
// Design.  A thread moves one vector of a row: 16 bytes when K % 4 == 0 and
// the table, its row stride and the output are 16-byte aligned, else 8
// bytes, else 4.  The output is contiguous, so the rows x vectors of the
// gather are one flat run of output vectors, and a warp walks it a tile at a
// time: R consecutive rows (tile_rows: at least four vectors a lane, a whole
// number of warps where it can), its lanes on consecutive vectors, so every
// lane works whatever the row width and each store instruction of a warp
// writes 128 to 512 contiguous bytes.  A lane finds its row within the tile
// by a multiply-high with a constant the host works out (j / vpr, exact for
// the tile's small j), the vector in the row by the remainder.  Warps take
// tiles grid-stride, one wave of blocks; a lane loads four rows' indices and
// vectors before its first store, so four independent loads are in flight.
// The table is read through the read-only path (__ldg: the tables of the
// path, 7 to 35 MB, stay in the 50 MB L2 across a chunk) and the output is
// written with streaming stores (__stcs), since it is far larger than L2 and
// is read back only by the next kernel.  Offsets are 64-bit: a training
// chunk's output is up to 4M rows of 64 floats (1 GB).
//
// Plain C interface, built with nvcc and loaded with ctypes
// (ops/_build.py); the Python wrapper is ops/gather_rows.py.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

template <int W, typename Index>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(const float* __restrict__ table, long long ld,
                                                               long long n, const Index* __restrict__ idx,
                                                               float* __restrict__ out, long long M, int K, int R,
                                                               unsigned magic) {
  using T = typename Vec<W>::T;
  const int vpr = K / W;     // vectors a row
  const int span = R * vpr;  // vectors a tile of R rows
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const long long tiles = (M + R - 1) / R;
  T* const dst = reinterpret_cast<T*>(out);

  for (long long tile = warp; tile < tiles; tile += warps) {
    const long long row0 = tile * R;
    const long long vec0 = row0 * vpr;  // the output is contiguous: a tile's vectors follow one another
    for (int j0 = lane; j0 < span; j0 += 32 * kUnroll) {
      const T* src[kUnroll];
      long long at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 32 * u;
        // j / vpr by a multiply-high (exact: j * vpr < 2^32 for every tile the host sets up)
        const int local = R == 1 ? 0 : (vpr == 1 ? j : static_cast<int>(__umulhi(static_cast<unsigned>(j), magic)));
        const long long row = row0 + local;
        src[u] = nullptr;
        at[u] = vec0 + j;
        if (j < span && row < M) {
          const long long r = static_cast<long long>(__ldg(idx + row));
          assert(r >= 0 && r < n);
          src[u] = reinterpret_cast<const T*>(table + r * ld) + (j - local * vpr);
        }
      }
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (src[u] != nullptr) v[u] = __ldg(src[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (src[u] != nullptr) __stcs(dst + at[u], v[u]);
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
                                                   cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

// Rows a warp's tile: at least 128 vectors (four a lane), rounded up to fill
// whole warps where a multiple of 32 vectors is at most 256 rows away; rows of
// 128 vectors or more make a tile each.
int tile_rows(int vpr) {
  if (vpr >= 128) return 1;
  const int least = (128 + vpr - 1) / vpr;
  for (int r = least; r <= 256; ++r) {
    if ((r * vpr) % 32 == 0) return r;
  }
  return least;
}

template <int W, typename Index>
int launch(const float* table, long long ld, long long n, const void* idx, float* out, long long M, int K,
           cudaStream_t stream) {
  const int vpr = K / W;
  const int R = tile_rows(vpr);
  // floor(2^32 / vpr) + 1: j / vpr == umulhi(j, magic) while j * vpr < 2^32,
  // and a tile of R > 1 rows holds fewer than 256 * 128 vectors of fewer than 128
  const unsigned magic = vpr > 1 ? static_cast<unsigned>((1ull << 32) / static_cast<unsigned long long>(vpr) + 1) : 0u;
  const long long tiles = (M + R - 1) / R;
  // one wave: as many blocks as the SMs hold at once (registers set it)
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_kernel<W, Index>, kThreads, 0) != cudaSuccess) {
    per_sm = 4;
  }
  const long long cap = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  long long blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<W, Index><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, ld, n, static_cast<const Index*>(idx), out, M, K, R, magic);
  return static_cast<int>(cudaGetLastError());
}

// The vector width in floats a launch takes: 4 when K % 4 == 0 and the
// table, its row stride and the output are 16-byte aligned, else 2 when they
// are 8-byte aligned, else 1.
int vector_width(const float* table, long long ld, const float* out, int K) {
  const auto t = reinterpret_cast<std::uintptr_t>(table);
  const auto o = reinterpret_cast<std::uintptr_t>(out);
  if (K % 4 == 0 && ld % 4 == 0 && t % 16 == 0 && o % 16 == 0) return 4;
  if (K % 2 == 0 && ld % 2 == 0 && t % 8 == 0 && o % 8 == 0) return 2;
  return 1;
}

template <typename Index>
int dispatch_width(const float* table, long long ld, long long n, const void* idx, float* out, long long M, int K,
                   cudaStream_t stream) {
  switch (vector_width(table, ld, out, K)) {
    case 4:
      return launch<4, Index>(table, ld, n, idx, out, M, K, stream);
    case 2:
      return launch<2, Index>(table, ld, n, idx, out, M, K, stream);
    default:
      return launch<1, Index>(table, ld, n, idx, out, M, K, stream);
  }
}

}  // namespace

// out (M, K) = table[idx]; idx_bytes is 4 (int32) or 8 (int64).  Returns a
// CUDA error code (0 when the launch was accepted).
extern "C" int lkt_gather_rows_f32(const float* table, long long ld, long long n, const void* idx, int idx_bytes,
                                   float* out, long long M, int K, void* stream) {
  if (M <= 0 || K < 1 || ld < K || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) return dispatch_width<int>(table, ld, n, idx, out, M, K, s);
  if (idx_bytes == 8) return dispatch_width<long long>(table, ld, n, idx, out, M, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The vector width in floats (4, 2 or 1) a launch with these pointers and
// widths takes.
extern "C" int lkt_gather_rows_width(const float* table, long long ld, const float* out, int K) {
  return vector_width(table, ld, out, K);
}
