// The blocked route of the batched small SPD solve, x[b] = A[b]^-1 y[b], for
// 1 <= k <= 256, shared by the training solve (spd_solve_chunked.cu) and the
// fold-in solve (spd_solve.cu).  Each of the two sources wraps solve_system
// in a __global__ kernel of its own name; the arithmetic, the loads and the
// layout are the same.
//
// Why it exists.  At k = 256 a system's lower triangle is 131,584 bytes: one
// system a block, one block an SM.  The kernels' first form walked it with one
// warp (the training solve) or one block (the fold-in solve) through 256
// column steps, each multiply-subtract of the trailing update costing three
// shared loads, a store and a walk of the packed index; 538x its bound at
// (29936, 256) on an H100.  Here the k^3/6 multiply-adds of the trailing
// update run as a rank-32 update of 32 x 32 tiles by register micro-tiles,
// and the k dependent pivots stay on one warp, in registers.
//
// Layout (dynamic shared memory, one system a block, NT threads):
//   tiles  the lower triangle padded to KP = 32 * ceil(k / 32) rows, as
//          T(T+1)/2 tiles of 32 x 32 (T = KP / 32), tile (I, J) at
//          I(I+1)/2 + J; 147,456 bytes at k = 256.  Row r of a tile holds its
//          eight 16-byte chunks in the order g ^ (r & 7), so a warp whose
//          lanes read eight rows at one chunk, or one row each, meets no bank
//          conflict.  Rows and columns k..KP-1 are an identity block (the
//          padding lives in shared memory only).  A factored diagonal tile
//          holds L below and on its diagonal and L^T above it, until the
//          back substitution puts the transpose of its inverse there.
//   P      the current panel below its diagonal block, transposed:
//          P[q * (KP - 32) + i] = L[32(p+1) + i][32p + q]; the operands of the
//          trailing update, read as 16-byte vectors along i.
//   z      y, turned into w = L^-1 y by the factorisation (it rides along as
//          a bordered row of the panel solves), then into x.
//   dinv   1 / L[i][i].
//   red    the back substitution's partial sums, 32 a warp.
// 180,224 bytes at k = 256 over 512 threads, so a block fills an SM's shared
// memory; 109,056 at k = 192 over 256 threads, so two blocks share an SM.
//
// A panel p (columns 32p .. 32p+31):
//   1. warp 0 factors the diagonal tile in registers, lane r holding row r:
//      32 steps, each a reciprocal square root of the pivot (the hardware's
//      approximation and one Newton step) and a rank-1 update of the lanes'
//      rows with the column passed by shuffles; the lane of the next pivot
//      takes it out of its own entry first, so the chain from pivot to pivot
//      is a shuffle, the square root, a multiply and one fmaf;
//   2. the rows below it are solved against it, one row a thread, and z's
//      panel rows by one more thread (the forward substitution), each row
//      written back to its tile and transposed into P;
//   3. the trailing triangle takes one rank-32 update, L22 -= L21 L21^T: each
//      half of each tile is a warp's job, 4 x 4 a lane, two 16-byte loads of P
//      feeding 16 fmaf; z's rows below take z -= L21 w_p at the same time.
//      The next diagonal tile's two halves go first, to warp 0 and a partner
//      (warp 4 where a block holds an SM, on warp 0's scheduler, whose other
//      warps take no update jobs; else warp 1), which then meet at a barrier
//      of their own, and warp 0 factors that tile (step 1 of the next panel)
//      while the other warps update the rest, so a panel costs two
//      block-wide barriers.
// Then each diagonal tile is inverted, a warp a tile (lane c solves L x = e_c
// and keeps x as row c), and the back substitution with L^T runs a panel at
// a time from the last: the warps sum the rows below the panel against x,
// then warp 0 multiplies by the inverted tile, with no dependent steps.
//
// On an H100 (700 W) a k = 256 system takes about 124,000 cycles on its SM
// (0.063 ms; one SM's f32 rate would take 11.3 us): 40 % the trailing
// updates, 34 % the panel solves with the rest of the load, 8 % the load's
// start (scripts/spd_blocked_probe.py --clocks); (29936, 256) takes 14.2 ms,
// 5.6x its operations bound.
//
// Arithmetic: a reciprocal square root of each pivot and fmaf, so the route
// agrees with the plain versions (ops/spd_solve.py::spd_solve_plain, and
// spd_solve_blocked_plain, which walks this panel order) to rounding, not to
// the bit.  A pivot that is not positive gives a NaN reciprocal, which then
// fills that system's x and no other: a block holds one system.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lkt_blk {

constexpr int NB = 32;            // the tile's width and a panel's
constexpr int TILE = NB * NB;     // floats a tile
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;
// shared memory a Hopper block may use after opting in (227 KB)
constexpr int MAX_SMEM = 232448;

// Phase clocks of a measurement build (scripts/spd_blocked_clocks.cu defines
// LKT_BLK_CLOCKS): after each block-wide barrier, thread 0 of block 0 adds
// the cycles since the last mark to its phase's slot.  Without the macro the
// marks are empty.
#ifdef LKT_BLK_CLOCKS
__device__ unsigned long long lkt_blk_clocks[8];
#define LKT_BLK_CLOCK_START long long lkt_blk_t = clock64()
#define LKT_BLK_MARK(slot)                                                                         \
  do {                                                                                             \
    const long long lkt_blk_now = clock64();                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) lkt_blk_clocks[slot] += lkt_blk_now - lkt_blk_t;      \
    lkt_blk_t = lkt_blk_now;                                                                       \
  } while (0)
#else
#define LKT_BLK_CLOCK_START
#define LKT_BLK_MARK(slot)
#endif
enum Phase { LOAD, FIRST_FACTOR, PANEL_SOLVE, UPDATE, INVERSES, BACK_SUMS, BACK_SOLVE, WRITE };

__host__ __device__ constexpr int tiles_of(int t) { return t * (t + 1) / 2; }

__host__ __device__ constexpr int tile_index(int I, int J) { return I * (I + 1) / 2 + J; }

// Floats of dynamic shared memory a block of `nt` threads takes at width k.
__host__ __device__ constexpr int smem_floats(int k, int nt) {
  return tiles_of((k + NB - 1) / NB) * TILE + NB * ((k + NB - 1) / NB * NB - NB) + 2 * ((k + NB - 1) / NB * NB) + nt;
}

// the offset of chunk g (columns 4g..4g+3) of row r in a tile
__device__ __forceinline__ int chunk_at(int r, int g) { return r * NB + ((g ^ (r & 7)) << 2); }

// the offset of entry (r, c) in a tile
__device__ __forceinline__ int entry_at(int r, int c) { return chunk_at(r, c >> 2) + (c & 3); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1/sqrt(p): the hardware's approximation and one Newton step; NaN for a
// pivot that is not positive
__device__ __forceinline__ float pivot_rsqrt(float p) {
  float r = rsqrtf(p);
  r = fmaf(0.5f * r, fmaf(-p * r, r, 1.f), r);
  return p > 0.f ? r : __int_as_float(0x7fc00000);
}

__device__ __forceinline__ void put4(float* v, float4 t) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Chunk (r, g) of tile (I, J) of system Ab into dst: the entries of row i =
// 32I + r, columns c = 32J + 4g .. +3, that lie in the lower triangle of the
// k x k system, by cp.async (16 bytes where every row starts on a 16-byte
// boundary); entries above the diagonal and the padding are zero, the
// padding's diagonal one.
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ Ab, int k, bool vec4, int I, int J, int r,
                                           int g) {
  const int i = I * NB + r;
  const int c = J * NB + 4 * g;
  const int n = i < k ? min(4, max(0, i - c + 1)) : 0;
  if (n > 0) {
    const float* src = Ab + static_cast<size_t>(i) * k + c;
    if (vec4) {
      cp_async16(dst, src, 4 * n);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async4(dst + u, u < n ? src + u : src, u < n ? 4 : 0);
    }
  } else {
    const int d = i - c;  // the padding's diagonal entry, where i >= k
    const bool one = i >= k;
    *reinterpret_cast<float4*>(dst) = make_float4(one && d == 0 ? 1.f : 0.f, one && d == 1 ? 1.f : 0.f,
                                                  one && d == 2 ? 1.f : 0.f, one && d == 3 ? 1.f : 0.f);
  }
}

// The lower triangle of system Ab into the tiles, in two cp.async groups:
// the tiles of column 0 first (panel 0 needs nothing else), then the rest.
// A tile is 256 chunks of 16 bytes and NT a multiple of 256, so a thread
// keeps one chunk (r, g) of every (NT / 256)-th tile.  z takes y and zeros.
template <int NT>
__device__ __forceinline__ void load_system(float* tiles, float* z, const float* __restrict__ Ab,
                                            const float* __restrict__ yb, int k, int T, bool vec4, int tid) {
  static_assert(NT % 256 == 0, "a thread a chunk of a tile");
  const int r = (tid >> 3) & (NB - 1);
  const int g = tid & 7;
  const int off = chunk_at(r, g);
  for (int I = tid >> 8; I < T; I += NT / 256) load_chunk(tiles + tile_index(I, 0) * TILE + off, Ab, k, vec4, I, 0, r, g);
  cp_async_commit();
  // the tiles (I, J), 1 <= J <= I, in the order of a triangle of T - 1 rows
  for (int s = tid >> 8; s < tiles_of(T - 1); s += NT / 256) {
    int I = 0;
    while (tiles_of(I + 1) <= s) ++I;
    const int J = s - tiles_of(I) + 1;
    ++I;
    load_chunk(tiles + tile_index(I, J) * TILE + off, Ab, k, vec4, I, J, r, g);
  }
  cp_async_commit();
  for (int i = tid; i < T * NB; i += NT) z[i] = i < k ? __ldg(yb + i) : 0.f;
}

// Warp 0: the diagonal tile D of a panel (updated by the panels before it),
// lane r holding row r: 32 elimination steps.  L goes back below and on the
// diagonal, L^T above it, 1 / L[j][j] to dinv.
__device__ __forceinline__ void factor_diagonal(float* D, float* dinv, int lane) {
  float v[NB];
#pragma unroll
  for (int g = 0; g < NB / 4; ++g) put4(v + 4 * g, *reinterpret_cast<const float4*>(D + chunk_at(lane, g)));
  // lanes r > j hold L[r][j] after step j, lane j the diagonal; the entries a
  // lane holds above its diagonal are never read.  Lane j+1 takes its next
  // pivot out of its own l before the column goes round, so the chain from
  // one pivot to the next is a shuffle, the reciprocal square root, a
  // multiply and one fmaf.
  float pivot = v[0];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float inv = pivot_rsqrt(__shfl_sync(FULL, pivot, j));
    const float l = v[j] * inv;
    v[j] = l;
    if (j + 1 < NB) pivot = fmaf(-l, l, v[j + 1]);
#pragma unroll
    for (int c = j + 1; c < NB; ++c) v[c] = fmaf(-l, __shfl_sync(FULL, l, c), v[c]);
    if (lane == j) dinv[j] = inv;
  }
#pragma unroll
  for (int g = 0; g < NB / 4; ++g)
    *reinterpret_cast<float4*>(D + chunk_at(lane, g)) = make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
  __syncwarp();
  // row `lane` below the diagonal becomes column `lane` above it
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < lane) D[entry_at(c, lane)] = v[c];
  }
}

// The 32 entries a[] of a row solved against the factored diagonal tile D:
// x_c = a_c / L[c][c], then a_c' -= x_c L[c'][c] for c' > c (column c below
// the diagonal is row c of D's upper triangle); x replaces a.
__device__ __forceinline__ void solve_row(float (&a)[NB], const float* D, const float* dinv) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const float xc = a[c] * dinv[c];
    a[c] = xc;
#pragma unroll
    for (int g = (c + 1) / 4; g < NB / 4; ++g) {
      const float4 l = *reinterpret_cast<const float4*>(D + chunk_at(c, g));
      if (4 * g + 0 > c) a[4 * g + 0] = fmaf(-xc, l.x, a[4 * g + 0]);
      if (4 * g + 1 > c) a[4 * g + 1] = fmaf(-xc, l.y, a[4 * g + 1]);
      if (4 * g + 2 > c) a[4 * g + 2] = fmaf(-xc, l.z, a[4 * g + 2]);
      if (4 * g + 3 > c) a[4 * g + 3] = fmaf(-xc, l.w, a[4 * g + 3]);
    }
  }
}

// A warp: the factored diagonal tile D becomes the transpose of L's inverse,
// lane c solving L x = e_c and keeping x (column c of the inverse) as row c.
__device__ __forceinline__ void invert_diagonal(float* D, const float* dinv, int lane) {
  float a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = c == lane ? 1.f : 0.f;
  solve_row(a, D, dinv);
  __syncwarp();
#pragma unroll
  for (int g = 0; g < NB / 4; ++g)
    *reinterpret_cast<float4*>(D + chunk_at(lane, g)) = make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
}

// One row of the panel (32 entries at `row`, chunks ordered by the mask sw)
// solved against the factored diagonal tile D (solve_row); the row goes back
// in place and, where `pt` is given, transposed into P.
__device__ __forceinline__ void solve_panel_row(float* row, int sw, const float* D, const float* dinv, float* pt, int ldp) {
  float a[NB];
#pragma unroll
  for (int g = 0; g < NB / 4; ++g) put4(a + 4 * g, *reinterpret_cast<const float4*>(row + ((g ^ sw) << 2)));
  solve_row(a, D, dinv);
#pragma unroll
  for (int g = 0; g < NB / 4; ++g)
    *reinterpret_cast<float4*>(row + ((g ^ sw) << 2)) = make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
  if (pt != nullptr) {
#pragma unroll
    for (int c = 0; c < NB; ++c) pt[c * ldp] = a[c];
  }
}

// One warp's job of the trailing update: half h of tile C, whose rows are P's
// rows ro.. and columns P's rows co..; lane (tr, tc) takes rows
// 16h + 4tr .. +3 and columns 4tc .. +3.
__device__ __forceinline__ void update_half_tile(float* C, const float* P, int ldp, int ro, int co, int h, int lane) {
  const int tr = lane >> 3;
  const int tc = lane & 7;
  const int r0 = 16 * h + 4 * tr;
  const float* pa = P + ro + r0;
  const float* pb = P + co + 4 * tc;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const float4 a4 = *reinterpret_cast<const float4*>(pa + q * ldp);
    const float4 b4 = *reinterpret_cast<const float4*>(pb + q * ldp);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* cp = reinterpret_cast<float4*>(C + chunk_at(r0 + i, tc));
    float4 c = *cp;
    c.x -= acc[i][0];
    c.y -= acc[i][1];
    c.z -= acc[i][2];
    c.w -= acc[i][3];
    *cp = c;
  }
}

// The whole solve of system blockIdx.x; the body of a kernel launched with NT
// threads a block, one block a system and smem_floats(k, NT) floats of
// dynamic shared memory.
template <int NT>
__device__ __forceinline__ void solve_system(const float* __restrict__ A, const float* __restrict__ y,
                                             float* __restrict__ x, int k, bool vec4) {
  static_assert(NT % 32 == 0 && NT >= MAX_K, "a thread for each row below a panel, and one for z");
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) float lkt_blk_smem[];
  const int T = (k + NB - 1) / NB;
  const int KP = T * NB;
  const int ldp = KP - NB;
  float* tiles = lkt_blk_smem;
  float* P = tiles + tiles_of(T) * TILE;
  float* z = P + NB * ldp;
  float* dinv = z + KP;
  float* red = dinv + KP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  LKT_BLK_CLOCK_START;

  load_system<NT>(tiles, z, A + b * k * k, y + b * k, k, T, vec4, tid);
  cp_async_wait<1>();  // the tiles of column 0
  __syncthreads();
  LKT_BLK_MARK(LOAD);

  // p = -1 factors the first diagonal tile alone; panel p solves its rows,
  // then updates the trailing triangle while warp 0 factors the next diagonal
  for (int p = -1; p < T; ++p) {
    const int m = KP - (p + 1) * NB;  // rows below the panel
    if (p >= 0) {
      const float* D = tiles + tile_index(p, p) * TILE;
      if (tid < m) {
        const int i = (p + 1) * NB + tid;
        solve_panel_row(tiles + tile_index(i / NB, p) * TILE + (i % NB) * NB, i & 7, D, dinv + p * NB, P + tid, ldp);
      } else if (tid == m) {
        solve_panel_row(z + p * NB, 0, D, dinv + p * NB, nullptr, ldp);
      }
      cp_async_wait<0>();
      __syncthreads();
      LKT_BLK_MARK(PANEL_SOLVE);
    }
    if (m == 0) break;
    // the next diagonal tile: warp 0 and its partner take the two halves of
    // this panel's update of it and meet at a barrier of their own, then warp
    // 0 factors it while the other warps update the rest.  Where a block holds
    // an SM (512 threads) the partner is warp 4, on warp 0's scheduler, which
    // the job warps leave to it; else warp 1.
    constexpr bool SPARE_SCHEDULER = NT == 512;
    constexpr int PARTNER = SPARE_SCHEDULER ? 4 : 1;
    float* Dn = tiles + tile_index(p + 1, p + 1) * TILE;
    if (p >= 0 && (warp == 0 || warp == PARTNER)) {
      update_half_tile(Dn, P, ldp, 0, 0, warp == PARTNER, lane);
      asm volatile("bar.sync 1, 64;" ::: "memory");
    }
    if (warp == 0) {
      factor_diagonal(Dn, dinv + (p + 1) * NB, lane);
    } else if (p >= 0) {
      const int u = tid - 32;
      if (u < m) {
        // z's rows below the panel: z_i -= L[i][panel] . w_panel
        const float* w = z + p * NB;
        float s = z[(p + 1) * NB + u];
#pragma unroll 8
        for (int q = 0; q < NB; ++q) s = fmaf(-P[q * ldp + u], w[q], s);
        z[(p + 1) * NB + u] = s;
      }
      // every tile of the trailing triangle but the next diagonal one, a half a
      // job.  Where a block holds an SM (512 threads), the warps that share
      // warp 0's scheduler (warp % 4 == 0) take none, leaving it to the
      // diagonal tile's chain.
      constexpr int JOB_WARPS = SPARE_SCHEDULER ? NW - NW / 4 : NW - 1;
      const int t = m / NB;
      const int jobs = 2 * (tiles_of(t) - 1);
      // the warp's place among the job warps; none for the ones left out
      const int first = !SPARE_SCHEDULER ? warp - 1 : warp % 4 == 0 ? jobs : warp - 1 - warp / 4;
      for (int jb = first; jb < jobs; jb += JOB_WARPS) {
        const int tl = 1 + (jb >> 1);
        int ii = 0;
        while (tiles_of(ii + 1) <= tl) ++ii;
        const int jj = tl - tiles_of(ii);
        update_half_tile(tiles + tile_index(p + 1 + ii, p + 1 + jj) * TILE, P, ldp, ii * NB, jj * NB, jb & 1, lane);
      }
    }
    __syncthreads();
    LKT_BLK_MARK(p < 0 ? FIRST_FACTOR : UPDATE);
  }

  // each diagonal tile becomes the transpose of its inverse, a warp a tile
  for (int t = warp; t < T; t += NW) invert_diagonal(tiles + tile_index(t, t) * TILE, dinv + t * NB, lane);
  __syncthreads();
  LKT_BLK_MARK(INVERSES);

  // back substitution with L^T, a panel at a time from the last; x replaces w in z
  for (int p = T - 1; p >= 0; --p) {
    float s = 0.f;
    for (int i = (p + 1) * NB + warp; i < KP; i += NW) s = fmaf(tiles[tile_index(i / NB, p) * TILE + entry_at(i % NB, lane)], z[i], s);
    red[tid] = s;
    __syncthreads();
    LKT_BLK_MARK(BACK_SUMS);
    if (warp == 0) {
      // lane c: r_c = w_c less the rows below, then x_c = sum_r inv(L)[r][c] r_r
      // from row c of the inverted diagonal tile
      float acc = z[p * NB + lane];
#pragma unroll
      for (int w = 0; w < NW; ++w) acc -= red[w * NB + lane];
      const float* Di = tiles + tile_index(p, p) * TILE;
      float xc = 0.f;
#pragma unroll
      for (int g = 0; g < NB / 4; ++g) {
        const float4 d = *reinterpret_cast<const float4*>(Di + chunk_at(lane, g));
        xc = fmaf(d.x, __shfl_sync(FULL, acc, 4 * g + 0), xc);
        xc = fmaf(d.y, __shfl_sync(FULL, acc, 4 * g + 1), xc);
        xc = fmaf(d.z, __shfl_sync(FULL, acc, 4 * g + 2), xc);
        xc = fmaf(d.w, __shfl_sync(FULL, acc, 4 * g + 3), xc);
      }
      z[p * NB + lane] = xc;
    }
    __syncthreads();
    LKT_BLK_MARK(BACK_SOLVE);
  }
  for (int i = tid; i < k; i += NT) x[b * k + i] = z[i];
  LKT_BLK_MARK(WRITE);
}

// Launch `kernel`, a __global__ wrapper of solve_system<NT>, over n systems.
template <int NT, class Kernel>
int launch(Kernel kernel, const float* A, const float* y, float* x, long long n, int k, cudaStream_t stream) {
  if (n <= 0 || n > INT_MAX || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_floats(k, NT) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte copies where every row starts on a 16-byte boundary
  const int vec4 = (k % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0) ? 1 : 0;
  kernel<<<static_cast<unsigned>(n), NT, smem, stream>>>(A, y, x, k, vec4);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local (spill) bytes a thread of `kernel` as compiled.
template <class Kernel>
int info(Kernel kernel, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace lkt_blk
