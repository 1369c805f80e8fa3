// Fused maximum-inner-product top-k for Hopper (sm_90a):
//   scores = Q . I^T (+ item bias), excluded entries -inf, k largest per query.
//
// Replaces the TPU kernel lkpy_tpu/ops/pallas_topk.py::_topk_kernel (entry
// point mips_topk), the large-catalog retrieval path
// (ops/topk.py::retrieval_topk).  As there, the (B, N) score matrix never
// reaches device memory.
//
// Contract: Q is (B, D) f32 and I is (N, D) f32, both row-major; bias is (N,)
// f32 or null; exclude is (B, N) bytes or null (nonzero = excluded); out_v is
// (B, k) f32 in descending order and out_i is (B, k) int32, 1 <= k <= 64.
// Ties go to the smaller item index.  Slots beyond the number of scoreable
// items hold (-inf, INT32_MAX).  NaN scores are never selected.
//
// Bound at the retrieval path's shape (B = 4096, N = 500,000, D = 64):
//   f32 work outside the tensor cores: 2*B*N*D = 2.62e11 operations -> 3.9 ms
//   at 67 TFLOP/s; on the tensor cores in TF32 (495 TFLOP/s) 0.53 ms for one
//   pass, which keeps three digits, and 1.59 ms for the three passes that
//   keep f32's accuracy;
//   bytes: Q, I and the outputs once, 129 MB -> 39 us at 3.35 TB/s (0.65 ms
//   with a 2.05 GB exclusion mask).
// So the launch is bound by operations, and a small batch by how many SMs
// take part.
//
// The grid is (blocks of queries, S ranges of items).  A block walks the
// item tiles of its range (the loop stands in for the TPU grid's sequential
// item axis) and keeps a sorted top-k list per query in shared memory.  With
// S = 1 it writes the result; with S > 1 it writes its lists to scratch of
// shape (B, S, k) and a second kernel (mips_topk_merge_kernel, one warp per
// query) merges the S sorted lists of a query by (value descending, index
// ascending).  The Python wrapper chooses S so that a launch has several
// waves of blocks: 64 queries against 500,000 items are one block of queries
// and hundreds of ranges.
//
// Two products.  The Python wrapper takes one from the launch's shape alone
// (ops/mips_topk.py::choose_product): the tensor cores' for large launches,
// the FMA product for the rest, where the tensor-core kernel's larger blocks
// (16 or 32 queries a warp, whose lists a warp fills one entry at a time)
// cost more than its product saves.  Both hold the same tolerances.
//
// - f32 FMA (mips_topk_kernel).  8 warps own 32 queries; each warp 4 queries
//   across a 256-item tile, each lane 4 x 8 scores; D is walked in slabs of
//   32 through shared memory (transposed, conflict-free), the next slab's
//   global loads in flight in registers meanwhile.  The dot product is
//   summed over d = 0..D-1 in order with one fused multiply-add per term.
//   One such block (168 registers a thread) keeps an SM's FMA pipes as busy
//   as two; 8 queries a warp (10 shared loads per 64 FMAs where 4 queries
//   take 9 per 32) were slower on an H100, 13.1 against 11.1 ms at
//   (4096, 500000, 64).  Takes any D.
// - three-pass TF32 on the tensor cores (mips_topk_tc_kernel, D <= 128).
//   Each operand is split as big = tf32(x), small = tf32(x - big), and the
//   score is small.big + big.small + big.big accumulated in f32 by
//   mma.sync.m16n8k8: the dropped small.small term is 2^-22 of a product, so
//   f32's accuracy stays (a single pass would keep 2^-11).  8 warps own 128
//   queries, a warp 16 of them across a 128-item tile; for k <= 32, D <= 64
//   and more than 128 queries a warp owns 32 queries across a 64-item tile
//   (256 queries a block), so that an item fragment read from shared memory
//   feeds two query fragments.  The block's queries stay in shared memory as
//   f32 and are split as fragments are read; the item tile is split once, as
//   it is stored, into (big, small) pairs, so a fragment is one 8-byte read;
//   no split copy exists in device memory.  Scores are tested against the
//   query's k-th value where they lie, in the accumulator fragments.
//
// The lists: the TPU kernel extracts the maximum k times from every tile.
// Here a score enters a query's sorted list only past the list's k-th entry,
// kept in registers; after the first tiles almost none does, and a tile
// costs one comparison per score and one ballot.  A list lies in shared
// memory, a lane owning its entries l and l + 32; an insertion moves entries
// between lanes by shuffles, with no barrier.  The FMA kernel's warp sees
// its queries' items in increasing index order, so a new entry goes behind
// every entry that is greater or equal: the tie rule with no comparison of
// indices.  The tensor-core kernel and the merge see candidates in another
// order and compare (value, index) explicitly.  The exclusion byte is read
// only for a score that would otherwise enter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG_I32 = 2147483647;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Four consecutive floats of row `row` from column d; zero beyond the matrix.
__device__ __forceinline__ float4 load4(const float* __restrict__ base, int64_t row, int64_t rows, int d, int D,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows && d < D) {
    const float* p = base + row * D + d;
    if (vec) {  // D % 4 == 0 and aligned, so d + 3 < D
      v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      v.x = __ldg(p);
      if (d + 1 < D) v.y = __ldg(p + 1);
      if (d + 2 < D) v.z = __ldg(p + 2);
      if (d + 3 < D) v.w = __ldg(p + 3);
    }
  }
  return v;
}

// Does (v, i) come before (w, j) in a list?  Greater value first, then the
// smaller index.
__device__ __forceinline__ bool before(float v, int i, float w, int j) { return v > w || (v == w && i < j); }

// One 32-entry segment of a list, an entry a lane: the entries from place p
// on move up by one and (s, idx) takes place p; p >= 32 leaves it alone.
__device__ __forceinline__ void shift_in(float& v, int& i, int p, float s, int idx, int lane) {
  const float uv = __shfl_up_sync(FULL, v, 1);
  const int ui = __shfl_up_sync(FULL, i, 1);
  if (lane > p) {
    v = uv;
    i = ui;
  } else if (lane == p) {
    v = s;
    i = idx;
  }
}

struct Entry {
  float v;
  int i;
};

// Insert (s, idx) into one query's sorted list, by the whole warp; the new
// entry comes before the list's k-th.  The list lies in shared memory, lane l
// holding entries l and (for k > 32) l + 32: a lane reads and writes its own
// entries only and takes its neighbour's through a shuffle, so no barrier is
// needed.  All 32 (or 64) slots are kept sorted, whatever k is.  BY_INDEX:
// the entry's place among equal values is decided by its index; otherwise it
// goes behind every entry that is greater or equal (right when candidates
// arrive in index order).  Returns the new k-th entry.
template <bool BY_INDEX>
__device__ __noinline__ Entry insert(float* lv, int* li, int k, float s, int idx, int lane) {
  float v0 = lv[lane];
  int i0 = li[lane];
  // the entries that stay ahead of the new one are a prefix
  const int p0 = __popc(__ballot_sync(FULL, BY_INDEX ? before(v0, i0, s, idx) : v0 >= s));
  const float last_v = __shfl_sync(FULL, v0, 31);
  const int last_i = __shfl_sync(FULL, i0, 31);
  shift_in(v0, i0, p0, s, idx, lane);
  lv[lane] = v0;
  li[lane] = i0;
  if (k <= 32) return Entry{__shfl_sync(FULL, v0, k - 1), __shfl_sync(FULL, i0, k - 1)};
  float v1 = lv[lane + 32];
  int i1 = li[lane + 32];
  if (p0 < 32) {  // the first segment's last entry moves over
    shift_in(v1, i1, 0, last_v, last_i, lane);
  } else {
    const int p1 = __popc(__ballot_sync(FULL, BY_INDEX ? before(v1, i1, s, idx) : v1 >= s));
    shift_in(v1, i1, p1, s, idx, lane);
  }
  lv[lane + 32] = v1;
  li[lane + 32] = i1;
  return Entry{__shfl_sync(FULL, v1, k - 33), __shfl_sync(FULL, i1, k - 33)};
}

// A block's lists go out at (query, range): the result itself when S = 1.
__device__ __forceinline__ void write_list(const float* lv, const int* li, float* __restrict__ out_v,
                                           int* __restrict__ out_i, int64_t q, int S, int s, int k, int lane) {
  const int64_t o = (q * S + s) * k;
  for (int j = lane; j < k; j += 32) {
    out_v[o + j] = lv[j];
    out_i[o + j] = li[j];
  }
}

// ---------------------------------------------------------------------------
// the f32 FMA product
// ---------------------------------------------------------------------------

constexpr int WQ = 4;                        // queries per warp: 4 or 8
constexpr int QB = (THREADS / 32) * WQ;      // queries per block
constexpr int NT = 256;                      // items per tile
constexpr int NJ = NT / 32;                  // items per lane per tile
constexpr int DK = 32;                       // depth of a slab: 16 or 32
constexpr int ROW_F4 = DK / 4;               // float4 per row of a slab
constexpr int IS_STRIDE = NT + 32 / DK;      // the transposing stores then hit 32 banks
constexpr int I_F4 = NT * DK / 4 / THREADS;  // float4 loads of items per thread and slab
constexpr int Q_F4 = QB * DK / 4;            // float4 loads of queries per block and slab
constexpr int Q_PT = (Q_F4 + THREADS - 1) / THREADS;  // ... per thread

static_assert(WQ == 4 || WQ == 8, "a warp reads its queries as one or two float4");
static_assert(I_F4 >= 1 && I_F4 * THREADS * 4 == NT * DK, "the item slab divides over the threads");

struct Slab {
  float4 items[I_F4];
  float4 query[Q_PT];
};

__device__ __forceinline__ void load_slab(Slab& s, const float* __restrict__ Q, const float* __restrict__ I, int q0,
                                          int n0, int d0, int B, int N, int D, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < I_F4; ++i) {
    const int f = tid + THREADS * i;
    s.items[i] = load4(I, static_cast<int64_t>(n0) + f / ROW_F4, N, d0 + (f % ROW_F4) * 4, D, vec);
  }
#pragma unroll
  for (int i = 0; i < Q_PT; ++i) {
    const int f = tid + THREADS * i;
    if (f < Q_F4) s.query[i] = load4(Q, static_cast<int64_t>(q0) + f / ROW_F4, B, d0 + (f % ROW_F4) * 4, D, vec);
  }
}

// Registers to shared memory, transposed: Is[d][item], Qs[d][query].
__device__ __forceinline__ void store_slab(const Slab& s, float* Is, float* Qs, int tid) {
#pragma unroll
  for (int i = 0; i < I_F4; ++i) {
    const int f = tid + THREADS * i;
    const int r = f / ROW_F4;
    const int c = (f % ROW_F4) * 4;
    Is[(c + 0) * IS_STRIDE + r] = s.items[i].x;
    Is[(c + 1) * IS_STRIDE + r] = s.items[i].y;
    Is[(c + 2) * IS_STRIDE + r] = s.items[i].z;
    Is[(c + 3) * IS_STRIDE + r] = s.items[i].w;
  }
#pragma unroll
  for (int i = 0; i < Q_PT; ++i) {
    const int f = tid + THREADS * i;
    if (f < Q_F4) {
      const int r = f / ROW_F4;
      const int c = (f % ROW_F4) * 4;
      Qs[(c + 0) * QB + r] = s.query[i].x;
      Qs[(c + 1) * QB + r] = s.query[i].y;
      Qs[(c + 2) * QB + r] = s.query[i].z;
      Qs[(c + 3) * QB + r] = s.query[i].w;
    }
  }
}

// Items [blockIdx.y * range, ...) of the catalog against the block's queries.
__global__ void __launch_bounds__(THREADS)
mips_topk_kernel(const float* __restrict__ Q, const float* __restrict__ I, const float* __restrict__ bias,
                 const unsigned char* __restrict__ exclude, float* __restrict__ out_v, int* __restrict__ out_i, int B,
                 int N, int D, int k, int range, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // DK x QB, read as float4
  float* Is = Qs + DK * QB;              // DK x IS_STRIDE
  float* list_v = Is + DK * IS_STRIDE;   // QB x MAX_K
  int* list_i = reinterpret_cast<int*>(list_v + QB * MAX_K);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int qw = warp * WQ;  // this warp's first query within the block
  const float NEG_INF = neg_inf();
  const int64_t first = static_cast<int64_t>(blockIdx.y) * range;
  const int n_begin = static_cast<int>(first < N ? first : N);
  const int n_end = static_cast<int>(first + range < N ? first + range : N);

#pragma unroll
  for (int qi = 0; qi < WQ; ++qi) {
    list_v[(qw + qi) * MAX_K + lane] = NEG_INF;
    list_v[(qw + qi) * MAX_K + lane + 32] = NEG_INF;
    list_i[(qw + qi) * MAX_K + lane] = BIG_I32;
    list_i[(qw + qi) * MAX_K + lane + 32] = BIG_I32;
  }
  __syncwarp();
  float thr[WQ];
#pragma unroll
  for (int qi = 0; qi < WQ; ++qi) thr[qi] = NEG_INF;

  const int ntiles = (n_end - n_begin + NT - 1) / NT;
  const int nslabs = (D + DK - 1) / DK;

  Slab regs;
  if (ntiles > 0) load_slab(regs, Q, I, q0, n_begin, 0, B, n_end, D, vec, tid);

  for (int t = 0; t < ntiles; ++t) {
    const int n0 = n_begin + t * NT;
    float acc[WQ][NJ];
#pragma unroll
    for (int qi = 0; qi < WQ; ++qi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[qi][j] = 0.f;

    for (int s = 0; s < nslabs; ++s) {
      store_slab(regs, Is, Qs, tid);
      __syncthreads();
      // the next slab's loads run while this one is multiplied
      if (s + 1 < nslabs) {
        load_slab(regs, Q, I, q0, n0, (s + 1) * DK, B, n_end, D, vec, tid);
      } else if (t + 1 < ntiles) {
        load_slab(regs, Q, I, q0, n0 + NT, 0, B, n_end, D, vec, tid);
      }
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        float qv[WQ];
#pragma unroll
        for (int h = 0; h < WQ / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(&Qs[d * QB + qw + 4 * h]);
          qv[4 * h + 0] = v.x;
          qv[4 * h + 1] = v.y;
          qv[4 * h + 2] = v.z;
          qv[4 * h + 3] = v.w;
        }
        float iv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) iv[j] = Is[d * IS_STRIDE + lane + 32 * j];
#pragma unroll
        for (int qi = 0; qi < WQ; ++qi)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[qi][j] = fmaf(qv[qi], iv[j], acc[qi][j]);
      }
      __syncthreads();
    }

    // the tile's bias values
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = n0 + 32 * j + lane;
      bv[j] = (bias != nullptr && idx < n_end) ? __ldg(bias + idx) : 0.f;
    }

    // merge the tile into this warp's lists, in item order
#pragma unroll
    for (int qi = 0; qi < WQ; ++qi) {
      const int q = q0 + qw + qi;
      if (q < B) {
        float sc[NJ];
        float best = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int idx = n0 + 32 * j + lane;
          float v = idx < n_end ? acc[qi][j] + bv[j] : NEG_INF;
          if (exclude != nullptr && v > thr[qi] && exclude[static_cast<int64_t>(q) * N + idx] != 0) v = NEG_INF;
          sc[j] = v;
          best = fmaxf(best, v);
        }
        if (__ballot_sync(FULL, best > thr[qi]) != 0u) {
          float* lv = list_v + (qw + qi) * MAX_K;
          int* li = list_i + (qw + qi) * MAX_K;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            unsigned cand = __ballot_sync(FULL, sc[j] > thr[qi]);
            while (cand != 0u) {
              const int src = __ffs(cand) - 1;
              cand &= cand - 1;
              const float v = __shfl_sync(FULL, sc[j], src);
              if (v > thr[qi]) thr[qi] = insert<false>(lv, li, k, v, n0 + 32 * j + src, lane).v;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < WQ; ++qi) {
    const int64_t q = q0 + qw + qi;
    if (q < B)
      write_list(list_v + (qw + qi) * MAX_K, list_i + (qw + qi) * MAX_K, out_v, out_i, q, gridDim.y, blockIdx.y, k, lane);
  }
}

// ---------------------------------------------------------------------------
// the three-pass TF32 product on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TDK = 64;                     // depth of an item slab
constexpr int TIS = 2 * TDK + 8;            // floats a staged item row: (big, small) pairs; 8-byte reads hit 32 banks
constexpr int TC_MAX_D = 128;

// MT 16-query fragments a warp: 128 * MT queries a block against tiles of
// 128 / MT items, 64 accumulators a lane either way.  MT = 2 reads an item
// fragment once for two query fragments.
template <int MT>
struct Tc {
  static constexpr int QBLK = 128 * MT;                    // queries per block
  static constexpr int NT = 128 / MT;                      // items per tile
  static constexpr int NN = NT / 8;                        // 8-item fragments per tile
  static constexpr int I_F4 = NT * TDK / 4 / THREADS;      // float4 loads of items per thread and slab
  static constexpr int ROWS = 16 * MT;                     // queries per warp
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT>
__device__ __forceinline__ void tc_load_items(float4 (&regs)[Tc<MT>::I_F4], const float* __restrict__ I, int n0, int d0,
                                              int n_end, int D, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < Tc<MT>::I_F4; ++i) {
    const int f = tid + THREADS * i;
    regs[i] = load4(I, static_cast<int64_t>(n0) + f / (TDK / 4), n_end, d0 + (f % (TDK / 4)) * 4, D, vec);
  }
}

// Registers to shared memory, each value split into its (big, small) pair.
template <int MT>
__device__ __forceinline__ void tc_store_items(const float4 (&regs)[Tc<MT>::I_F4], float* Is, int tid) {
#pragma unroll
  for (int i = 0; i < Tc<MT>::I_F4; ++i) {
    const int f = tid + THREADS * i;
    float* p = Is + (f / (TDK / 4)) * TIS + (f % (TDK / 4)) * 8;
    const float v[4] = {regs[i].x, regs[i].y, regs[i].z, regs[i].w};
    float o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float big = __uint_as_float(tf32(v[e]));
      o[2 * e] = big;
      o[2 * e + 1] = __uint_as_float(tf32(v[e] - big));
    }
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
mips_topk_tc_kernel(const float* __restrict__ Q, const float* __restrict__ I, const float* __restrict__ bias,
                    const unsigned char* __restrict__ exclude, float* __restrict__ out_v, int* __restrict__ out_i, int B,
                    int N, int D, int k, int range, bool vec) {
  using C = Tc<MT>;
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 7) & ~7;
  const int QS = Dp + 4;                  // floats a query row: fragment reads hit 32 banks
  const int KP = k <= 32 ? 32 : 64;       // slots a list
  float* Qs = smem;                       // QBLK x QS, f32
  float* Is = Qs + C::QBLK * QS;          // NT x TIS, (big, small) pairs
  float* list_v = Is + C::NT * TIS;       // QBLK x KP
  int* list_i = reinterpret_cast<int*>(list_v + C::QBLK * KP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (and the item within an 8-item fragment)
  const int t = lane & 3;
  const int q0 = blockIdx.x * C::QBLK;
  const int qw = warp * C::ROWS;  // this warp's first query within the block
  const float NEG_INF = neg_inf();
  const int64_t first = static_cast<int64_t>(blockIdx.y) * range;
  const int n_begin = static_cast<int>(first < N ? first : N);
  const int n_end = static_cast<int>(first + range < N ? first + range : N);

  // the block's queries, once
  for (int f = tid; f < C::QBLK * (Dp / 4); f += THREADS) {
    const int r = f / (Dp / 4);
    const int c = (f % (Dp / 4)) * 4;
    *reinterpret_cast<float4*>(Qs + r * QS + c) = load4(Q, static_cast<int64_t>(q0) + r, B, c, D, vec);
  }
  for (int j = lane; j < C::ROWS * KP; j += 32) {
    list_v[qw * KP + j] = NEG_INF;
    list_i[qw * KP + j] = BIG_I32;
  }
  // a lane watches the queries of rows g and g + 8 of its warp's fragments:
  // entry 2 mt + h is row 16 mt + 8 h + g (a row past the batch takes
  // nothing: its threshold is +inf)
  float thr_v[2 * MT];
  int thr_i[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    thr_v[r] = q0 + qw + 8 * r + g < B ? NEG_INF : -NEG_INF;
    thr_i[r] = BIG_I32;
  }

  const int ntiles = (n_end - n_begin + C::NT - 1) / C::NT;
  const int nslabs = (D + TDK - 1) / TDK;
  float4 regs[C::I_F4];
  if (ntiles > 0) tc_load_items<MT>(regs, I, n_begin, 0, n_end, D, vec, tid);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int n0 = n_begin + tile * C::NT;
    float acc[MT][C::NN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < C::NN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nn][e] = 0.f;

    for (int s = 0; s < nslabs; ++s) {
      tc_store_items<MT>(regs, Is, tid);
      __syncthreads();
      if (s + 1 < nslabs) {
        tc_load_items<MT>(regs, I, n0, (s + 1) * TDK, n_end, D, vec, tid);
      } else if (tile + 1 < ntiles) {
        tc_load_items<MT>(regs, I, n0 + C::NT, 0, n_end, D, vec, tid);
      }
      const int depth = Dp - s * TDK < TDK ? Dp - s * TDK : TDK;
      const float* qrow = Qs + (qw + g) * QS + s * TDK + t;
      for (int ks = 0; ks < depth / 8; ++ks) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* qr = qrow + mt * 16 * QS + ks * 8;
          const float a[4] = {qr[0], qr[8 * QS], qr[4], qr[8 * QS + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[mt][e] = tf32(a[e]);
            as[mt][e] = tf32(a[e] - __uint_as_float(ab[mt][e]));
          }
        }
        const float* ip = Is + g * TIS + 2 * (ks * 8 + t);
        // eight item fragments at a time, pass by pass: consecutive mma are independent
#pragma unroll
        for (int c = 0; c < C::NN; c += 8) {
          float2 b0[8], b1[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            b0[u] = *reinterpret_cast<const float2*>(ip + (c + u) * 8 * TIS);
            b1[u] = *reinterpret_cast<const float2*>(ip + (c + u) * 8 * TIS + 8);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              mma_tf32(acc[mt][c + u], as[mt], __float_as_uint(b0[u].x), __float_as_uint(b1[u].x));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              mma_tf32(acc[mt][c + u], ab[mt], __float_as_uint(b0[u].y), __float_as_uint(b1[u].y));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              mma_tf32(acc[mt][c + u], ab[mt], __float_as_uint(b0[u].x), __float_as_uint(b1[u].x));
        }
      }
      __syncthreads();
    }

    // scores where they lie: acc[mt][nn][2h + e] is row 16 mt + 8 h + g, item n0 + 8 nn + 2 t + e;
    // any[2 mt + h]: one of this lane's scores of that row may enter its list
    bool any[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) any[r] = false;
    if (bias == nullptr && n0 + C::NT <= n_end) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nn = 0; nn < C::NN; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) any[2 * mt + (e >> 1)] |= acc[mt][nn][e] >= thr_v[2 * mt + (e >> 1)];
    } else {
      // the bias and the range's end go into the scores first
#pragma unroll
      for (int nn = 0; nn < C::NN; ++nn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = n0 + 8 * nn + 2 * t + e;
          const bool live = idx < n_end;
          const float bv = (bias != nullptr && live) ? __ldg(bias + idx) : 0.f;
#pragma unroll
          for (int r = 0; r < 2 * MT; ++r) {
            const float v = live ? acc[r >> 1][nn][2 * (r & 1) + e] + bv : NEG_INF;
            acc[r >> 1][nn][2 * (r & 1) + e] = v;
            any[r] |= v >= thr_v[r];
          }
        }
      }
    }

    // rare after the first tiles: a lane marks its scores that may enter, and
    // the warp takes the marked ones in, one at a time
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      if (__ballot_sync(FULL, any[r]) == 0u) continue;
      const int mt = r >> 1;
      const int h = r & 1;
      unsigned mine = 0u;
#pragma unroll
      for (int nn = 0; nn < C::NN; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (acc[mt][nn][2 * h + e] >= thr_v[r]) mine |= 1u << (2 * nn + e);
      unsigned bits = __reduce_or_sync(FULL, mine);
      while (bits != 0u) {
        const int bit = __ffs(bits) - 1;  // the same for the whole warp
        bits &= bits - 1;
        float v = NEG_INF;
#pragma unroll
        for (int nn = 0; nn < C::NN; ++nn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (bit == 2 * nn + e) v = acc[mt][nn][2 * h + e];
        unsigned cand = __ballot_sync(FULL, (mine >> bit) & 1u);
        while (cand != 0u) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float cv = __shfl_sync(FULL, v, src);
          const int ci = n0 + 8 * (bit >> 1) + 2 * (src & 3) + (bit & 1);
          // the source's own threshold: an earlier candidate of its query may have raised it
          const float tv = __shfl_sync(FULL, thr_v[r], src);
          const int ti = __shfl_sync(FULL, thr_i[r], src);
          const int row = qw + 8 * r + (src >> 2);  // the source's query within the block
          // a score of -inf (past the range's end, or given so) takes no slot
          if (cv > NEG_INF && before(cv, ci, tv, ti) &&
              !(exclude != nullptr && exclude[static_cast<int64_t>(q0 + row) * N + ci] != 0)) {
            const Entry kth = insert<true>(list_v + row * KP, list_i + row * KP, k, cv, ci, lane);
            if (g == (src >> 2)) {
              thr_v[r] = kth.v;
              thr_i[r] = kth.i;
            }
          }
        }
      }
    }
  }

  __syncwarp();
  for (int r = 0; r < C::ROWS; ++r) {
    const int64_t q = q0 + qw + r;
    if (q < B) write_list(list_v + (qw + r) * KP, list_i + (qw + r) * KP, out_v, out_i, q, gridDim.y, blockIdx.y, k, lane);
  }
}

// Query fragments a warp of the tensor-core kernel for this call: two where
// the batch fills such blocks and shared memory holds their lists.
__host__ __device__ inline int tc_fragments(int B, int D, int k) { return (B > 128 && D <= 64 && k <= 32) ? 2 : 1; }

template <int MT>
int launch_tc(const float* Q, const float* I, const float* bias, const unsigned char* exclude, float* dst_v, int* dst_i,
              int B, int N, int D, int k, int range, int S, bool vec, cudaStream_t stream) {
  using C = Tc<MT>;
  const int Dp = (D + 7) & ~7;
  const int KP = k <= 32 ? 32 : 64;
  const size_t smem = sizeof(float) * (C::QBLK * (Dp + 4) + C::NT * TIS + 2 * C::QBLK * KP);
  const cudaError_t e =
      cudaFuncSetAttribute(mips_topk_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + C::QBLK - 1) / C::QBLK, S);
  mips_topk_tc_kernel<MT><<<grid, THREADS, smem, stream>>>(Q, I, bias, exclude, dst_v, dst_i, B, N, D, k, range, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the merge of a query's S sorted lists
// ---------------------------------------------------------------------------

constexpr int MERGE_WARPS = 4;

__global__ void __launch_bounds__(32 * MERGE_WARPS)
mips_topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i, float* __restrict__ out_v,
                       int* __restrict__ out_i, int B, int S, int k) {
  __shared__ float list_v[MERGE_WARPS][MAX_K];
  __shared__ int list_i[MERGE_WARPS][MAX_K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * MERGE_WARPS + warp;
  if (q >= B) return;
  float* lv = list_v[warp];
  int* li = list_i[warp];
  lv[lane] = neg_inf();
  lv[lane + 32] = neg_inf();
  li[lane] = BIG_I32;
  li[lane + 32] = BIG_I32;
  __syncwarp();
  float thr_v = neg_inf();
  int thr_i = BIG_I32;
  const int total = S * k;
  const float* pv = part_v + q * total;
  const int* pi = part_i + q * total;
  for (int base = 0; base < total; base += 32) {
    const int pos = base + lane;
    const float v = pos < total ? pv[pos] : neg_inf();
    const int idx = pos < total ? pi[pos] : BIG_I32;
    unsigned cand = __ballot_sync(FULL, before(v, idx, thr_v, thr_i));
    while (cand != 0u) {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const float cv = __shfl_sync(FULL, v, src);
      const int ci = __shfl_sync(FULL, idx, src);
      if (before(cv, ci, thr_v, thr_i)) {
        const Entry kth = insert<true>(lv, li, k, cv, ci, lane);
        thr_v = kth.v;
        thr_i = kth.i;
      }
    }
  }
  for (int j = lane; j < k; j += 32) {
    out_v[q * k + j] = lv[j];
    out_i[q * k + j] = li[j];
  }
}

int launch_merge(const float* part_v, const int* part_i, float* out_v, int* out_i, int B, int S, int k,
                 cudaStream_t stream) {
  const int blocks = (B + MERGE_WARPS - 1) / MERGE_WARPS;
  mips_topk_merge_kernel<<<blocks, 32 * MERGE_WARPS, 0, stream>>>(part_v, part_i, out_v, out_i, B, S, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One product kernel over the grid (query blocks, S).  product: 0 = f32 FMA,
// 1 = three-pass TF32.
int launch_product(int product, const float* Q, const float* I, const float* bias, const unsigned char* exclude,
                   float* dst_v, int* dst_i, int B, int N, int D, int k, int range, int S, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && aligned16(Q) && aligned16(I);
  cudaError_t e;
  if (product == 1) {
    if (D > TC_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    if (tc_fragments(B, D, k) == 2) return launch_tc<2>(Q, I, bias, exclude, dst_v, dst_i, B, N, D, k, range, S, vec, stream);
    return launch_tc<1>(Q, I, bias, exclude, dst_v, dst_i, B, N, D, k, range, S, vec, stream);
  } else {
    const size_t smem = sizeof(float) * (DK * QB + DK * IS_STRIDE + 2 * QB * MAX_K);
    e = cudaFuncSetAttribute(mips_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((B + QB - 1) / QB, S);
    mips_topk_kernel<<<grid, THREADS, smem, stream>>>(Q, I, bias, exclude, dst_v, dst_i, B, N, D, k, range, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The item ranges are `range` items long (a multiple of 256), S = ceil(N / range)
// of them, at most 65,535.  With S > 1, part_v and part_i are scratch of
// (B, S, k) entries; with S = 1 they are not read.  product: 0 = f32 FMA,
// 1 = three-pass TF32 (D <= 128).
extern "C" int lkt_mips_topk_f32(const float* Q, const float* I, const float* bias, const unsigned char* exclude,
                                 float* out_v, int* out_i, float* part_v, int* part_i, int B, int N, int D, int k,
                                 int range, int product, void* stream) {
  if (B <= 0 || N < 0 || D < 1 || k < 1 || k > MAX_K || range < 256 || range % 256 != 0 || product < 0 || product > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ranges = N == 0 ? 1 : (static_cast<int64_t>(N) + range - 1) / range;
  if (ranges > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>(ranges);
  if (S > 1 && (part_v == nullptr || part_i == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_product(product, Q, I, bias, exclude, S > 1 ? part_v : out_v, S > 1 ? part_i : out_i, B, N, D,
                                 k, range, S, st);
  if (err != 0 || S == 1) return err;
  return launch_merge(part_v, part_i, out_v, out_i, B, S, k, st);
}

// The merge pass alone: (B, S, k) sorted partial lists to (B, k).
extern "C" int lkt_mips_topk_merge_f32(const float* part_v, const int* part_i, float* out_v, int* out_i, int B, int S,
                                       int k, void* stream) {
  if (B <= 0 || S < 1 || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  return launch_merge(part_v, part_i, out_v, out_i, B, S, k, static_cast<cudaStream_t>(stream));
}

// Queries a block of a product for this call: what the choice of S rests on.
extern "C" int lkt_mips_topk_queries_per_block(int B, int D, int k, int product) {
  return product == 1 ? 128 * tc_fragments(B, D, k) : QB;
}
