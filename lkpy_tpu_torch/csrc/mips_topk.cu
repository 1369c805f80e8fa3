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
// items hold (-inf, INT32_MAX).  The product is summed over d = 0..D-1 in
// order with one fused multiply-add per term; NaN scores are never selected.
//
// Bound at the retrieval path's shape (B = 4096, N = 500,000, D = 64):
//   f32 work outside the tensor cores: 2*B*N*D = 2.62e11 operations -> 3.9 ms
//   at 67 TFLOP/s (the TF32 tensor-core rate would give 0.53 ms, if a later
//   design's tolerance allows it);
//   bytes: Q, I and the outputs once, 129 MB -> 39 us at 3.35 TB/s (0.65 ms
//   with a 2.05 GB exclusion mask).
// So the launch is bound by operations.  The design is a register-tiled f32
// product: a block of 8 warps owns 32 queries and loops over the items in
// tiles of 256 (the loop stands in for the TPU grid's sequential item axis);
// each warp owns 4 of the queries across the whole tile, each lane 4 x 8
// scores.  D is walked in slabs of 32 through shared memory, the next slab's
// global loads in flight in registers while the current one is multiplied.
// Every block reads the whole item table, from L2 after the first.  The tile
// sizes are the fastest of a sweep on an H100; a ring of 4-byte cp.async
// copies, float4 reads of shared memory and a second shared-memory stage
// were each slower there.  The way on is a block of 64 or more queries with
// the items split over blocks and a second merge pass, or the tensor cores.
//
// The merge: the TPU kernel extracts the maximum k times from every tile.
// Here each query keeps its running top-k sorted in shared memory, with the
// k-th value as a threshold in a register.  Items arrive in increasing index
// order, so a score enters only if it is strictly greater than the threshold;
// after the first tiles almost none is, and a tile costs one comparison per
// score and one ballot per query.  A warp owns its queries' lists alone and
// inserts its candidates in index order (ballot, then lowest lane first), a
// new entry going behind every entry that is greater or equal: that is the
// tie rule, with no comparison of indices.  The exclusion byte is read only
// for a score that would otherwise enter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WQ = 4;                        // queries per warp: 4 or 8
constexpr int QB = (THREADS / 32) * WQ;      // queries per block
constexpr int NT = 256;                      // items per tile
constexpr int NJ = NT / 32;                  // items per lane per tile
constexpr int DK = 32;                       // depth of a slab: 16 or 32
constexpr int ROW_F4 = DK / 4;               // float4 per row of a slab
constexpr int IS_STRIDE = NT + 32 / DK;      // the transposing stores then hit 32 banks
constexpr int MAX_K = 64;
constexpr int I_F4 = NT * DK / 4 / THREADS;  // float4 loads of items per thread and slab
constexpr int Q_F4 = QB * DK / 4;            // float4 loads of queries per block and slab
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG_I32 = 2147483647;

static_assert(WQ == 4 || WQ == 8, "a warp reads its queries as one or two float4");
static_assert(I_F4 >= 1 && I_F4 * THREADS * 4 == NT * DK, "the item slab divides over the threads");
static_assert(Q_F4 <= THREADS, "at most one float4 of the query slab per thread");

struct Slab {
  float4 items[I_F4];
  float4 query;
};

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

__device__ __forceinline__ void load_slab(Slab& s, const float* __restrict__ Q, const float* __restrict__ I, int q0,
                                          int n0, int d0, int B, int N, int D, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < I_F4; ++i) {
    const int f = tid + THREADS * i;
    s.items[i] = load4(I, static_cast<int64_t>(n0) + f / ROW_F4, N, d0 + (f % ROW_F4) * 4, D, vec);
  }
  if (tid < Q_F4) s.query = load4(Q, static_cast<int64_t>(q0) + tid / ROW_F4, B, d0 + (tid % ROW_F4) * 4, D, vec);
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
  if (tid < Q_F4) {
    const int r = tid / ROW_F4;
    const int c = (tid % ROW_F4) * 4;
    Qs[(c + 0) * QB + r] = s.query.x;
    Qs[(c + 1) * QB + r] = s.query.y;
    Qs[(c + 2) * QB + r] = s.query.z;
    Qs[(c + 3) * QB + r] = s.query.w;
  }
}

// Insert (s, idx) into one query's list, sorted descending, by the whole
// warp; s is greater than the list's last value.  Lane l holds entries l and
// l + 32.  Returns the new last value.
__device__ __noinline__ float insert(float* lv, int* li, int k, float s, int idx, int lane) {
  const int j0 = lane;
  const int j1 = lane + 32;
  const bool in0 = j0 < k;
  const bool in1 = j1 < k;
  const unsigned ge0 = __ballot_sync(FULL, in0 && lv[j0] >= s);
  const unsigned ge1 = __ballot_sync(FULL, in1 && lv[j1] >= s);
  const int p = __popc(ge0) + __popc(ge1);  // the entries >= s are a prefix
  const bool mv0 = in0 && j0 > p;
  const bool mv1 = in1 && j1 > p;
  float v0 = 0.f, v1 = 0.f;
  int i0 = 0, i1 = 0;
  if (mv0) {
    v0 = lv[j0 - 1];
    i0 = li[j0 - 1];
  }
  if (mv1) {
    v1 = lv[j1 - 1];
    i1 = li[j1 - 1];
  }
  __syncwarp();
  if (mv0) {
    lv[j0] = v0;
    li[j0] = i0;
  } else if (j0 == p) {
    lv[j0] = s;
    li[j0] = idx;
  }
  if (mv1) {
    lv[j1] = v1;
    li[j1] = i1;
  } else if (j1 == p) {
    lv[j1] = s;
    li[j1] = idx;
  }
  __syncwarp();
  return lv[k - 1];
}

__global__ void __launch_bounds__(THREADS)
mips_topk_kernel(const float* __restrict__ Q, const float* __restrict__ I, const float* __restrict__ bias,
                 const unsigned char* __restrict__ exclude, float* __restrict__ out_v, int* __restrict__ out_i, int B,
                 int N, int D, int k, bool vec) {
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
  const float NEG_INF = __int_as_float(0xff800000);

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

  const int ntiles = (N + NT - 1) / NT;
  const int nslabs = (D + DK - 1) / DK;

  Slab regs;
  if (ntiles > 0) load_slab(regs, Q, I, q0, 0, 0, B, N, D, vec, tid);

  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * NT;
    float acc[WQ][NJ];
#pragma unroll
    for (int qi = 0; qi < WQ; ++qi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[qi][j] = 0.f;

    // the tile's bias values, asked for before the product so they are there after it
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = n0 + 32 * j + lane;
      bv[j] = (bias != nullptr && idx < N) ? __ldg(bias + idx) : 0.f;
    }

    for (int s = 0; s < nslabs; ++s) {
      store_slab(regs, Is, Qs, tid);
      __syncthreads();
      // the next slab's loads run while this one is multiplied
      if (s + 1 < nslabs) {
        load_slab(regs, Q, I, q0, n0, (s + 1) * DK, B, N, D, vec, tid);
      } else if (t + 1 < ntiles) {
        load_slab(regs, Q, I, q0, n0 + NT, 0, B, N, D, vec, tid);
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
          float v = idx < N ? acc[qi][j] + bv[j] : NEG_INF;
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
              if (v > thr[qi]) thr[qi] = insert(lv, li, k, v, n0 + 32 * j + src, lane);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < WQ; ++qi) {
    const int64_t q = q0 + qw + qi;
    if (q < B) {
      for (int j = lane; j < k; j += 32) {
        out_v[q * k + j] = list_v[(qw + qi) * MAX_K + j];
        out_i[q * k + j] = list_i[(qw + qi) * MAX_K + j];
      }
    }
  }
}

}  // namespace

extern "C" int lkt_mips_topk_f32(const float* Q, const float* I, const float* bias, const unsigned char* exclude,
                                 float* out_v, int* out_i, int B, int N, int D, int k, void* stream) {
  if (B <= 0 || N < 0 || D < 1 || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0 && reinterpret_cast<uintptr_t>(I) % 16 == 0;
  const int blocks = (B + QB - 1) / QB;
  const size_t smem = sizeof(float) * (DK * QB + DK * IS_STRIDE + 2 * QB * MAX_K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(mips_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mips_topk_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(Q, I, bias, exclude, out_v, out_i, B, N,
                                                                              D, k, vec);
  return static_cast<int>(cudaGetLastError());
}
