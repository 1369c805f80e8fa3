// A measurement build of the blocked SPD solve (lkpy_tpu_torch/csrc/spd_blocked.cuh)
// with its phase clocks on: scripts/spd_blocked_probe.py compiles it with nvcc
// into build/ and reads, for block 0, the cycles of each phase (the load, the
// first diagonal tile, the panel solves, the trailing updates, the inverses of
// the diagonal tiles, the back substitution's sums and its diagonal products,
// the write of x).
#define LKT_BLK_CLOCKS
#include "../lkpy_tpu_torch/csrc/spd_blocked.cuh"

template <int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
spd_blocked_clocks_kernel(const float* __restrict__ A, const float* __restrict__ y, float* __restrict__ x, int k,
                          int vec4) {
  lkt_blk::solve_system<NT>(A, y, x, k, vec4 != 0);
}

// One launch over n systems with `threads` (256 or 512) threads a system;
// the phase cycles of block 0 go to out[0..7].
extern "C" int lkt_spd_blocked_clocks(const float* A, const float* y, float* x, long long n, int k, int threads,
                                      unsigned long long* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long zero[8] = {};
  cudaError_t e = cudaMemcpyToSymbolAsync(lkt_blk::lkt_blk_clocks, zero, sizeof(zero), 0, cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = threads == 512 ? lkt_blk::launch<512>(spd_blocked_clocks_kernel<512, 1>, A, y, x, n, k, st)
                           : lkt_blk::launch<256>(spd_blocked_clocks_kernel<256, 2>, A, y, x, n, k, st);
  if (err != 0) return err;
  e = cudaMemcpyFromSymbolAsync(out, lkt_blk::lkt_blk_clocks, sizeof(zero), 0, cudaMemcpyDeviceToHost, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamSynchronize(st));
}
