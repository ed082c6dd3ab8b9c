// Transient-film accumulation for Hopper (sm_90a): kernel K3.
//
// Replaces mitransient_tpu/ops/splat_pallas.py:_splat_kernel.  Lanes are
// spp-major (lane = s * hw + p), so a lane's pixel is fixed and a splat is
// a per-pixel histogram over time.  The TPU kernel sweeps the time axis
// with dense compares because it has no scatter; here one thread owns one
// pixel p and, for s = 0..L-1, adds lane s*hw + p of event set a into
// film[c, bin, p], then does the same for event set b.  Only that thread
// writes column p, so the kernel needs no atomics, is deterministic, and
// adds in the order of the sequential scatter (all of set a, then set b).
//
// The film is updated IN PLACE (the JAX version donated the buffer and
// returned a new one).  Bins outside [0, t_pad) are dropped, like the
// scatter's mode="drop"; the film's overflow bin t_pad - 1 is kept and
// sliced away by develop().
//
// Bound: memory.  Each call reads 2 * N * (4 + 4C) bytes of bins and values
// (neighbouring threads read neighbouring lanes, so the reads coalesce)
// plus the film lines it touches; film writes are coherent in bin because
// neighbouring pixels see similar path lengths.  There are only hw threads
// (65536 at 256x256), each running 2L dependent read-modify-writes, so the
// kernel is latency bound at small hw; making it faster is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;

__device__ __forceinline__ void add_events(float* __restrict__ film, int C,
                                           int t_pad, int hw, int lanes, int p,
                                           const int32_t* __restrict__ bins,
                                           const float* __restrict__ vals) {
  for (int s = 0; s < lanes; ++s) {
    const int64_t lane = (int64_t)s * hw + p;
    const int b = bins[lane];
    if (b < 0 || b >= t_pad) continue;
    for (int c = 0; c < C; ++c) {
      film[((int64_t)c * t_pad + b) * hw + p] += vals[lane * C + c];
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
splat_kernel(float* __restrict__ film, int C, int t_pad, int hw, int lanes,
             const int32_t* __restrict__ bins_a, const float* __restrict__ vals_a,
             const int32_t* __restrict__ bins_b,
             const float* __restrict__ vals_b) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  add_events(film, C, t_pad, hw, lanes, p, bins_a, vals_a);
  if (bins_b != nullptr) add_events(film, C, t_pad, hw, lanes, p, bins_b, vals_b);
}

}  // namespace

extern "C" {

// film: (C, t_pad, hw) f32, updated in place; bins_*: (lanes * hw,) int32;
// vals_*: (lanes * hw, C) f32.  bins_b and vals_b may be null (one event set).
int mitr_splat_accumulate(float* film, int C, int t_pad, int hw, int lanes,
                          const int32_t* bins_a, const float* vals_a,
                          const int32_t* bins_b, const float* vals_b,
                          void* stream) {
  if (hw > 0 && lanes > 0) {
    const int grid = (hw + BLOCK - 1) / BLOCK;
    splat_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        film, C, t_pad, hw, lanes, bins_a, vals_a, bins_b, vals_b);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
