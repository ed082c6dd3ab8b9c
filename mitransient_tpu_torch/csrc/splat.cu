// Transient-film accumulation for Hopper (sm_90a): kernel K3.
//
// Replaces mitransient_tpu/ops/splat_pallas.py:_splat_kernel.  Lanes are
// spp-major (lane = s * hw + p), so a lane's pixel is fixed and a splat is
// a per-pixel histogram over time.  The TPU kernel sweeps the time axis
// with dense compares because it has no scatter.
//
// Bound: memory.  The least traffic is the film (C, t_pad, hw) read once
// and written once plus the events, 2 * N * (4 + 4C) bytes.  One thread per
// pixel working straight on the film in device memory would run only hw
// threads (65,536 at 256x256), each making 2L dependent read-modify-writes
// of 4-byte cells hw floats apart: latency bound, and a 32-byte sector
// paid per touched cell.
//
// This design: a block owns P consecutive pixels and their film slab
// (C, t_pad, P) in shared memory.  It
//  1. loads the slab with every thread, coalesced (float4 where the rows
//     are 16-byte aligned);
//  2. applies the events in shared memory, one thread per (pixel, channel)
//     walking lanes s = 0..L-1 of set a, then of set b, its loads of bins
//     and values issued UNROLL lanes ahead;
//  3. writes the slab back.
// Only that thread adds into its cells, in the order of the sequential
// scatter (all of set a, then set b, each in lane order), so the film is
// bit-equal to the CPU plain version, with no atomics.  P is the largest
// power of two up to 32 whose slab stays within SLAB_BYTES (32 pixels,
// 115.6 KB, at 3 x 301 bins: whole 128-byte rows), and at least one pixel.
//
// The film is updated IN PLACE (the JAX version donated the buffer and
// returned a new one).  mitr_splat_accumulate takes the film's address as
// an argument; mitr_splat_accumulate_at reads it from device memory when
// the kernel runs, for a splat captured into a CUDA graph.  Both launch the
// same kernel.  Bins outside [0, t_pad) are dropped, like the
// scatter's mode="drop"; the film's overflow bin t_pad - 1 is kept and
// sliced away by develop().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int UNROLL = 8;
constexpr int STAGE = 8;
constexpr int MAX_PIXELS = 32;
constexpr int SLAB_BYTES = 128 * 1024;
constexpr int MAX_SHARED_BYTES = 232448;

// Adds one event set into the column `col` (cell (c, b, j) at col[b * P])
// of the pixel p, channel c.
__device__ __forceinline__ void add_events(float* col, int P, int C, int c,
                                           int t_pad, int hw, int lanes,
                                           int p,
                                           const int32_t* __restrict__ bins,
                                           const float* __restrict__ vals) {
  for (int s0 = 0; s0 < lanes; s0 += UNROLL) {
    int b[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t lane = (int64_t)(s0 + u) * hw + p;
      const bool in = s0 + u < lanes;
      b[u] = in ? __ldg(bins + lane) : -1;
      v[u] = in ? __ldg(vals + lane * C + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (b[u] >= 0 && b[u] < t_pad) col[b[u] * P] += v[u];
  }
}

// Moves rows r0, r0 + step, ... < rows of one thread's column between the
// film (row k at film[k * fstride]) and the slab (slab[k * sstride]),
// STAGE rows at once: their loads are issued before their stores, so that
// STAGE loads are in flight even where the compiler cannot tell the film
// from the slab (a film address read from memory is a generic pointer,
// which may alias shared memory).
template <bool LOAD, typename T>
__device__ __forceinline__ void copy_rows(T* film, T* slab, int rows, int r0,
                                          int step, int64_t fstride,
                                          int sstride) {
  for (int r = r0; r < rows; r += STAGE * step) {
    T v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int k = r + u * step;
      if (k < rows) v[u] = LOAD ? film[k * fstride] : slab[k * sstride];
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int k = r + u * step;
      if (k >= rows) continue;
      if (LOAD)
        slab[k * sstride] = v[u];
      else
        film[k * fstride] = v[u];
    }
  }
}

// Copies the slab rows r = 0..rows-1 (P floats at film + r * hw) between
// the film and shared memory, np of them real; P divides BLOCK.
template <bool LOAD>
__device__ __forceinline__ void copy_slab(float* film, float* slab, int rows,
                                          int P, int np, int hw, bool vec) {
  if (vec) {  // np == P, P % 4 == 0, rows 16-byte aligned
    const int q = P / 4;
    const int j = threadIdx.x % q;
    copy_rows<LOAD>(reinterpret_cast<float4*>(film) + j,
                    reinterpret_cast<float4*>(slab) + j, rows,
                    threadIdx.x / q, BLOCK / q, hw / 4, q);
  } else {
    const int j = threadIdx.x % P;
    if (j < np)
      copy_rows<LOAD>(film + j, slab + j, rows, threadIdx.x / P, BLOCK / P,
                      hw, P);
  }
}

__global__ void __launch_bounds__(BLOCK)
splat_kernel(float* __restrict__ film, float* const* film_at, int C,
             int t_pad, int hw, int lanes, int P,
             const int32_t* __restrict__ bins_a,
             const float* __restrict__ vals_a,
             const int32_t* __restrict__ bins_b,
             const float* __restrict__ vals_b) {
  extern __shared__ __align__(16) float slab[];  // (C * t_pad, P)
  const int p0 = blockIdx.x * P;
  const int np = min(P, hw - p0);
  const int rows = C * t_pad;
  float* base = (film_at != nullptr ? *film_at : film) + p0;
  const bool vec = np == P && P % 4 == 0 && hw % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % 16 == 0;
  copy_slab<true>(base, slab, rows, P, np, hw, vec);
  __syncthreads();
  for (int w = threadIdx.x; w < np * C; w += BLOCK) {
    const int j = w / C, c = w - j * C;  // neighbouring threads: channels
    float* col = slab + c * t_pad * P + j;
    add_events(col, P, C, c, t_pad, hw, lanes, p0 + j, bins_a, vals_a);
    if (bins_b != nullptr)
      add_events(col, P, C, c, t_pad, hw, lanes, p0 + j, bins_b, vals_b);
  }
  __syncthreads();
  copy_slab<false>(base, slab, rows, P, np, hw, vec);
}

// Launches K3 on the film at `film`, or, where `film_at` is not null, on
// the film whose address `film_at` holds when the kernel runs.
cudaError_t launch(float* film, float* const* film_at, int C, int t_pad,
                   int hw, int lanes, const int32_t* bins_a,
                   const float* vals_a, const int32_t* bins_b,
                   const float* vals_b, void* stream) {
  if (hw <= 0 || lanes <= 0) return cudaGetLastError();
  const int64_t pixel_bytes = (int64_t)4 * C * t_pad;
  if (pixel_bytes > MAX_SHARED_BYTES) return cudaErrorInvalidValue;
  int P = 1;
  while (P < MAX_PIXELS && 2 * P * pixel_bytes <= SLAB_BYTES) P *= 2;
  const int64_t smem = pixel_bytes * P;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (hw + P - 1) / P;
  splat_kernel<<<grid, BLOCK, (size_t)smem, (cudaStream_t)stream>>>(
      film, film_at, C, t_pad, hw, lanes, P, bins_a, vals_a, bins_b, vals_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// film: (C, t_pad, hw) f32, updated in place; bins_*: (lanes * hw,) int32;
// vals_*: (lanes * hw, C) f32.  bins_b and vals_b may be null (one event
// set).  One pixel's slab, C * t_pad floats, must fit in shared memory.
int mitr_splat_accumulate(float* film, int C, int t_pad, int hw, int lanes,
                          const int32_t* bins_a, const float* vals_a,
                          const int32_t* bins_b, const float* vals_b,
                          void* stream) {
  return (int)launch(film, nullptr, C, t_pad, hw, lanes, bins_a, vals_a,
                     bins_b, vals_b, stream);
}

// The same splat into the film whose address the 8 bytes at `film_at` hold
// when the kernel runs (8-byte aligned): a splat captured into a CUDA graph
// keeps its arguments, so the multi-pass render's pass graph
// (passgraph.py) writes each render's own film's address there.
int mitr_splat_accumulate_at(float* const* film_at, int C, int t_pad, int hw,
                             int lanes, const int32_t* bins_a,
                             const float* vals_a, const int32_t* bins_b,
                             const float* vals_b, void* stream) {
  if (reinterpret_cast<uintptr_t>(film_at) % 8)
    return (int)cudaErrorInvalidValue;
  return (int)launch(nullptr, film_at, C, t_pad, hw, lanes, bins_a, vals_a,
                     bins_b, vals_b, stream);
}

}  // extern "C"
