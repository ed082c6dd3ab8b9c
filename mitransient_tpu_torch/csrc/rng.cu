// Threefry-2x32 uniform draws for Hopper (sm_90a): the sample streams.
//
// Reproduces mitransient_tpu/core/rng.py:uniform, that is
// jax.random.uniform with jax_threefry_partitionable on.  The JAX package
// has no hand-written counterpart (jax.random is XLA's); this kernel
// replaces the port's plain version (core/rng.py:_uniform_plain), a chain
// of ~170 eager int64 operations, for draws on the card.  Number j of a
// launch is flat index i = base + j of the whole draw: the counter
// (i >> 32, i & 0xFFFFFFFF) runs 20 rounds under the key schedule
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), and the top 23 bits of the two output
// words' xor are the mantissa of a float32 in [1, 2), minus 1 (exact).
//
// Bound: operations.  A number reads nothing and writes 4 bytes, but takes
// about 80 32-bit integer instructions (20 rounds of add, funnel-shift
// rotate and xor, 5 key injections, the float), against the H100's 64
// INT32 lanes a clock an SM: some 20x the time of the write.  The int64
// chain it replaces was bound by memory instead, each of its launches
// streaming 8-byte tensors through HBM.
//
// This design: everything in registers, in uint32 words, the rotations as
// __funnelshift_l.  A thread draws VEC = 4 consecutive numbers, four
// independent chains that hide the ALU's latency, and stores them as one
// float4; a grid-stride loop over a grid of a few waves of the card.  The
// 64-bit counter is formed per number, so the carry into the high word at
// i = 2^32 is exact.  A `rows=` slice moves only `base`: the output is the
// wrapper's own 16-byte aligned allocation, so only its last vector can be
// partial, and that one is stored number by number.
//
// The key.  A draw is uniform(fold_in(K, dim), ...), K the stream key of a
// pass (core/rng.py:pass_keys), read from two uint32 words in device memory
// when the kernel runs, and dim an argument.  So a launch captured into a
// CUDA graph draws under whatever key its owner copies into those words
// before a replay (passgraph.py).  The first thread of a block folds dim
// into K, one threefry of the counter (0, dim) under K, and shares the
// result through shared memory before the grid-stride loop: at the draws
// of a pass a thread draws only ~3 vectors, and a fold in every thread
// added ~10 % to the kernel's time (one warp of eight folds instead).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int VEC = 4;
constexpr int WAVES = 4;  // a grid is at most 4x the blocks the card holds
constexpr int THREADS_PER_SM = 2048;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with the rotations a, b, c, d.
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int a,
                                       int b, int c, int d) {
  x0 += x1;
  x1 = rotl(x1, a) ^ x0;
  x0 += x1;
  x1 = rotl(x1, b) ^ x0;
  x0 += x1;
  x1 = rotl(x1, c) ^ x0;
  x0 += x1;
  x1 = rotl(x1, d) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key schedule
// (k0, k1, k2) into (x0, x1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += k0;
  x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, uint32_t k2,
                                      uint64_t i) {
  uint32_t x0 = (uint32_t)(i >> 32);
  uint32_t x1 = (uint32_t)i;
  threefry(k0, k1, k2, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// Numbers base .. base + n - 1 of the draw under fold_in(key, dim) into out.
__global__ void __launch_bounds__(BLOCK)
threefry_uniform_kernel(float* __restrict__ out, int64_t n, uint64_t base,
                        const uint32_t* __restrict__ key, uint32_t dim) {
  __shared__ uint32_t folded[2];
  if (threadIdx.x == 0) {  // fold_in: the counter (0, dim) under key
    const uint32_t s0 = __ldg(key), s1 = __ldg(key + 1);
    uint32_t x0 = 0, x1 = dim;
    threefry(s0, s1, s0 ^ s1 ^ KS_PARITY, x0, x1);
    folded[0] = x0;
    folded[1] = x1;
  }
  __syncthreads();
  const uint32_t k0 = folded[0], k1 = folded[1];
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  const int64_t slots = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * BLOCK;
  for (int64_t s = (int64_t)blockIdx.x * BLOCK + threadIdx.x; s < slots;
       s += stride) {
    const int64_t j = s * VEC;
    const uint64_t i = base + (uint64_t)j;
    float4 u;
    u.x = draw(k0, k1, k2, i);
    u.y = draw(k0, k1, k2, i + 1);
    u.z = draw(k0, k1, k2, i + 2);
    u.w = draw(k0, k1, k2, i + 3);
    if (j + VEC <= n) {
      *reinterpret_cast<float4*>(out + j) = u;
    } else {  // the last vector, partial
      out[j] = u.x;
      if (j + 1 < n) out[j + 1] = u.y;
      if (j + 2 < n) out[j + 2] = u.z;
    }
  }
}

// The grid of a launch over n numbers: one thread a vector, at most WAVES
// waves of the card's resident blocks.
cudaError_t grid_for(int64_t n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t slots = (n + VEC - 1) / VEC;
  const int64_t most = (int64_t)sms * (THREADS_PER_SM / BLOCK) * WAVES;
  const int64_t need = (slots + BLOCK - 1) / BLOCK;
  *grid = (int)(need < most ? need : most);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out: (n,) f32, 16-byte aligned; numbers base .. base + n - 1 of the draw
// under fold_in(K, dim), K the two uint32 words at key (4-byte aligned) when
// the kernel runs.  n = 0 launches nothing.
int mitr_threefry_uniform(float* out, int64_t n, int64_t base,
                          const uint32_t* key, uint32_t dim, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(key) % 4)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = grid_for(n, &grid);
  if (err != cudaSuccess) return (int)err;
  threefry_uniform_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      out, n, (uint64_t)base, key, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"
