// Reproducible table-gradient reduction for Hopper (sm_90a): kernel K8.
//
// The backward of the port's differentiable row gather
// (mitransient_tpu_torch/ops/gather.py:gather_rows): the lanes' cotangents
// g (N, C) summed onto the table's rows by their index.  It stands where
// the JAX package transposes a one-hot matmul on the TPU
// (mitransient_tpu/ops/gather.py:table_lookup, whose gradient is a dense
// matmul: "no scatters in the backward pass", integrators/prb.py:15-22);
// there is no Pallas kernel of it.  PyTorch's own backward of index_select
// is index_add_, which lands every lane by atomics on a few rows: slow
// under contention, and its order changes from run to run.
//
// Bound: memory.  The least traffic is g and the indices read once and the
// table written once, N * (4C + 4) + 4 * rows * C bytes.
//
// The order is fixed, the plain version's (ops/gather.py) bit for bit;
// tree32 is a warp's __shfl_down_sync halving tree, x[i] + x[i + 16], then
// + 8, + 4, + 2, + 1:
//  (a) rows <= 128: one block of 1024 threads a tile of 1024 lanes, one
//      lane a thread.  For each channel, each warp sums its 32 lanes by
//      tree32 once for every row its lanes read (lanes of other rows add
//      +0), into a shared (row, warp) table that starts at +0; then one
//      warp a row sums the 32 warps' sums by tree32 into the tile's
//      partial (+0 for a row the tile does not read).  The partials
//      (tiles, rows * C) are then summed over the tiles by sum_rows' tree,
//      y[j] = x[j] + x[j + h], h = n / 2, an odd row carried to y[h]: one
//      block a column with the tiles in shared memory (levels of more than
//      SUM_MAX tiles first run one launch a level between two buffers).
//  (b) rows > 128: the wrapper sorts the indices (stable, on the card) and
//      finds each row's run.  A warp then evaluates each nonempty row's
//      levels depth first: the run's groups of 32 (from its start, +0 past
//      its end) summed by tree32 into level 1, level l's groups of 32 into
//      level l + 1, up to the level count the wrapper gives; acc[l] holds
//      the group of level l being filled, lane k its k-th value.  A level
//      value past the end of its level is +0 in the plain version's
//      order, as a tree of +0 is here, so the result is the same.
// No atomics add floats, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int GROUP = 32;
constexpr int WARPS = TILE / GROUP;
constexpr int TILE_MAX_ROWS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LEVEL_BLOCK = 256;
constexpr int SUM_MAX = 12288;  // tiles one block sums in shared memory
constexpr int MAX_LEVELS = 8;   // regime (b): 32^8 lanes

__device__ __forceinline__ float tree32(float x) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
  return x;
}

// Regime (a): the partial (rows, C) of tile blockIdx.x into part.
__global__ void __launch_bounds__(TILE)
tile_partials_kernel(const float* __restrict__ g,
                     const int32_t* __restrict__ idx, int64_t n, int C,
                     int rows, float* __restrict__ part) {
  __shared__ float group_sum[TILE_MAX_ROWS * WARPS];  // [row][warp]
  __shared__ unsigned present[TILE_MAX_ROWS / 32];    // rows the tile reads
  const int t = threadIdx.x, w = t / GROUP, ln = t % GROUP;
  const int64_t lane = (int64_t)blockIdx.x * TILE + t;
  const bool in = lane < n;
  const int r_l = in ? __ldg(idx + lane) : -1;
  if (t < TILE_MAX_ROWS / 32) present[t] = 0u;
  __syncthreads();
  if (in) atomicOr(&present[r_l >> 5], 1u << (r_l & 31));
  float* out = part + (int64_t)blockIdx.x * rows * C;
  for (int c = 0; c < C; ++c) {
    for (int i = t; i < rows * WARPS; i += TILE) group_sum[i] = 0.0f;
    __syncthreads();
    const float v = in ? __ldg(g + lane * C + c) : 0.0f;
    unsigned todo = __ballot_sync(FULL, in);
    while (todo) {  // one pass for every row the warp's lanes read
      const int r = __shfl_sync(FULL, r_l, __ffs(todo) - 1);
      const bool mine = in && r_l == r;
      const float s = tree32(mine ? v : 0.0f);
      if (ln == 0) group_sum[r * WARPS + w] = s;
      todo &= ~__ballot_sync(FULL, mine);
    }
    __syncthreads();
    for (int r = w; r < rows; r += WARPS) {  // warp-uniform
      float s = 0.0f;
      if ((present[r >> 5] >> (r & 31)) & 1u)
        s = tree32(group_sum[r * WARPS + ln]);
      if (ln == 0) out[r * C + c] = s;
    }
    __syncthreads();  // before the next channel clears group_sum
  }
}

// sum_rows' tree over the m <= SUM_MAX rows of x (m, cols), column
// blockIdx.x, into out[blockIdx.x].
__global__ void __launch_bounds__(TILE)
sum_tiles_kernel(const float* __restrict__ x, int64_t m, int64_t cols,
                 float* __restrict__ out) {
  __shared__ float v[SUM_MAX];
  const int64_t col = blockIdx.x;
  for (int64_t j = threadIdx.x; j < m; j += TILE) v[j] = x[j * cols + col];
  __syncthreads();
  while (m > 1) {
    const int64_t h = m / 2;
    for (int64_t j = threadIdx.x; j < h; j += TILE) v[j] = v[j] + v[j + h];
    __syncthreads();
    if ((m & 1) && threadIdx.x == 0) v[h] = v[2 * h];
    __syncthreads();
    m = h + (m & 1);
  }
  if (threadIdx.x == 0) out[col] = v[0];
}

// One level of sum_rows' tree over the rows of x (n, cols) into y.
__global__ void halve_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int64_t n,
                             int64_t cols) {
  const int64_t h = n / 2, m = h + (n & 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < m * cols; i += stride) {
    const int64_t j = i / cols, k = i - j * cols;
    y[i] = j < h ? x[j * cols + k] + x[(j + h) * cols + k]
                 : x[2 * h * cols + k];
  }
}

// Places the level-l value s (every lane holds it) into lane cnt[l] of
// acc[l]; a full group is summed by tree32 into level l + 1, and so on up.
__device__ __forceinline__ void push(float* acc, int* cnt, int l, float s,
                                     int ln) {
  while (true) {
    if (ln == cnt[l]) acc[l] = s;
    if (++cnt[l] < GROUP) return;
    s = __shfl_sync(FULL, tree32(acc[l]), 0);
    acc[l] = 0.0f;
    cnt[l] = 0;
    ++l;
  }
}

// Regime (b): row r's run, g[perm[start[r]]] .. g[perm[start[r + 1] - 1]],
// summed through `levels` levels into out[r] (which starts at +0; an empty
// row is left so).  A warp takes 32 rows at a time, finds the nonempty ones
// with one coalesced read of their offsets, and sums each in turn.  A run
// of at most 32 is one group: its tree32, then + 0 for every further level
// (a tree32 of one value v and 31 zeros is v + 0, and v + 0 + 0 = v + 0).
__global__ void __launch_bounds__(LEVEL_BLOCK)
run_tree_kernel(const float* __restrict__ g, const int64_t* __restrict__ perm,
                int C, int64_t rows, const int64_t* __restrict__ start,
                int levels, float* __restrict__ out) {
  const int ln = threadIdx.x % GROUP;
  const int64_t warp = ((int64_t)blockIdx.x * LEVEL_BLOCK + threadIdx.x) / GROUP;
  const int64_t stride = (int64_t)gridDim.x * (LEVEL_BLOCK / GROUP) * GROUP;
  for (int64_t base = warp * GROUP; base < rows; base += stride) {
    const int64_t r_l = base + ln;
    const int64_t s_l = r_l < rows ? start[r_l] : 0;
    const int64_t e_l = r_l < rows ? start[r_l + 1] : 0;
    unsigned todo = __ballot_sync(FULL, e_l > s_l);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t s = __shfl_sync(FULL, s_l, j);
      const int64_t e = __shfl_sync(FULL, e_l, j);
      float* o = out + (base + j) * C;
      if (e - s <= GROUP) {
        const bool in = s + ln < e;
        const int64_t at = in ? __ldg(perm + s + ln) * C : 0;
        for (int c = 0; c < C; ++c) {
          float t = tree32(in ? __ldg(g + at + c) : 0.0f);
          if (levels > 1) t = t + 0.0f;
          if (ln == 0) o[c] = t;
        }
        continue;
      }
      for (int c = 0; c < C; ++c) {
        float acc[MAX_LEVELS + 1];
        int cnt[MAX_LEVELS + 1];
        for (int l = 0; l <= MAX_LEVELS; ++l) {
          acc[l] = 0.0f;
          cnt[l] = 0;
        }
        for (int64_t i0 = s; i0 < e; i0 += GROUP) {
          const int64_t i = i0 + ln;
          const float v = i < e ? __ldg(g + __ldg(perm + i) * C + c) : 0.0f;
          push(acc, cnt, 1, __shfl_sync(FULL, tree32(v), 0), ln);
        }
        for (int l = 1; l < levels; ++l)  // the groups still filling
          if (cnt[l] > 0)
            push(acc, cnt, l + 1, __shfl_sync(FULL, tree32(acc[l]), 0), ln);
        if (ln == 0) o[c] = acc[levels];
      }
    }
  }
}

int blocks_for(int64_t work, int per_block) {
  const int64_t b = (work + per_block - 1) / per_block;
  return (int)(b < 65535 * 16 ? (b > 0 ? b : 1) : 65535 * 16);
}

}  // namespace

extern "C" {

// Regime (a).  g: (n, C) f32; idx: (n,) int32 in [0, rows), rows <= 128;
// part: (tiles, rows * C) and scratch: ((tiles + 1) / 2, rows * C) f32
// workspaces, tiles = ceil(n / 1024); out: (rows, C) f32.
int mitr_reduce_rows_tiles(const float* g, const int32_t* idx, int64_t n,
                           int C, int rows, float* part, float* scratch,
                           float* out, void* stream) {
  if (rows > TILE_MAX_ROWS || rows <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + TILE - 1) / TILE;
  const int64_t cols = (int64_t)rows * C;
  tile_partials_kernel<<<(unsigned)tiles, TILE, 0, s>>>(g, idx, n, C, rows,
                                                        part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* x = part;
  float* y = scratch;
  int64_t m = tiles;
  for (; m > SUM_MAX; m = m / 2 + (m & 1)) {
    const int64_t work = (m / 2 + (m & 1)) * cols;
    halve_kernel<<<blocks_for(work, 256), 256, 0, s>>>(x, y, m, cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = x;
    x = y;
    y = tmp;
  }
  sum_tiles_kernel<<<(unsigned)cols, TILE, 0, s>>>(x, m, cols, out);
  return (int)cudaGetLastError();
}

// Regime (b).  g: (n, C) f32; perm: (n,) int64, the stable sort of the
// indices; start: (rows + 1,) int64, each row's first sorted position
// (start[rows] = n); levels: 1 to MAX_LEVELS, with 32^levels >= n; out:
// (rows, C) f32, zeroed.
int mitr_reduce_rows_runs(const float* g, const int64_t* perm, int C,
                          int64_t rows, const int64_t* start, int levels,
                          float* out, void* stream) {
  if (rows <= 0 || C <= 0 || levels < 1 || levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  // a warp takes 32 rows at a time
  const int blocks = blocks_for((rows + GROUP - 1) / GROUP,
                                LEVEL_BLOCK / GROUP);
  run_tree_kernel<<<blocks, LEVEL_BLOCK, 0, (cudaStream_t)stream>>>(
      g, perm, C, rows, start, levels, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
