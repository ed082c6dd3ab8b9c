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
// The order is fixed, the plain version's (ops/gather.py) bit for bit.
// tree32 is the halving tree over 32 values, x[i] + x[i + 16], then + 8,
// + 4, + 2, + 1 (lane 0's sum of a warp's __shfl_down_sync reduction),
// evaluated here by one thread in registers (tree_at below; leaves absent
// from a sum read as +0), so that no shuffles limit the rate.  Channels go in blocks of at most
// 4 (a launch a block), every channel of a block in one pass.
//  (a) rows <= 128: one block of 256 threads a tile of 1024 lanes; warp w
//      stages the tile's groups of 32 lanes w, w + 8, w + 16, w + 24 in
//      shared memory (channel-major) and forms each group's rows with
//      __match_any_sync.  Then one thread a (group, row, channel) sums the
//      group's 32 values by tree32 in registers (16-byte loads; the other
//      rows' lanes as +0): no shuffles, and a group's cost grows with its
//      rows only by one tree each.  Then one thread a (row, channel) sums
//      the 32 groups' sums by tree32 (+0 for a group without the row) into
//      the tile's partial.  The partials (tiles, rows * C) are summed over
//      the tiles by sum_rows' tree, y[j] = x[j] + x[j + h], h = n / 2, an
//      odd row carried to y[h]: one block a column with the tiles in
//      shared memory (levels of more than SUM_MAX tiles first run one
//      launch a level between two buffers).
//  (b) rows > 128: the wrapper sorts the indices (stable, on the card; as
//      int16 keys where the rows allow, half the radix passes).  One pass
//      over the sorted positions finds each nonempty row's run (its first
//      and last position, by comparing neighbours).  A run is cut into
//      chunks of 1024 positions from its start.  The block of 1024
//      positions where a chunk starts sums it by the two levels of tree32
//      (32 groups of 32 lanes, +0 past the run's end), staged as in (a), so
//      a run of millions is summed by thousands of blocks at once.  A run
//      of at most 32 lanes is summed by its first lane alone, in
//      registers.  A run of at most 1024 lanes ends there; a longer one's
//      chunk sums go to a scratch list, and a block a long run sums them
//      by tree32, level by level, to one value.  A row whose run ends as
//      one value before the plain version's last level takes + 0 once (a
//      tree32 of one value v and 31 zeros is v + 0, and v + 0 + 0 = v + 0).
//      Work is in proportion to the lanes, whatever the longest run.
// No atomics add floats, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int GROUP = 32;
constexpr int GROUPS = TILE / GROUP;  // a tile's groups: 32
constexpr int TILE_MAX_ROWS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CB_MAX = 4;             // channels a pass
constexpr int TILE_THREADS = 256;     // regime (a): a block a tile
constexpr int TILE_WARPS = TILE_THREADS / GROUP;
constexpr int GROUPS_PER_WARP = GROUPS / TILE_WARPS;
constexpr int GROUP_STRIDE = GROUP + 4;  // (a): a group's floats staged
constexpr int RUN_THREADS = 256;      // regime (b)
constexpr int LEVEL_THREADS = 1024;
constexpr int SUM_MAX = 12288;        // tiles one block sums in shared memory
constexpr int MAX_LEVELS = 8;         // regime (b): 32^8 lanes
constexpr int CHUNKS_MAX = 64;        // (b): chunks starting in a block
constexpr int BOUNDS_BLOCKS = 2048;   // (b): a grid-stride pass's blocks

template <int CB>
struct Vec {
  float v[CB];
};

template <int CB>
__device__ __forceinline__ Vec<CB> operator+(Vec<CB> a, const Vec<CB>& b) {
#pragma unroll
  for (int k = 0; k < CB; ++k) a.v[k] = a.v[k] + b.v[k];
  return a;
}

template <int CB>
__device__ __forceinline__ Vec<CB> zeros() {
  Vec<CB> z;
#pragma unroll
  for (int k = 0; k < CB; ++k) z.v[k] = 0.0f;
  return z;
}

// tree32 by one thread: the value lane I holds after the shuffle steps of
// offsets 16 .. O, V(I, O) = V(I, 2 O) + V(I + O, 2 O), V(I, 32) = leaf(I);
// tree_at<0, 1> is lane 0's sum.
template <int I, int O, class Leaf>
__device__ __forceinline__ auto tree_at(const Leaf& leaf) {
  if constexpr (O == GROUP) {
    return leaf(I);
  } else {
    return tree_at<I, 2 * O>(leaf) + tree_at<I + O, 2 * O>(leaf);
  }
}

template <int CB>
__device__ __forceinline__ Vec<CB> load_row(const float* __restrict__ g,
                                            int64_t lane, int C, int cb) {
  Vec<CB> v;
  const float* src = g + lane * C + cb;
#pragma unroll
  for (int k = 0; k < CB; ++k) v.v[k] = __ldg(src + k);
  return v;
}

// tree32 of the 32 staged values vals[j * GROUP_STRIDE ..] (16-byte
// loads), those of lanes outside `mask` as +0.
__device__ __forceinline__ float staged_tree(const float* vals, int j,
                                             unsigned mask) {
  float x[GROUP];
  const float4* src = reinterpret_cast<const float4*>(vals + j * GROUP_STRIDE);
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q) {
    const float4 y = src[q];
    x[4 * q] = y.x;
    x[4 * q + 1] = y.y;
    x[4 * q + 2] = y.z;
    x[4 * q + 3] = y.w;
  }
  return tree_at<0, 1>([&](int i) {
    Vec<1> y;
    y.v[0] = (mask >> i) & 1u ? x[i] : 0.0f;
    return y;
  }).v[0];
}

// ---------------------------------------------------------------- (a)

// Channels [cb, cb + CB) of the partial (rows, C) of tile blockIdx.x
// into part.
template <int CB>
__global__ void __launch_bounds__(TILE_THREADS)
tile_partials_kernel(const float* __restrict__ g,
                     const int32_t* __restrict__ idx, int64_t n, int C,
                     int cb, int rows, float* __restrict__ part) {
  __shared__ unsigned present[TILE_MAX_ROWS];  // bit j: group j reads it
  __shared__ unsigned char slot_of[TILE_MAX_ROWS][GROUPS];
  __shared__ unsigned row_lanes[GROUPS][GROUP];  // [group][slot]: its lanes
  __shared__ int first_slot[GROUPS + 1];  // the groups' slots, in order
  // the tile by channel, a group's 32 values 36 floats apart (16-byte
  // aligned; 8 groups start in 8 bank quads)
  __shared__ __align__(16) float vals[CB][GROUPS * GROUP_STRIDE];
  __shared__ float group_sum[GROUPS][GROUP][CB];  // [group][slot][channel]
  const int t = threadIdx.x, w = t / GROUP, ln = t % GROUP;
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  for (int i = t; i < rows; i += TILE_THREADS) present[i] = 0u;
  int r_u[GROUPS_PER_WARP];
#pragma unroll
  for (int u = 0; u < GROUPS_PER_WARP; ++u) {  // every load in flight
    const int j = w + TILE_WARPS * u;
    const int64_t lane = tile0 + j * GROUP + ln;
    r_u[u] = lane < n ? __ldg(idx + lane) : -1;
    const Vec<CB> v = lane < n ? load_row<CB>(g, lane, C, cb) : zeros<CB>();
#pragma unroll
    for (int k = 0; k < CB; ++k) vals[k][j * GROUP_STRIDE + ln] = v.v[k];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < GROUPS_PER_WARP; ++u) {  // each group's rows
    const int j = w + TILE_WARPS * u;
    const int r = r_u[u];
    const unsigned mask = __match_any_sync(FULL, r);
    const bool leader = r >= 0 && __ffs(mask) - 1 == ln;
    const unsigned leaders = __ballot_sync(FULL, leader);
    if (leader) {
      const int slot = __popc(leaders & ((1u << ln) - 1u));
      slot_of[r][j] = (unsigned char)slot;
      row_lanes[j][slot] = mask;
      atomicOr(&present[r], 1u << j);
    }
    if (ln == 0) first_slot[j + 1] = __popc(leaders);
  }
  __syncthreads();
  if (w == 0) {  // the slots' prefix over the groups
    int c = first_slot[ln + 1];
#pragma unroll
    for (int o = 1; o < GROUP; o <<= 1) {
      const int y = __shfl_up_sync(FULL, c, o);
      if (ln >= o) c += y;
    }
    first_slot[ln + 1] = c;
    if (ln == 0) first_slot[0] = 0;
  }
  __syncthreads();
  // one thread a (channel, group, row): tree32 over the group's 32
  // values, the other rows' lanes as +0
  const int slots = first_slot[GROUPS];
  for (int e = t; e < slots * CB; e += TILE_THREADS) {
    const int k = e / slots, at = e - k * slots;
    int j = 0;
#pragma unroll
    for (int step = GROUPS / 2; step > 0; step >>= 1)
      if (first_slot[j + step] <= at) j += step;
    const int slot = at - first_slot[j];
    group_sum[j][slot][k] = staged_tree(vals[k], j, row_lanes[j][slot]);
  }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * rows * C;
  for (int e = t; e < rows * CB; e += TILE_THREADS) {
    const int r = e / CB, k = e - r * CB;
    const unsigned pm = present[r];
    float s = 0.0f;  // a tree of +0 for a row the tile does not read
    if (pm)
      s = tree_at<0, 1>([&](int jj) {
        Vec<1> x;
        x.v[0] = (pm >> jj) & 1u ? group_sum[jj][slot_of[r][jj] & 31][k]
                                 : 0.0f;
        return x;
      }).v[0];
    out[r * C + cb + k] = s;
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

// ---------------------------------------------------------------- (b)

// Each nonempty row's run [x, y) in the sorted positions: a position
// whose left (right) neighbour holds another row starts (ends) one.  Only
// the rows that some lane reads are written.
template <class Key>
__global__ void run_bounds_kernel(const Key* __restrict__ sidx, int64_t n,
                                  longlong2* __restrict__ bounds) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int r = sidx[p];
    if (p == 0 || sidx[p - 1] != r) bounds[r].x = p;
    if (p == n - 1 || sidx[p + 1] != r) bounds[r].y = p + 1;
  }
}

// Channels [cb, cb + CB).  A block takes 1024 sorted positions.  The first
// position of a run of at most 32 sums it alone, in registers.  Every
// chunk that starts among the block's positions (at most 33: those of 33
// lanes or more start 33 apart, and one shorter last chunk of a long run)
// is summed by the whole block: its lanes staged in shared memory, one
// thread a (group, channel) for level 1, one a channel for level 2.  A
// run's value goes to out (rows, C), zeroed; a long run's chunk k (it
// starts at s, s / 1024 = u) to level[2 u + k] (distinct over the long
// runs, whose chunks number at most 2 (u' - u) before the next one's u'),
// and its row (once, with cb = 0) to list[1 + list[0]++].
template <int CB, class Key>
__global__ void __launch_bounds__(RUN_THREADS)
run_chunks_kernel(const float* __restrict__ g, const Key* __restrict__ sidx,
                  const int64_t* __restrict__ perm, int64_t n, int C,
                  int cb, int levels, const longlong2* __restrict__ bounds,
                  float* __restrict__ level,
                  unsigned long long* __restrict__ list,
                  float* __restrict__ out) {
  __shared__ longlong2 chunk_at[CHUNKS_MAX];  // (its start, its run's end)
  __shared__ int chunk_row[CHUNKS_MAX];
  __shared__ int chunks;
  __shared__ __align__(16) float vals[CB][GROUPS * GROUP_STRIDE];
  __shared__ float group_sum[CB][GROUPS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  if (t == 0) chunks = 0;
  __syncthreads();
  for (int q = 0; q < TILE / RUN_THREADS; ++q) {
    const int64_t p = base + t + q * RUN_THREADS;
    if (p >= n) break;
    const int r = sidx[p];
    const longlong2 b = bounds[r];
    const int64_t s = b.x, len = b.y - b.x;
    if (p == s && len <= GROUP) {  // a short run, in registers
      const Vec<CB> v = tree_at<0, 1>([&](int i) {
        return i < len ? load_row<CB>(g, __ldg(perm + s + i), C, cb)
                       : zeros<CB>();
      });
#pragma unroll
      for (int k = 0; k < CB; ++k)
        out[(int64_t)r * C + cb + k] = levels > 1 ? v.v[k] + 0.0f : v.v[k];
    } else if (len > GROUP && (p - s) % TILE == 0) {
      const int c = atomicAdd(&chunks, 1);
      chunk_at[c] = make_longlong2(p, b.y);
      chunk_row[c] = r;
    }
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {  // block-uniform
    const int64_t c0 = chunk_at[c].x, e = chunk_at[c].y;
    const int r = chunk_row[c];
    const longlong2 b = bounds[r];  // its run's start: a cached line
    const int64_t ce = c0 + TILE < e ? c0 + TILE : e;
#pragma unroll
    for (int q = 0; q < TILE / RUN_THREADS; ++q) {
      const int i = t + q * RUN_THREADS;
      const int64_t p = c0 + i;
      const Vec<CB> v =
          p < ce ? load_row<CB>(g, __ldg(perm + p), C, cb) : zeros<CB>();
#pragma unroll
      for (int k = 0; k < CB; ++k)
        vals[k][(i / GROUP) * GROUP_STRIDE + i % GROUP] = v.v[k];
    }
    __syncthreads();
    if (t < CB * GROUPS) {
      const int k = t / GROUPS, j = t % GROUPS;
      group_sum[k][j] = staged_tree(vals[k], j, FULL);
    }
    __syncthreads();
    if (t < CB) {
      const float v = tree_at<0, 1>([&](int j) {
        Vec<1> y;
        y.v[0] = group_sum[t][j];
        return y;
      }).v[0];
      if (b.y - b.x <= TILE)
        out[(int64_t)r * C + cb + t] = levels > 2 ? v + 0.0f : v;
      else
        level[(2 * (b.x / TILE) + (c0 - b.x) / TILE) * C + cb + t] = v;
    }
    if (t == 0 && cb == 0 && c0 == b.x && b.y - b.x > TILE)
      list[1 + atomicAdd(list, 1ull)] = (unsigned long long)r;
    __syncthreads();  // before the next chunk is staged
  }
}

// A block a long run (list[1 + i], i < list[0]): its chunk sums, in
// level[2 u ...] (level 2), summed by tree32 level by level (groups of 32
// from the run's start, +0 past the level's end; one thread a group and
// channel) between level and spare, until one value is left; + 0 if the
// run ends before the last level.
__global__ void __launch_bounds__(LEVEL_THREADS)
run_levels_kernel(int C, int levels, const longlong2* __restrict__ bounds,
                  float* level, float* spare,
                  const unsigned long long* __restrict__ list,
                  float* __restrict__ out) {
  const unsigned long long runs = list[0];
  for (unsigned long long i = blockIdx.x; i < runs; i += gridDim.x) {
    const int r = (int)list[1 + i];
    const longlong2 b = bounds[r];
    const int64_t base = 2 * (b.x / TILE) * C;
    float* src = level + base;
    float* dst = spare + base;
    int64_t m = (b.y - b.x + TILE - 1) / TILE;
    int l = 2;
    while (m > 1) {
      const int64_t next = (m + GROUP - 1) / GROUP;
      for (int64_t e = threadIdx.x; e < next * C; e += LEVEL_THREADS) {
        const int64_t G = e / C;
        const int k = (int)(e - G * C);
        dst[e] = tree_at<0, 1>([&](int i) {
          const int64_t at = G * GROUP + i;
          Vec<1> y;
          y.v[0] = at < m ? src[at * C + k] : 0.0f;
          return y;
        }).v[0];
      }
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
      m = next;
      ++l;
    }
    for (int k = threadIdx.x; k < C; k += LEVEL_THREADS)
      out[(int64_t)r * C + k] = levels > l ? src[k] + 0.0f : src[k];
    __syncthreads();  // before the next run's reads
  }
}

int blocks_for(int64_t work, int per_block) {
  const int64_t b = (work + per_block - 1) / per_block;
  return (int)(b < 65535 * 16 ? (b > 0 ? b : 1) : 65535 * 16);
}

// Launches K<CB>::launch(cb, args...) for each block of at most CB_MAX
// channels.
template <template <int> class K, class... A>
cudaError_t by_channel_blocks(int C, A... args) {
  for (int cb = 0; cb < C; cb += CB_MAX) {
    const int width = C - cb < CB_MAX ? C - cb : CB_MAX;
    switch (width) {
      case 1: K<1>::launch(cb, args...); break;
      case 2: K<2>::launch(cb, args...); break;
      case 3: K<3>::launch(cb, args...); break;
      default: K<4>::launch(cb, args...); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int CB>
struct Tiles {
  static void launch(int cb, unsigned tiles, cudaStream_t s, const float* g,
                     const int32_t* idx, int64_t n, int C, int rows,
                     float* part) {
    tile_partials_kernel<CB><<<tiles, TILE_THREADS, 0, s>>>(g, idx, n, C, cb,
                                                            rows, part);
  }
};

template <int CB>
struct Chunks {
  template <class Key>
  static void launch(int cb, cudaStream_t s, const float* g, const Key* sidx,
                     const int64_t* perm, int64_t n, int C, int levels,
                     const longlong2* bounds, float* level,
                     unsigned long long* list, float* out) {
    run_chunks_kernel<CB, Key><<<(unsigned)((n + TILE - 1) / TILE),
                                 RUN_THREADS, 0, s>>>(
        g, sidx, perm, n, C, cb, levels, bounds, level, list, out);
  }
};

// Regime (b)'s runs and chunks on sorted keys of type Key.
template <class Key>
cudaError_t runs_and_chunks(const float* g, const Key* sidx,
                            const int64_t* perm, int64_t n, int C,
                            int levels, longlong2* bounds, float* level,
                            unsigned long long* list, float* out,
                            cudaStream_t s) {
  const int blocks = blocks_for(n, 256);
  run_bounds_kernel<Key><<<blocks < BOUNDS_BLOCKS ? blocks : BOUNDS_BLOCKS,
                           256, 0, s>>>(sidx, n, bounds);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return by_channel_blocks<Chunks>(C, s, g, sidx, perm, n, C, levels,
                                   (const longlong2*)bounds, level, list,
                                   out);
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
  cudaError_t err = by_channel_blocks<Tiles>(C, (unsigned)tiles, s, g, idx,
                                             n, C, rows, part);
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

// Regime (b).  g: (n, C) f32; sidx: (n,) the sorted indices, int16 if
// key_bytes is 2 (rows <= 32768), else int32, and perm: (n,) int64, the
// stable sort's permutation; bounds: (rows, 2)
// int64 workspace (need not be initialised); level: (2, slots, C) f32
// workspace, slots = 3 * ceil(n / 1024) + 2; list: (n / 1025 + 2,) int64
// workspace; levels: 1 to MAX_LEVELS, with 32^levels >= n; out: (rows, C)
// f32, zeroed.
int mitr_reduce_rows_runs(const float* g, const void* sidx, int key_bytes,
                          const int64_t* perm, int64_t n, int C,
                          int64_t rows, int levels, int64_t* bounds,
                          float* level, int64_t* list, float* out,
                          void* stream) {
  if (rows <= 0 || C <= 0 || levels < 1 || levels > MAX_LEVELS ||
      (key_bytes != 2 && key_bytes != 4) || (key_bytes == 2 && rows > 32768))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(list, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  longlong2* b = reinterpret_cast<longlong2*>(bounds);
  unsigned long long* lst = reinterpret_cast<unsigned long long*>(list);
  err = key_bytes == 2
            ? runs_and_chunks(g, (const int16_t*)sidx, perm, n, C, levels, b,
                              level, lst, out, s)
            : runs_and_chunks(g, (const int32_t*)sidx, perm, n, C, levels, b,
                              level, lst, out, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t slots = 3 * ((n + TILE - 1) / TILE) + 2;
  const int64_t most = n / (TILE + 1) + 1;  // long runs at most
  run_levels_kernel<<<(unsigned)(most < 264 ? most : 264), LEVEL_THREADS, 0,
                      s>>>(C, levels, b, level, level + slots * C, lst, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
