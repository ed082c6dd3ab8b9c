// Ray queries through the chunked acceleration structure for Hopper
// (sm_90a): one thread per ray, one launch per query, two modes.
//
// Replaces the four TPU kernels of mitransient_tpu/ops/bvh_pallas.py and
// their pass loop: chunk mode (bvh_tree_kernel) covers _select_kernel (K5)
// and _sweep_kernel (K4), super mode (bvh_super_kernel) covers
// _select_super_kernel (K7) and _sweep_super_kernel (K6).  On the TPU a
// query is select -> sort -> sweep passes over ray tiles, because a TPU
// lane has no control flow of its own.  Here a thread owns a ray and visits
// its chunks in the order of ops/bvh.py:query_plain, the reference: the
// valid chunks (slab test tn <= tf) by increasing (entry tn, chunk id),
// each swept while tn < best_t, the first one with tn >= best_t ending the
// query.  The library is built with --fmad=false, so every product and sum
// is rounded on its own, as written, and t and prim are bit-equal to
// query_plain's.
//
// Chunk mode: best-first traversal of the chunk tree (ops/accel.py:
// chunk_tree).  Finding each next chunk by a slab test of all C chunk
// boxes, as the plain version does, costs 1443 box tests for 45 triangle
// tests per ray in cbox_mesh: a kernel doing so is bound by that scan.
// Instead a thread keeps a small priority queue of tree nodes keyed by
// (tn, node): it pops the least key, stops once that key's tn >= best_t,
// sweeps a leaf, and for an inner node slab-tests both children and queues
// each with tn <= tf and tn < best_t.  Why the swept sequence is the
// reference's, bit for bit:
//  - The slab arithmetic (b - o) * inv, then min/max, is monotone in b
//    under rounding, and a node's box is the exact min/max of its
//    children's boxes, so a node's [tn, tf] contains each descendant's
//    exactly: a node that fails the test has no leaf that passes it.
//  - Queued nodes never contain one another, and in preorder numbering the
//    lower of two such nodes covers the lower chunk ids, so (tn, node)
//    orders them as (tn, first chunk id) does, and a node's key is never
//    above any leaf key below it.
//  - So best-first pops the leaves in increasing (tn, chunk id), as the
//    reference picks them, and a leaf is swept exactly when tn < best_t at
//    its turn, the reference's rule.  An unordered stack with a tie rule
//    would not do: a triangle whose Woop t rounds below its chunk's tn can
//    make the visiting order matter.
// A full queue: the ray goes on with the linear pick from its gate, the
// (tn, chunk) of its last swept leaf.  That continues the same sequence,
// so it stays exact; the optional stats buffer counts such rays.
//
// Super mode picks linearly: the block stages the chunk and super-chunk
// bounds into dynamic shared memory (23.1 KB at 745 chunks), and each pick
// slab-tests all S super boxes (broadcast reads) before sweeping the
// super-chunk's chunks that pass.
//
// Memory: tree nodes (28 bytes each, 41.7 KB at 745 chunks) and the chunk
// tables are read through the read-only cache; the queue lives in shared
// memory, one column per thread, so chunk mode takes any number of chunks.
// Pages are read as four float4 per triangle (16 floats: A row-major, prim
// id, c, spare), the next triangle's ahead of the current test; at 261k
// triangles their 24 MB stay in the 50 MB L2.
//
// Bound: operations.  The function needs each box tested at most once per
// ray: in cbox_mesh ~4 box tests (~23 flops) and ~45 Woop tests (~40
// flops) per ray; the bytes per ray are the 29 of the ray and 8 of the
// result.  With the tree the sweeps dominate, and divergence keeps the
// kernel from the bound: most rays sweep a few wall triangles, a few sweep
// hundreds of sphere triangles, and a warp runs as long as its longest
// ray, its threads reading different pages.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;       // super mode
constexpr int TREE_BLOCK = 64;   // chunk mode: a block's slowest warp holds
                                 // its resources, so small blocks
constexpr int QUEUE = 16;        // queue entries per ray (8 KB a block)
constexpr int SUPER_CHUNKS = 8;
constexpr float RAY_EPS = 1e-4f;
constexpr float BIG = 3.0e38f;
constexpr int MAX_SHARED_BYTES = 232448;

struct RayQ {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

__device__ __forceinline__ void slab6(float x0, float y0, float z0, float x1,
                                      float y1, float z1, const RayQ& r,
                                      float& tn, float& tf) {
  const float t0x = (x0 - r.ox) * r.ix;
  const float t0y = (y0 - r.oy) * r.iy;
  const float t0z = (z0 - r.oz) * r.iz;
  const float t1x = (x1 - r.ox) * r.ix;
  const float t1y = (y1 - r.oy) * r.iy;
  const float t1z = (z1 - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
             fmaxf(fminf(t0z, t1z), RAY_EPS));
  tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Slab test of box k of a (6, stride) bounds table in shared memory.
__device__ __forceinline__ void slab(const float* s, int stride, int k,
                                     const RayQ& r, float& tn, float& tf) {
  slab6(s[0 * stride + k], s[1 * stride + k], s[2 * stride + k],
        s[3 * stride + k], s[4 * stride + k], s[5 * stride + k], r, tn, tf);
}

// Slab test of chunk k, its bounds read from the (C, 3) tables.
__device__ __forceinline__ void slab_chunk(const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           int k, const RayQ& r, float& tn,
                                           float& tf) {
  slab6(__ldg(lo + 3 * k), __ldg(lo + 3 * k + 1), __ldg(lo + 3 * k + 2),
        __ldg(hi + 3 * k), __ldg(hi + 3 * k + 1), __ldg(hi + 3 * k + 2), r,
        tn, tf);
}

// Slab test of tree node k, a (K, 6) row: three 8-byte aligned float2.
__device__ __forceinline__ void slab_node(const float* __restrict__ box,
                                          int k, const RayQ& r, float& tn,
                                          float& tf) {
  const float2* b = reinterpret_cast<const float2*>(box + 6 * k);
  const float2 a0 = __ldg(b), a1 = __ldg(b + 1), a2 = __ldg(b + 2);
  slab6(a0.x, a0.y, a1.x, a1.y, a2.x, a2.y, r, tn, tf);
}

// Woop test of the used rows of chunk c's page, in triangle order.  Returns
// true when an any-hit ray found its hit (best_t is then -BIG).  The next
// triangle's record is loaded before the current one is tested, so its
// latency (the pages sit in L2) overlaps the arithmetic.
__device__ __forceinline__ bool sweep_page(const float4* __restrict__ pages,
                                           int c, int used_rows,
                                           int page_rows, const RayQ& r,
                                           bool any_hit, float& best_t,
                                           int32_t& best_p) {
  const float4* tri = pages + (size_t)c * page_rows * 32;  // 32 float4 a row
  const int n_tris = used_rows * 8;
  if (n_tris == 0) return false;
  float4 q0 = __ldg(tri + 0), q1 = __ldg(tri + 1), q2 = __ldg(tri + 2),
         q3 = __ldg(tri + 3);
  for (int k = 0; k < n_tris; ++k) {
    tri += 4;
    const bool more = k + 1 < n_tris;
    const float4 p0 = more ? __ldg(tri + 0) : q0;
    const float4 p1 = more ? __ldg(tri + 1) : q1;
    const float4 p2 = more ? __ldg(tri + 2) : q2;
    const float4 p3 = more ? __ldg(tri + 3) : q3;
    const float rz = q1.z * r.dx + q1.w * r.dy + q2.x * r.dz;
    const bool rz_ok = fabsf(rz) > 1e-12f;
    const float sz = q1.z * r.ox + q1.w * r.oy + q2.x * r.oz - q3.x;
    const float tt = -sz / (rz_ok ? rz : 1.0f);
    const float rx = q0.x * r.dx + q0.y * r.dy + q0.z * r.dz;
    const float sx = q0.x * r.ox + q0.y * r.oy + q0.z * r.oz - q2.z;
    const float u = sx + tt * rx;
    const float ry = q0.w * r.dx + q1.x * r.dy + q1.y * r.dz;
    const float sy = q0.w * r.ox + q1.x * r.oy + q1.y * r.oz - q2.w;
    const float v = sy + tt * ry;
    if (rz_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > RAY_EPS &&
        tt < best_t) {
      best_t = tt;
      best_p = (int32_t)q2.y;
      if (any_hit) {
        best_t = -BIG;
        return true;
      }
    }
    q0 = p0;
    q1 = p1;
    q2 = p2;
    q3 = p3;
  }
  return false;
}

__device__ __forceinline__ RayQ load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d, int i) {
  RayQ r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// min(maxt, BIG) keeps NaN, as jnp.minimum does; inactive rays hit nothing
__device__ __forceinline__ float start_t(const float* __restrict__ maxt,
                                         const uint8_t* __restrict__ active,
                                         int i) {
  const float mt = maxt[i];
  return active[i] ? (mt > BIG ? BIG : mt) : -BIG;
}

// A queue key: tn >= RAY_EPS > 0, so its bits order as the float does and
// the 64-bit key orders lexicographically by (tn, node).
__device__ __forceinline__ uint64_t make_key(float tn, int node) {
  return ((uint64_t)__float_as_uint(tn) << 32) | (uint32_t)node;
}

// Inserts key into a thread's queue (q[k * TREE_BLOCK], sorted, the least
// key at q[nq - 1]); false when the queue is full.
__device__ __forceinline__ bool push(uint64_t* q, int& nq, uint64_t key) {
  if (nq == QUEUE) return false;
  int j = nq++;
  for (; j > 0 && q[(j - 1) * TREE_BLOCK] < key; --j)
    q[j * TREE_BLOCK] = q[(j - 1) * TREE_BLOCK];
  q[j * TREE_BLOCK] = key;
  return true;
}

// Adds per-warp sums of the per-ray counts into stats[0..2]: box tests,
// triangle tests, rays whose queue overflowed.
__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          unsigned boxes, unsigned tris,
                                          unsigned overflow) {
  const unsigned mask = __activemask();
  boxes = __reduce_add_sync(mask, boxes);
  tris = __reduce_add_sync(mask, tris);
  overflow = __reduce_add_sync(mask, overflow);
  if ((threadIdx.x & 31) == __ffs(mask) - 1) {
    atomicAdd(stats + 0, (unsigned long long)boxes);
    atomicAdd(stats + 1, (unsigned long long)tris);
    atomicAdd(stats + 2, (unsigned long long)overflow);
  }
}

__global__ void __launch_bounds__(TREE_BLOCK)
bvh_tree_kernel(const float* __restrict__ aabb_min,
                const float* __restrict__ aabb_max,
                const float* __restrict__ rows,
                const float* __restrict__ tree_box,
                const int32_t* __restrict__ tree_link,
                const float4* __restrict__ pages, int n_chunks, int page_rows,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ maxt,
                const uint8_t* __restrict__ active, int n, int n_closest,
                float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                unsigned long long* __restrict__ stats) {
  // queue of thread t: q[k * TREE_BLOCK], sorted, the least key at q[nq - 1]
  __shared__ uint64_t s_queue[QUEUE * TREE_BLOCK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // no barrier in this kernel
  uint64_t* q = s_queue + threadIdx.x;
  const RayQ r = load_ray(o, d, i);
  float best_t = start_t(maxt, active, i);
  int32_t best_p = -1;
  const bool any_hit = i >= n_closest;
  unsigned n_box = 1, n_tri = 0;
  bool overflow = false, done = false;
  float gate_e = -__int_as_float(0x7f800000);  // -inf
  int gate_k = -1;

  float tn, tf;
  slab_node(tree_box, 0, r, tn, tf);
  int nq = 0;
  uint64_t cur = make_key(tn, 0);
  bool have = tn <= tf && tn < best_t;
  while (have) {
    const float cur_t = __uint_as_float((uint32_t)(cur >> 32));
    if (!(cur_t < best_t)) break;  // every other key is larger
    const int node = (int)(uint32_t)cur;
    const int link = __ldg(tree_link + node);
    if (link < 0) {  // a leaf: sweep chunk -1 - link
      const int c = -1 - link;
      const int used = (int)__ldg(rows + c);
      n_tri += 8 * used;
      gate_e = cur_t;
      gate_k = c;
      if (sweep_page(pages, c, used, page_rows, r, any_hit, best_t, best_p)) {
        done = true;
        break;
      }
    } else {  // an inner node: queue its children that pass
      float ta, fa, tb, fb;
      slab_node(tree_box, node + 1, r, ta, fa);
      slab_node(tree_box, link, r, tb, fb);
      n_box += 2;
      bool va = ta <= fa && ta < best_t;
      bool vb = tb <= fb && tb < best_t;
      uint64_t ka = make_key(ta, node + 1), kb = make_key(tb, link);
      if (vb && (!va || kb < ka)) {  // make a the valid child of least key
        const uint64_t k = ka;
        const bool v = va;
        ka = kb;
        kb = k;
        va = vb;
        vb = v;
      }
      if (vb && !push(q, nq, kb)) {
        overflow = true;
        break;
      }
      if (va && (nq == 0 || ka < q[(nq - 1) * TREE_BLOCK])) {
        cur = ka;  // the least key of all: no need to queue it
        continue;
      }
      if (va && !push(q, nq, ka)) {
        overflow = true;
        break;
      }
    }
    have = nq > 0;
    if (have) cur = q[--nq * TREE_BLOCK];
  }

  // A full queue: the linear pick of the next (tn, chunk) after the gate
  while (overflow && !done) {
    float be = __int_as_float(0x7f800000);
    int bk = -1;
    for (int k = 0; k < n_chunks; ++k) {
      slab_chunk(aabb_min, aabb_max, k, r, tn, tf);
      const bool after = tn > gate_e || (tn == gate_e && k > gate_k);
      if (tn <= tf && tn < best_t && after && tn < be) {
        be = tn;
        bk = k;
      }
    }
    n_box += n_chunks;
    if (bk < 0) break;
    gate_e = be;
    gate_k = bk;
    const int used = (int)__ldg(rows + bk);
    n_tri += 8 * used;
    done = sweep_page(pages, bk, used, page_rows, r, any_hit, best_t, best_p);
  }
  t_out[i] = best_p < 0 ? __int_as_float(0x7f800000) : best_t;
  prim_out[i] = best_p;
  if (stats != nullptr) add_stats(stats, n_box, n_tri, overflow ? 1u : 0u);
}

__global__ void __launch_bounds__(BLOCK)
bvh_super_kernel(const float* __restrict__ aabb_min,
                 const float* __restrict__ aabb_max,
                 const float* __restrict__ rows,
                 const float* __restrict__ sup_min,
                 const float* __restrict__ sup_max,
                 const float4* __restrict__ pages, int n_chunks, int n_supers,
                 int page_rows, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ maxt,
                 const uint8_t* __restrict__ active, int n, int n_closest,
                 float* __restrict__ t_out, int32_t* __restrict__ prim_out) {
  extern __shared__ __align__(16) float smem[];
  float* s_chk = smem;                                            // 6 x C
  int* s_rows = reinterpret_cast<int*>(smem + 6 * n_chunks);      // C
  float* s_sup = smem + 7 * n_chunks;                             // 6 x S
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_chk[a * n_chunks + c] = aabb_min[3 * c + a];
      s_chk[(3 + a) * n_chunks + c] = aabb_max[3 * c + a];
    }
    s_rows[c] = (int)rows[c];
  }
  for (int s = threadIdx.x; s < n_supers; s += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_sup[a * n_supers + s] = sup_min[3 * s + a];
      s_sup[(3 + a) * n_supers + s] = sup_max[3 * s + a];
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // no barrier follows

  const RayQ r = load_ray(o, d, i);
  float best_t = start_t(maxt, active, i);
  int32_t best_p = -1;
  const bool any_hit = i >= n_closest;

  float gate_e = -__int_as_float(0x7f800000);  // -inf
  int gate_k = -1;
  while (true) {
    // the lexicographically next (entry, id) super box after the gate
    float be = __int_as_float(0x7f800000);
    int bk = -1;
    for (int k = 0; k < n_supers; ++k) {
      float tn, tf;
      slab(s_sup, n_supers, k, r, tn, tf);
      const bool after = tn > gate_e || (tn == gate_e && k > gate_k);
      if (tn <= tf && tn < best_t && after && tn < be) {
        be = tn;
        bk = k;
      }
    }
    if (bk < 0) break;
    gate_e = be;
    gate_k = bk;
    bool stop = false;
    for (int cc = 0; cc < SUPER_CHUNKS && !stop; ++cc) {
      const int c = bk * SUPER_CHUNKS + cc;
      if (c >= n_chunks) break;
      float tn, tf;
      slab(s_chk, n_chunks, c, r, tn, tf);
      if (tn <= tf && tn < best_t)
        stop = sweep_page(pages, c, s_rows[c], page_rows, r, any_hit, best_t,
                          best_p);
    }
    if (stop) break;
  }
  t_out[i] = best_p < 0 ? __int_as_float(0x7f800000) : best_t;
  prim_out[i] = best_p;
}

}  // namespace

extern "C" {

// Accel tables as ops/accel.py builds them: aabb_min/max (C, 3), rows (C,)
// f32, sup_min/max (S, 3), pages (C, page_rows, 128) f32, tree_box
// (2C-1, 6) f32, tree_link (2C-1,) int32.  Rays: o, d (n, 3) f32, maxt (n,)
// f32, active (n,) bool; rays i >= n_closest are any-hit rays.  Writes t
// (n,) f32 (inf on a miss, -3e38 for an any-hit ray's hit) and prim (n,)
// int32 (-1 on a miss).  Chunk mode (super_mode 0) reads the tree and not
// sup_*, super mode the reverse.  stats: null, or 3 zeroed uint64 that
// chunk mode adds box tests, triangle tests and overflowed rays into.
int mitr_bvh_query(const float* aabb_min, const float* aabb_max,
                   const float* rows, const float* sup_min,
                   const float* sup_max, const float* tree_box,
                   const int32_t* tree_link, const float* pages, int n_chunks,
                   int n_supers, int page_rows, const float* o, const float* d,
                   const float* maxt, const uint8_t* active, int n,
                   int n_closest, int super_mode, float* t_out,
                   int32_t* prim_out, unsigned long long* stats,
                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* pages4 = reinterpret_cast<const float4*>(pages);
  if (!super_mode) {
    const int grid = (n + TREE_BLOCK - 1) / TREE_BLOCK;
    bvh_tree_kernel<<<grid, TREE_BLOCK, 0, s>>>(
        aabb_min, aabb_max, rows, tree_box, tree_link, pages4, n_chunks,
        page_rows, o, d, maxt, active, n, n_closest, t_out, prim_out, stats);
    return (int)cudaGetLastError();
  }
  const int smem = 4 * (7 * n_chunks + 6 * n_supers);
  if (smem > MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bvh_super_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + BLOCK - 1) / BLOCK;
  bvh_super_kernel<<<grid, BLOCK, smem, s>>>(
      aabb_min, aabb_max, rows, sup_min, sup_max, pages4, n_chunks, n_supers,
      page_rows, o, d, maxt, active, n, n_closest, t_out, prim_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
