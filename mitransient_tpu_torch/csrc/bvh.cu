// Ray queries through the chunked acceleration structure for Hopper
// (sm_90a): one thread per ray, one launch per query, two modes.
//
// Replaces the four TPU kernels of mitransient_tpu/ops/bvh_pallas.py and
// their pass loop: chunk mode (bvh_tree_kernel) covers _select_kernel (K5)
// and _sweep_kernel (K4), super mode (bvh_super_kernel) covers
// _select_super_kernel (K7) and _sweep_super_kernel (K6).  On the TPU a
// query is select -> sort -> sweep passes over ray tiles, because a TPU
// lane has no control flow of its own.  Here a thread owns a ray and visits
// its boxes in the order of ops/bvh.py:query_plain, the reference: the
// valid boxes (slab test tn <= tf) by increasing (entry tn, box id), each
// visited while tn < best_t, the first one with tn >= best_t ending the
// query.  The boxes are the chunks in chunk mode and the super-chunks in
// super mode, where a visit slab-tests the super-chunk's <= 8 chunks in id
// order against the current best_t and sweeps each that passes.  The
// library is built with --fmad=false, so every product and sum is rounded
// on its own, as written, and t and prim are bit-equal to query_plain's.
//
// Both modes walk a tree over their boxes best first (BestFirst below;
// ops/accel.py:chunk_tree builds the chunk tree and the super tree).
// Finding each next box by a slab test of all boxes, as the plain version
// does, costs 1443 box tests for 45 triangle tests per ray in cbox_mesh's
// chunk mode and 200 in its super mode: a kernel doing so is bound by that
// scan.  Instead a thread keeps a small priority queue of tree nodes keyed
// by (tn, node): it pops the least key, stops once that key's tn >=
// best_t, visits a leaf, and for an inner node slab-tests both children and
// queues each with tn <= tf and tn < best_t.  Why the visited sequence is
// the reference's, bit for bit:
//  - The slab arithmetic (b - o) * inv, then min/max, is monotone in b
//    under rounding, and a node's box is the exact min/max of its
//    children's boxes, so a node's [tn, tf] contains each descendant's
//    exactly: a node that fails the test has no leaf that passes it.
//  - Queued nodes never contain one another, and in preorder numbering the
//    lower of two such nodes covers the lower leaf ids, so (tn, node)
//    orders them as (tn, first leaf id) does, and a node's key is never
//    above any leaf key below it.
//  - So best-first pops the leaves in increasing (tn, leaf id), as the
//    reference picks them, and a leaf is visited exactly when tn < best_t
//    at its turn, the reference's rule.  An unordered stack with a tie rule
//    would not do: a triangle whose Woop t rounds below its box's tn can
//    make the visiting order matter.
// A full queue: the ray goes on with the linear pick over the leaf boxes
// from its gate, the (tn, leaf) of its last visited leaf.  That continues
// the same sequence, so it stays exact; the optional stats buffer counts
// such rays.
//
// Sweeps.  Chunk mode sweeps a page one thread per ray (sweep_page).  In a
// warp those sweeps diverge: most rays sweep a few wall triangles, a few
// sweep hundreds of sphere triangles, a warp runs as long as its longest
// ray, and its 32 threads read 32 unrelated pages.  Super mode shares its
// sweeps with the warp (warp_sweep): a lane walks until it has a chunk to
// sweep; a ballot collects the lanes that have one; for each in turn its
// ray and chunk are broadcast and the 32 lanes test 32 consecutive triangle
// records a step (coalesced 64-byte records).  The candidates are the hits
// below the best_t at the start of the page; a closest-hit ray takes the
// least (t bits, position) by warp min-reductions (t > RAY_EPS > 0, so the
// bits order as the float does), an any-hit ray the lowest hitting lane of
// the first step that has one.  That is the least t, the first on ties, or
// the first hit: what the sequential strict-< sweep returns.  Lanes past n
// and rays that are done stay in the loop as idle lanes, since the sweeps
// are warp-collective (full-mask shuffles and ballots).
//
// Memory: tree nodes (28 bytes each) and the chunk and super-chunk tables
// are read through the read-only cache; the queue lives in shared memory,
// one column per thread, so either mode takes any number of boxes.  Pages
// are 16 floats a triangle (A row-major, prim id, c, spare), read as four
// float4; at 261k triangles their 24 MB stay in the 50 MB L2.
//
// Bound: operations.  The function needs each box tested at most once per
// ray: in cbox_mesh ~4 box tests (~23 flops) and ~45 Woop tests (~40
// flops) per ray; the bytes per ray are the 29 of the ray and 8 of the
// result.  With the trees the sweeps dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;        // a block's slowest warp holds its
                                 // resources, so small blocks
constexpr int QUEUE = 16;        // queue entries per ray (8 KB a block)
constexpr int SUPER_CHUNKS = 8;
constexpr float RAY_EPS = 1e-4f;
constexpr float BIG = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

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

// Slab test of box k, its bounds read from (K, 3) min and max tables.
__device__ __forceinline__ void slab_box(const float* __restrict__ lo,
                                         const float* __restrict__ hi, int k,
                                         const RayQ& r, float& tn, float& tf) {
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

// Woop test of one triangle record (q0..q3): true on a hit with t >
// RAY_EPS, whatever the far limit; t in tt.
__device__ __forceinline__ bool woop(const float4& q0, const float4& q1,
                                     const float4& q2, const float4& q3,
                                     const RayQ& r, float& tt) {
  const float rz = q1.z * r.dx + q1.w * r.dy + q2.x * r.dz;
  const bool rz_ok = fabsf(rz) > 1e-12f;
  const float sz = q1.z * r.ox + q1.w * r.oy + q2.x * r.oz - q3.x;
  tt = -sz / (rz_ok ? rz : 1.0f);
  const float rx = q0.x * r.dx + q0.y * r.dy + q0.z * r.dz;
  const float sx = q0.x * r.ox + q0.y * r.oy + q0.z * r.oz - q2.z;
  const float u = sx + tt * rx;
  const float ry = q0.w * r.dx + q1.x * r.dy + q1.y * r.dz;
  const float sy = q0.w * r.ox + q1.x * r.oy + q1.y * r.oz - q2.w;
  const float v = sy + tt * ry;
  return rz_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > RAY_EPS;
}

// Woop test of the used rows of chunk c's page, in triangle order, by one
// thread.  Returns true when an any-hit ray found its hit (best_t is then
// -BIG).  The next triangle's record is loaded before the current one is
// tested, so its latency (the pages sit in L2) overlaps the arithmetic.
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
    float tt;
    if (woop(q0, q1, q2, q3, r, tt) && tt < best_t) {
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

// Woop test of the used rows of chunk c's page for one ray, by the whole
// warp: every lane passes the same c, used_rows, r, any_hit and t0 (the
// ray's best_t at the start of the page).  Lane l tests triangles l, l +
// 32, ...; a closest-hit ray takes the least (t, position) below t0, an
// any-hit ray the first hit below t0.  Returns whether there was one, with
// its t and prim in every lane.
__device__ __forceinline__ bool warp_sweep(const float4* __restrict__ pages,
                                           int c, int used_rows,
                                           int page_rows, const RayQ& r,
                                           bool any_hit, float t0,
                                           float& t_hit, int32_t& p_hit) {
  const int lane = threadIdx.x & 31;
  const float4* tri = pages + (size_t)c * page_rows * 32;
  const int n_tris = used_rows * 8;
  float bt = t0;       // this lane's best t, its position and prim
  int bk = 0x7fffffff;
  int32_t bp = -1;
  for (int base = 0; base < n_tris; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < n_tris) {
      const float4* q = tri + 4 * k;
      const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                   q3 = __ldg(q + 3);
      float tt;
      hit = woop(q0, q1, q2, q3, r, tt) && tt < bt;
      if (hit) {
        bt = tt;
        bk = k;
        bp = (int32_t)q2.y;
      }
    }
    if (any_hit) {  // uniform: the first hit of the page is in this step
      const unsigned m = __ballot_sync(FULL, hit);
      if (m != 0) {
        p_hit = __shfl_sync(FULL, bp, __ffs(m) - 1);
        t_hit = -BIG;
        return true;
      }
    }
  }
  if (any_hit) return false;
  // the least t bits, then the least position among the lanes holding it
  const unsigned tb = bk == 0x7fffffff ? 0xffffffffu : __float_as_uint(bt);
  const unsigned t_min = __reduce_min_sync(FULL, tb);
  if (t_min == 0xffffffffu) return false;
  const int k_min = __reduce_min_sync(FULL, tb == t_min ? bk : 0x7fffffff);
  p_hit = __shfl_sync(FULL, bp, k_min & 31);
  t_hit = __uint_as_float(t_min);
  return true;
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

// Inserts key into a thread's queue (q[k * BLOCK], sorted, the least key
// at q[nq - 1]); false when the queue is full.
__device__ __forceinline__ bool push(uint64_t* q, int& nq, uint64_t key) {
  if (nq == QUEUE) return false;
  int j = nq++;
  for (; j > 0 && q[(j - 1) * BLOCK] < key; --j)
    q[j * BLOCK] = q[(j - 1) * BLOCK];
  q[j * BLOCK] = key;
  return true;
}

// One ray's best-first walk of a tree over K leaf boxes (the chunk tree or
// the super tree): next() returns the leaves in increasing (tn, leaf id),
// each while tn < best_t at its turn, then -1.  A full queue hands the ray
// to the linear pick over the (K, 3) leaf tables from its gate.
struct BestFirst {
  const float* box;     // (2K-1, 6) node bounds
  const int32_t* link;  // (2K-1,) right child, or -1 - leaf
  const float* leaf_min;
  const float* leaf_max;
  int n_leaves;
  uint64_t* q;  // this thread's queue: q[k * BLOCK]
  int nq = 0;
  uint64_t cur = 0;     // the least key, kept out of the queue
  bool have = false;    // cur is valid
  bool linear = false;  // the queue filled: picking linearly
  bool overflow = false;
  float gate_e;  // the (tn, leaf) of the last visited leaf
  int gate_k = -1;
  unsigned n_box = 0;

  __device__ __forceinline__ void start(const RayQ& r, float best_t) {
    gate_e = -__int_as_float(0x7f800000);  // -inf
    float tn, tf;
    slab_node(box, 0, r, tn, tf);
    n_box = 1;
    cur = make_key(tn, 0);
    have = tn <= tf && tn < best_t;
  }

  __device__ __forceinline__ void pop() {
    have = nq > 0;
    if (have) cur = q[--nq * BLOCK];
  }

  __device__ __forceinline__ int next(const RayQ& r, float best_t) {
    while (have) {
      const float cur_t = __uint_as_float((uint32_t)(cur >> 32));
      if (!(cur_t < best_t)) return -1;  // every other key is larger
      const int node = (int)(uint32_t)cur;
      const int lk = __ldg(link + node);
      if (lk < 0) {  // a leaf
        gate_e = cur_t;
        gate_k = -1 - lk;
        pop();
        return gate_k;
      }
      float ta, fa, tb, fb;  // an inner node: queue its children that pass
      slab_node(box, node + 1, r, ta, fa);
      slab_node(box, lk, r, tb, fb);
      n_box += 2;
      bool va = ta <= fa && ta < best_t;
      bool vb = tb <= fb && tb < best_t;
      uint64_t ka = make_key(ta, node + 1), kb = make_key(tb, lk);
      if (vb && (!va || kb < ka)) {  // make a the valid child of least key
        const uint64_t k = ka;
        const bool v = va;
        ka = kb;
        kb = k;
        va = vb;
        vb = v;
      }
      if (vb && !push(q, nq, kb)) {
        have = false;
        linear = overflow = true;
        break;
      }
      if (va && (nq == 0 || ka < q[(nq - 1) * BLOCK])) {
        cur = ka;  // the least key of all: no need to queue it
        continue;
      }
      if (va && !push(q, nq, ka)) {
        have = false;
        linear = overflow = true;
        break;
      }
      pop();
    }
    if (!linear) return -1;
    // the linear pick of the next (tn, leaf) after the gate
    float be = __int_as_float(0x7f800000);
    int bk = -1;
    for (int k = 0; k < n_leaves; ++k) {
      float tn, tf;
      slab_box(leaf_min, leaf_max, k, r, tn, tf);
      const bool after = tn > gate_e || (tn == gate_e && k > gate_k);
      if (tn <= tf && tn < best_t && after && tn < be) {
        be = tn;
        bk = k;
      }
    }
    n_box += n_leaves;
    linear = bk >= 0;
    gate_e = be;
    gate_k = bk;
    return bk;
  }
};

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

__global__ void __launch_bounds__(BLOCK)
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
  __shared__ uint64_t s_queue[QUEUE * BLOCK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // no barrier in this kernel
  const RayQ r = load_ray(o, d, i);
  float best_t = start_t(maxt, active, i);
  int32_t best_p = -1;
  const bool any_hit = i >= n_closest;
  unsigned n_tri = 0;
  BestFirst w{tree_box, tree_link, aabb_min, aabb_max, n_chunks,
              s_queue + threadIdx.x};
  w.start(r, best_t);
  for (int c; (c = w.next(r, best_t)) >= 0;) {
    const int used = (int)__ldg(rows + c);
    n_tri += 8 * used;
    if (sweep_page(pages, c, used, page_rows, r, any_hit, best_t, best_p))
      break;
  }
  t_out[i] = best_p < 0 ? __int_as_float(0x7f800000) : best_t;
  prim_out[i] = best_p;
  if (stats != nullptr) add_stats(stats, w.n_box, n_tri, w.overflow);
}

__global__ void __launch_bounds__(BLOCK)
bvh_super_kernel(const float* __restrict__ aabb_min,
                 const float* __restrict__ aabb_max,
                 const float* __restrict__ rows,
                 const float* __restrict__ sup_min,
                 const float* __restrict__ sup_max,
                 const float* __restrict__ sup_tree_box,
                 const int32_t* __restrict__ sup_tree_link,
                 const float4* __restrict__ pages, int n_chunks, int n_supers,
                 int page_rows, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ maxt,
                 const uint8_t* __restrict__ active, int n, int n_closest,
                 float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                 unsigned long long* __restrict__ stats) {
  __shared__ uint64_t s_queue[QUEUE * BLOCK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // No early return: a lane past n is an idle lane of the warp's sweeps.
  const bool live = i < n;
  RayQ r = {0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 1e12f, 1e12f, 1.f};
  if (live) r = load_ray(o, d, i);
  float best_t = live ? start_t(maxt, active, i) : -BIG;
  int32_t best_p = -1;
  const bool any_hit = i >= n_closest;
  unsigned n_tri = 0;
  BestFirst w{sup_tree_box, sup_tree_link, sup_min, sup_max, n_supers,
              s_queue + threadIdx.x};
  if (live) w.start(r, best_t);  // a lane past n counts no box test
  int next_c = 0, end_c = 0;  // chunks of the visited super-chunk left
  bool done = !live;
  while (true) {
    // walk on to this lane's next chunk to sweep
    int pending = -1;
    while (!done && pending < 0) {
      if (next_c < end_c) {
        const int c = next_c++;
        float tn, tf;
        slab_box(aabb_min, aabb_max, c, r, tn, tf);
        ++w.n_box;
        if (tn <= tf && tn < best_t) pending = c;
      } else {
        const int s = w.next(r, best_t);
        done = s < 0;
        next_c = s * SUPER_CHUNKS;
        end_c = min(next_c + SUPER_CHUNKS, n_chunks);
      }
    }
    unsigned want = __ballot_sync(FULL, pending >= 0);
    if (want == 0) break;  // every lane is done
    while (want != 0) {  // the warp sweeps each pending chunk in turn
      const int src = __ffs(want) - 1;
      want &= want - 1;
      const int c = __shfl_sync(FULL, pending, src);
      RayQ rs;
      rs.ox = __shfl_sync(FULL, r.ox, src);
      rs.oy = __shfl_sync(FULL, r.oy, src);
      rs.oz = __shfl_sync(FULL, r.oz, src);
      rs.dx = __shfl_sync(FULL, r.dx, src);
      rs.dy = __shfl_sync(FULL, r.dy, src);
      rs.dz = __shfl_sync(FULL, r.dz, src);
      const float t0 = __shfl_sync(FULL, best_t, src);
      const bool ah = __shfl_sync(FULL, (int)any_hit, src) != 0;
      const int used = (int)__ldg(rows + c);
      float t_hit;
      int32_t p_hit;
      const bool found =
          warp_sweep(pages, c, used, page_rows, rs, ah, t0, t_hit, p_hit);
      if (lane == src) {
        n_tri += 8 * used;
        if (found) {
          best_t = t_hit;
          best_p = p_hit;
          done = ah;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best_p < 0 ? __int_as_float(0x7f800000) : best_t;
    prim_out[i] = best_p;
  }
  if (stats != nullptr) add_stats(stats, w.n_box, n_tri, w.overflow);
}

}  // namespace

extern "C" {

// Accel tables as ops/accel.py builds them: aabb_min/max (C, 3), rows (C,)
// f32, sup_min/max (S, 3), pages (C, page_rows, 128) f32, tree_box
// (2C-1, 6) f32, tree_link (2C-1,) int32, sup_tree_box (2S-1, 6) f32,
// sup_tree_link (2S-1,) int32.  Rays: o, d (n, 3) f32, maxt (n,) f32,
// active (n,) bool; rays i >= n_closest are any-hit rays.  Writes t (n,)
// f32 (inf on a miss, -3e38 for an any-hit ray's hit) and prim (n,) int32
// (-1 on a miss).  Chunk mode (super_mode 0) reads the chunk tree and not
// sup_*, super mode the super tables.  stats: null, or 3 zeroed uint64
// that either mode adds box tests, triangle tests and overflowed rays into.
int mitr_bvh_query(const float* aabb_min, const float* aabb_max,
                   const float* rows, const float* sup_min,
                   const float* sup_max, const float* tree_box,
                   const int32_t* tree_link, const float* sup_tree_box,
                   const int32_t* sup_tree_link, const float* pages,
                   int n_chunks, int n_supers, int page_rows, const float* o,
                   const float* d, const float* maxt, const uint8_t* active,
                   int n, int n_closest, int super_mode, float* t_out,
                   int32_t* prim_out, unsigned long long* stats,
                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* pages4 = reinterpret_cast<const float4*>(pages);
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (super_mode)
    bvh_super_kernel<<<grid, BLOCK, 0, s>>>(
        aabb_min, aabb_max, rows, sup_min, sup_max, sup_tree_box,
        sup_tree_link, pages4, n_chunks, n_supers, page_rows, o, d, maxt,
        active, n, n_closest, t_out, prim_out, stats);
  else
    bvh_tree_kernel<<<grid, BLOCK, 0, s>>>(
        aabb_min, aabb_max, rows, tree_box, tree_link, pages4, n_chunks,
        page_rows, o, d, maxt, active, n, n_closest, t_out, prim_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
