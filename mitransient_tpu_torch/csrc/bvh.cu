// Ray queries through the chunked acceleration structure for Hopper
// (sm_90a): one per-ray front-to-back traversal of the chunk pages.
//
// Replaces the four TPU kernels of mitransient_tpu/ops/bvh_pallas.py and
// their pass loop: chunk mode (template SUPER = false) covers _select_kernel
// (K5) and _sweep_kernel (K4), super mode (SUPER = true) covers
// _select_super_kernel (K7) and _sweep_super_kernel (K6).  On the TPU a
// query is select -> sort -> sweep passes over ray tiles, because a TPU
// lane has no control flow of its own.  Here one thread owns one ray and
// loops: pick the lexicographically next (entry, id) box whose slab test
// passes with entry < best_t, sweep its page(s), repeat until no box is
// left.  No sort, no candidate cache, no device->host sync: one launch per
// query.  The algorithm and its rounding are those of ops/bvh.py:query_plain
// (see that module's docstring); the library is built with --fmad=false,
// so every product and sum is rounded on its own, as written.
//
// Layout: the block stages the chunk bounds (6 x C floats) and used-row
// counts (C ints), and in super mode the super-chunk bounds (6 x S floats),
// into dynamic shared memory: 17.9 KB for the 744 chunks of a 261k-triangle
// mesh.  Every thread of a warp scans the boxes in the same order, so each
// shared read is a broadcast.  Page records are read as four float4 per
// triangle (16 floats: A row-major, prim id, c, spare) from global memory;
// at 261k triangles the 24 MB of pages stay in the 50 MB L2.
//
// Bound: arithmetic.  Per visit a ray runs C (or S) slab tests (~25 flops)
// and up to 8 x used-rows Woop tests (~35 flops); the bytes per ray are the
// 33 of the ray and 8 of the result.  Divergence is the known cost of this
// first design: a warp runs as long as its longest ray, and its rays read
// different pages.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
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

// Slab test of box k of a (6, stride) bounds table in shared memory.
__device__ __forceinline__ void slab(const float* s, int stride, int k,
                                     const RayQ& r, float& tn, float& tf) {
  const float t0x = (s[0 * stride + k] - r.ox) * r.ix;
  const float t0y = (s[1 * stride + k] - r.oy) * r.iy;
  const float t0z = (s[2 * stride + k] - r.oz) * r.iz;
  const float t1x = (s[3 * stride + k] - r.ox) * r.ix;
  const float t1y = (s[4 * stride + k] - r.oy) * r.iy;
  const float t1z = (s[5 * stride + k] - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
             fmaxf(fminf(t0z, t1z), RAY_EPS));
  tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Woop test of the used rows of chunk c's page, in triangle order.  Returns
// true when an any-hit ray found its hit (best_t is then -BIG).
__device__ __forceinline__ bool sweep_page(const float4* __restrict__ pages,
                                           int c, int used_rows,
                                           int page_rows, const RayQ& r,
                                           bool any_hit, float& best_t,
                                           int32_t& best_p) {
  const float4* tri = pages + (size_t)c * page_rows * 32;  // 32 float4 a row
  const int n_tris = used_rows * 8;
  for (int k = 0; k < n_tris; ++k, tri += 4) {
    const float4 q0 = __ldg(tri + 0);  // a0x a0y a0z a1x
    const float4 q1 = __ldg(tri + 1);  // a1y a1z a2x a2y
    const float4 q2 = __ldg(tri + 2);  // a2z prim cx cy
    const float4 q3 = __ldg(tri + 3);  // cz - - -
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
  }
  return false;
}

template <bool SUPER>
__global__ void __launch_bounds__(BLOCK)
bvh_query_kernel(const float* __restrict__ aabb_min,
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
  if (SUPER) {
    for (int s = threadIdx.x; s < n_supers; s += blockDim.x) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s_sup[a * n_supers + s] = sup_min[3 * s + a];
        s_sup[(3 + a) * n_supers + s] = sup_max[3 * s + a];
      }
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // no barrier follows

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
  // min(maxt, BIG) keeps NaN, as jnp.minimum does; inactive rays hit nothing
  const float mt = maxt[i];
  float best_t = active[i] ? (mt > BIG ? BIG : mt) : -BIG;
  int32_t best_p = -1;
  const bool any_hit = i >= n_closest;

  const int n_boxes = SUPER ? n_supers : n_chunks;
  const float* s_box = SUPER ? s_sup : s_chk;
  float gate_e = -__int_as_float(0x7f800000);  // -inf
  int gate_k = -1;
  while (true) {
    // the lexicographically next (entry, id) box after the gate
    float be = __int_as_float(0x7f800000);
    int bk = -1;
    for (int k = 0; k < n_boxes; ++k) {
      float tn, tf;
      slab(s_box, n_boxes, k, r, tn, tf);
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
    if (SUPER) {
      for (int cc = 0; cc < SUPER_CHUNKS && !stop; ++cc) {
        const int c = bk * SUPER_CHUNKS + cc;
        if (c >= n_chunks) break;
        float tn, tf;
        slab(s_chk, n_chunks, c, r, tn, tf);
        if (tn <= tf && tn < best_t)
          stop = sweep_page(pages, c, s_rows[c], page_rows, r, any_hit,
                            best_t, best_p);
      }
    } else {
      stop = sweep_page(pages, bk, s_rows[bk], page_rows, r, any_hit, best_t,
                        best_p);
    }
    if (stop) break;
  }
  t_out[i] = best_p < 0 ? __int_as_float(0x7f800000) : best_t;
  prim_out[i] = best_p;
}

template <bool SUPER>
cudaError_t launch(const float* aabb_min, const float* aabb_max,
                   const float* rows, const float* sup_min,
                   const float* sup_max, const float* pages, int n_chunks,
                   int n_supers, int page_rows, const float* o, const float* d,
                   const float* maxt, const uint8_t* active, int n,
                   int n_closest, float* t_out, int32_t* prim_out,
                   cudaStream_t stream) {
  const int smem = 4 * (7 * n_chunks + (SUPER ? 6 * n_supers : 0));
  if (smem > MAX_SHARED_BYTES) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bvh_query_kernel<SUPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (n + BLOCK - 1) / BLOCK;
  bvh_query_kernel<SUPER><<<grid, BLOCK, smem, stream>>>(
      aabb_min, aabb_max, rows, sup_min, sup_max,
      reinterpret_cast<const float4*>(pages), n_chunks, n_supers, page_rows,
      o, d, maxt, active, n, n_closest, t_out, prim_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Accel tables as ops/accel.py builds them: aabb_min/max (C, 3), rows (C,)
// f32, sup_min/max (S, 3), pages (C, page_rows, 128) f32.  Rays: o, d
// (n, 3) f32, maxt (n,) f32, active (n,) bool; rays i >= n_closest are
// any-hit rays.  Writes t (n,) f32 (inf on a miss, -3e38 for an any-hit
// ray's hit) and prim (n,) int32 (-1 on a miss).
int mitr_bvh_query(const float* aabb_min, const float* aabb_max,
                   const float* rows, const float* sup_min,
                   const float* sup_max, const float* pages, int n_chunks,
                   int n_supers, int page_rows, const float* o, const float* d,
                   const float* maxt, const uint8_t* active, int n,
                   int n_closest, int super_mode, float* t_out,
                   int32_t* prim_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (super_mode)
    return (int)launch<true>(aabb_min, aabb_max, rows, sup_min, sup_max,
                             pages, n_chunks, n_supers, page_rows, o, d, maxt,
                             active, n, n_closest, t_out, prim_out, s);
  return (int)launch<false>(aabb_min, aabb_max, rows, sup_min, sup_max, pages,
                            n_chunks, n_supers, page_rows, o, d, maxt, active,
                            n, n_closest, t_out, prim_out, s);
}

}  // extern "C"
