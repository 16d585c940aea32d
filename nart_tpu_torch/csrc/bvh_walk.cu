// Closest-hit and any-hit walk of the LBVH built by nart_tpu_torch/bvh.py
// (build_bvh: a complete binary tree over Morton-ordered leaves of
// leaf_size triangles, node i's children 2i+1 and 2i+2, the leaves the last
// n_leaves nodes).  nart_tpu_torch/bvh.py binds the entries:
//   * nart_bvh_hit(..., any = 0)  the nearest hit with t_min < t < t_max:
//                                 t, the triangle's original id (-1 and
//                                 t = inf on a miss), u, v
//   * nart_bvh_hit(..., any = 1)  occluded: is there such a hit?  The
//                                 bool of the closest hit's validity
//   * nart_bvh_max_depth()        the deepest tree the stack holds
//
// Replaces the "bvh" accel kind's walk of the JAX package,
// nart_tpu/accel.py:171 intersect_bvh, whose loop is XLA's lax.while_loop
// (accel.py:255), not a Pallas kernel.  The port's plain version
// (bvh.intersect_bvh_plain: one lockstep step of the whole wavefront per
// node visited, ~60 small kernels and a host read each) cannot be captured
// into a CUDA graph; this kernel reads no host and is captured with the
// round that calls it.
//
// Design: one thread walks one ray on its own, with a stack of node ids of
// kMaxDepth + 2 slots in local memory.  It keeps the plain walk's order
// step for step, so that a ray's answer cannot depend on the other rays
// of its warp: pop the top; the slab test of the node against the ray's
// (t_min, t_best) window, with 1e-30 in place of a zero direction
// component; on a leaf, the watertight test of its leaf_size triangles
// against the t_best of the leaf's entry, lowest index on ties, kept only
// if strictly closer; on an inner node, the slab tests of both children,
// the one pushed first being (e2 < e1 ? c2 : c1) and only when both pass,
// then the other (or the only one that passed).  The any-hit walk stops at
// the first triangle hit in the window, which gives the same bool: the
// closest walk prunes with t_best only, and a triangle's test does not
// depend on the walk.  A ray with no room between t_min and t_max (parked
// or culled lanes, t_max = 0) walks nothing: no triangle can pass its
// window.
//
// What bounds it on an H100: neither HBM bytes (a ray reads 32 B and
// writes 20; the tree and its triangles, 60 B a triangle, stay in L2) nor
// the arithmetic rate, but the walk's dependent loads and the divergence
// of a warp whose rays visit different nodes.  A simple kernel first:
// no shared-memory staging, no cp.async, no regrouping of rays.
//
// Numerics: the file is compiled with --fmad=false, and every sum and
// product is written in the plain version's order (the edge functions'
// FMA-noise snap is kept, or watertightness breaks:
// nart_tpu/geometry.py:24-40), so the edge functions, u and v are the
// plain walk's bits.  Its torch.linalg.cross rounds each component's
// difference of products once, fused, where this file rounds each product:
// the normal, and so t, may differ in the last bits.  The min/max of the
// slab test propagate NaN as torch.minimum/maximum do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNoise = 2.384185791015625e-07f;  // 2^-22
constexpr float kTiny = 1e-30f;
constexpr int kMaxDepth = 30;  // 2^30 leaves: far past any scene
constexpr int kStack = kMaxDepth + 2;
constexpr int kThreads = 128;

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float edge(float ax, float ay, float bx, float by) {
  float p1 = ax * by;
  float p2 = ay * bx;
  float e = p1 - p2;
  float noise = (fabsf(p1) + fabsf(p2)) * kNoise;
  return fabsf(e) <= noise ? 0.0f : e;
}

// x[k] for a k known only at run time, by selects (a register array
// indexed at run time would go to local memory)
__device__ __forceinline__ float pick(const float (&x)[3], int k) {
  return k == 0 ? x[0] : (k == 1 ? x[1] : x[2]);
}

struct Ray {
  float o[3], d[3], inv[3];
  float op[3];  // o permuted: minor 0, minor 1, major
  float sx, sy, t_min;
  int perm[3];  // minor 0, minor 1, major
};

// The slab test of node c against (t_lo, t_hi): sets t_enter, returns hit.
__device__ __forceinline__ bool slab(const float* __restrict__ lo,
                                     const float* __restrict__ hi, int c,
                                     const Ray& r, float t_hi,
                                     float& t_enter) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (lo[3 * c + k] - r.o[k]) * r.inv[k];
    float t1 = (hi[3 * c + k] - r.o[k]) * r.inv[k];
    float a = nmin(t0, t1), b = nmax(t0, t1);
    near = k == 0 ? a : nmax(near, a);
    far = k == 0 ? b : nmin(far, b);
  }
  t_enter = nmax(near, r.t_min);
  return t_enter <= nmin(far, t_hi);
}

// The watertight test of triangle j (tri_v row j: v0, v1, v2) against the
// window (t_min, t_hi): true on a hit, with t, e0, e1, esum set
// (bvh._intersect_gathered's arithmetic, in its order).
__device__ __forceinline__ bool tri_test(const float* __restrict__ tri_v,
                                         int64_t j, const Ray& r, float t_hi,
                                         float& t, float& e0, float& e1,
                                         float& esum) {
  const float* v = tri_v + 9 * j;
  float a[3], b[3], n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = v[3 + k] - v[k];
    b[k] = v[6 + k] - v[k];
  }
  n[0] = a[1] * b[2] - a[2] * b[1];
  n[1] = a[2] * b[0] - a[0] * b[2];
  n[2] = a[0] * b[1] - a[1] * b[0];
  float v0n = v[0] * n[0] + v[1] * n[1];
  v0n = v0n + v[2] * n[2];
  float on = r.o[0] * n[0] + r.o[1] * n[1];
  on = on + r.o[2] * n[2];
  float dn = r.d[0] * n[0] + r.d[1] * n[1];
  dn = dn + r.d[2] * n[2];
  t = (v0n - on) / dn;
  if (!(t > r.t_min && t < t_hi)) return false;
  float px[3], py[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float pa = v[3 * c + r.perm[0]] - r.op[0];
    float pb = v[3 * c + r.perm[1]] - r.op[1];
    float pc = v[3 * c + r.perm[2]] - r.op[2];
    px[c] = pa + pc * r.sx;
    py[c] = pb + pc * r.sy;
  }
  e0 = edge(px[1], py[1], px[2], py[2]);
  e1 = edge(px[2], py[2], px[0], py[0]);
  float e2 = edge(px[0], py[0], px[1], py[1]);
  bool neg = (e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f);
  bool pos = (e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f);
  float abs_sum = fabsf(e0) + fabsf(e1);
  abs_sum = abs_sum + fabsf(e2);
  if ((neg && pos) || abs_sum == 0.0f) return false;
  esum = e0 + e1;
  esum = esum + e2;
  return true;
}

struct Tree {
  const float* lo;       // (n_nodes, 3)
  const float* hi;       // (n_nodes, 3)
  const float* tri_v;    // (n_leaves * leaf_size, 3, 3)
  const int64_t* order;  // (n_leaves * leaf_size,) original id, -1 padding
  int n_leaves, leaf_size;
};

struct Out {
  float* t;      // closest-hit
  int64_t* tri;
  float* u;
  float* v;
  bool* occ;     // any-hit
};

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
                const float* __restrict__ t_min_in, int t_min_step,
                const float* __restrict__ t_max_in, int t_max_step, int n,
                Tree tree, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o_in[3 * i + k];
    r.d[k] = d_in[3 * i + k];
    r.inv[k] = 1.0f / (r.d[k] == 0.0f ? kTiny : r.d[k]);
  }
  {
    // C++ tie-break of the reference: x>y ? (x>z ? 0 : 2) : (y>z ? 1 : 2)
    float ax = fabsf(r.d[0]), ay = fabsf(r.d[1]), az = fabsf(r.d[2]);
    int mj = ax > ay ? (ax > az ? 0 : 2) : (ay > az ? 1 : 2);
    r.perm[0] = (mj + 1) % 3;
    r.perm[1] = (mj + 2) % 3;
    r.perm[2] = mj;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.op[k] = pick(r.o, r.perm[k]);
    float sz = 1.0f / pick(r.d, mj);
    r.sx = -pick(r.d, r.perm[0]) * sz;
    r.sy = -pick(r.d, r.perm[1]) * sz;
  }
  r.t_min = t_min_in[t_min_step * i];
  float t_best = t_max_in[t_max_step * i];
  int64_t best = -1;  // reordered triangle row
  float bu = 0.0f, bv = 0.0f;
  const int leaf0 = tree.n_leaves - 1;

  int stack[kStack];
  int sp = 0;
  // no room between t_min and t_max: no triangle can pass the window
  if (t_best > r.t_min) stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    float e_node;
    if (!slab(tree.lo, tree.hi, node, r, t_best, e_node)) continue;
    if (node >= leaf0) {
      const int64_t base = (int64_t)(node - leaf0) * tree.leaf_size;
      const float t_hi = t_best;  // the leaf's triangles share its entry's
      float t_leaf = t_hi;
      int64_t hit_j = -1;
      float hu = 0.0f, hv = 0.0f;
      for (int k = 0; k < tree.leaf_size; ++k) {
        float t, e0, e1, esum;
        if (!tri_test(tree.tri_v, base + k, r, t_hi, t, e0, e1, esum)) continue;
        if constexpr (kAny) {
          out.occ[i] = true;
          return;
        }
        if (t < t_leaf) {  // strictly: the lowest index keeps a tie
          t_leaf = t;
          hit_j = base + k;
          const float inv_det = 1.0f / esum;
          hu = e0 * inv_det;
          hv = e1 * inv_det;
        }
      }
      if (hit_j >= 0 && t_leaf < t_best) {
        t_best = t_leaf;
        best = hit_j;
        bu = hu;
        bv = hv;
      }
    } else {
      const int c1 = 2 * node + 1, c2 = 2 * node + 2;
      float e1, e2;
      const bool h1 = slab(tree.lo, tree.hi, c1, r, t_best, e1);
      const bool h2 = slab(tree.lo, tree.hi, c2, r, t_best, e2);
      const bool swap = e2 < e1;
      const int first = swap ? c2 : c1, second = swap ? c1 : c2;
      const bool h_first = swap ? h2 : h1, h_second = swap ? h1 : h2;
      if (h_first && h_second) stack[sp++] = first;
      if (h_first || h_second) stack[sp++] = h_second ? second : first;
    }
  }
  if constexpr (kAny) {
    out.occ[i] = false;
  } else {
    out.t[i] = best >= 0 ? t_best : INFINITY;
    out.tri[i] = best >= 0 ? tree.order[best] : -1;
    out.u[i] = bu;
    out.v[i] = bv;
  }
}

}  // namespace

extern "C" int nart_bvh_max_depth() { return kMaxDepth; }

// t_min and t_max are (n,) (step 1) or one value for every ray (step 0).
// Returns cudaGetLastError() after the launch, or -1 (no launch) for a tree
// deeper than the stack holds.
extern "C" int nart_bvh_hit(const void* o, const void* d, const void* t_min,
                            int t_min_step, const void* t_max, int t_max_step,
                            int n, const void* node_lo, const void* node_hi,
                            const void* tri_v, const void* order,
                            int n_leaves, int leaf_size, int depth, int any,
                            void* t_out, void* tri_out, void* u_out,
                            void* v_out, void* occ_out, void* stream) {
  if (depth > kMaxDepth) return -1;
  if (n <= 0) return 0;
  Tree tree{(const float*)node_lo, (const float*)node_hi,
            (const float*)tri_v, (const int64_t*)order, n_leaves, leaf_size};
  Out out{(float*)t_out, (int64_t*)tri_out, (float*)u_out, (float*)v_out,
          (bool*)occ_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const float* lo = (const float*)t_min;
  const float* hi = (const float*)t_max;
  if (any) {
    bvh_walk_kernel<true><<<blocks, kThreads, 0, s>>>(
        fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out);
  } else {
    bvh_walk_kernel<false><<<blocks, kThreads, 0, s>>>(
        fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out);
  }
  return (int)cudaGetLastError();
}
