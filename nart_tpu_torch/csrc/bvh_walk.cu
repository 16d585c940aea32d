// Closest-hit and any-hit walk of the LBVH built by nart_tpu_torch/bvh.py
// (build_bvh: a complete binary tree over Morton-ordered leaves of
// leaf_size triangles, node i's children 2i+1 and 2i+2, the leaves the last
// n_leaves nodes).  nart_tpu_torch/bvh.py binds the entries:
//   * nart_bvh_hit(..., any = 0)  the nearest hit with t_min < t < t_max:
//                                 t, the triangle's original id (-1 and
//                                 t = inf on a miss), u, v
//   * nart_bvh_hit(..., any = 1)  occluded: is there such a hit?  The
//                                 bool of the closest hit's validity
//   * nart_bvh_hit_ref(...)       the first design of this walk (one thread
//                                 a ray, a slab test at every pop, boxes and
//                                 vertices read as scalars), kept as the
//                                 reference the redesign is held to bit for
//                                 bit; no path launches it
//   * nart_bvh_max_depth()        the deepest tree the stacks hold
//
// Replaces the "bvh" accel kind's walk of the JAX package,
// nart_tpu/accel.py:171 intersect_bvh, whose loop is XLA's lax.while_loop
// (accel.py:255), not a Pallas kernel.  The port's plain version
// (bvh.intersect_bvh_plain: one lockstep step of the whole wavefront per
// node visited, ~60 small kernels and a host read each) cannot be captured
// into a CUDA graph; these kernels read no host and are captured with the
// round that calls them.
//
// Both walks test the leaves that the plain walk tests, in its order and
// against the same t_best, so that a ray's answer cannot depend on the
// other rays of its warp.  The plain walk: pop the top; the slab test of
// the node against the ray's (t_min, t_best) window, with
// 1e-30 in place of a zero direction component; on a leaf, the watertight
// test of its leaf_size triangles against the t_best of the leaf's entry,
// lowest index on ties, kept only if strictly closer; on an inner node, the
// slab tests of both children, the one pushed first being (e2 < e1 ? c2 :
// c1) and only when both pass, then the other (or the only one that
// passed).  The any-hit walk stops at the first leaf with a triangle hit in
// the window, which gives the same bool: the closest walk prunes with
// t_best only, and a triangle's test does not depend on the walk.  A ray
// with no room between t_min and t_max (parked or culled lanes, t_max = 0)
// walks nothing: no triangle can pass its window.
//
// The redesign (nart_bvh_hit) does less work a step and loads less a step,
// with the reference's bits on every ray.  What it does about each limit of
// the reference (device times: PERF.md, B1):
//   1. A pop no longer re-runs the node's slab test.  A stack entry carries
//      (node, t_enter); t_enter = max(near, t_min) does not depend on
//      t_best, and a push happens only after t_enter <= min(far, t_best
//      then) held (neither side NaN), so the test at the pop is t_enter <=
//      t_best now alone.  The child that the reference would pop at once
//      (the nearer, or the only one that passed) is not pushed at all: the
//      walk goes on with it, its test having just passed against the same
//      t_best.  The root keeps its full test.
//   2. Boxes are read as sibling pairs: the boxes of nodes 2i+1 and 2i+2
//      (lo, hi, lo, hi), 48 bytes at row i of bvh.node_pairs, three float4
//      loads through the read-only path, in place of twelve scalar loads
//      (eighteen with the reference's pop).
//   3. Triangles are read as 48-byte records, v0, v1, v2 and the plane
//      normal n, of bvh.tri_rec: three float4 loads in place of nine scalar
//      ones, and no cross product.  build_bvh computes n in this file's
//      order, one numpy float32 operation at a time, so n, and so t, are the
//      bits the reference computes on the card.  On the any-hit walk a leaf
//      of 8 (the build's default) issues all 24 loads before its tests
//      (about 125 registers); the closest-hit walk keeps the loop (under
//      60: with all 24 loads in flight it holds over 140 and loses on the
//      soup and the hit-point rays).  u and v are divided out once, at
//      the end of the walk, from the best hit's edge functions.
//   4. The stack holds (node, t_enter) of the far children only, at most
//      one entry a level, in local memory (a stack in shared memory,
//      [slot][thread], was no faster), its depth in a register (in local
//      memory it was no faster either).
//   5. One thread still walks one ray, but as Aila and Laine's while-while
//      loop: inner nodes until the lane holds a leaf, then the leaf (see
//      walk), so that a warp's lanes take their inner steps together and
//      test their leaves together.  The reference's single loop, one node
//      a step, left work for 22% (macbeth's camera rays) to 41% of a
//      warp's lanes.  Putting a leaf off until every lane of the warp holds
//      one (their speculative variant) keeps the bits too but lost 5-16%
//      on every ray set.  Regrouping rays, packets and a wider tree would
//      change the visit order, and so the results of ties.
// What bounds it on an H100: neither HBM bytes (a ray reads 32 B and
// writes 20; the tree and its triangles stay in L2) nor the arithmetic
// rate, but the walk's dependent loads and the lanes of a warp that wait
// on the others' nodes.
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

__device__ __forceinline__ Ray make_ray(const float* __restrict__ o_in,
                                        const float* __restrict__ d_in,
                                        int i, float t_min) {
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o_in[3 * i + k];
    r.d[k] = d_in[3 * i + k];
    r.inv[k] = 1.0f / (r.d[k] == 0.0f ? kTiny : r.d[k]);
  }
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
  r.t_min = t_min;
  return r;
}

// The slab test of the box (lo, hi) against (t_min, t_hi): sets t_enter,
// returns hit.
__device__ __forceinline__ bool slab(const float (&lo)[3],
                                     const float (&hi)[3], const Ray& r,
                                     float t_hi, float& t_enter) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (lo[k] - r.o[k]) * r.inv[k];
    float t1 = (hi[k] - r.o[k]) * r.inv[k];
    float a = nmin(t0, t1), b = nmax(t0, t1);
    near = k == 0 ? a : nmax(near, a);
    far = k == 0 ? b : nmin(far, b);
  }
  t_enter = nmax(near, r.t_min);
  return t_enter <= nmin(far, t_hi);
}

// The edge-function half of the watertight test of the triangle v (v0, v1,
// v2), given that its t passed the window: true on a hit, with e0, e1, esum
// set (bvh._intersect_gathered's arithmetic, in its order).
__device__ __forceinline__ bool edges(const float (&v)[9], const Ray& r,
                                      float& e0, float& e1, float& esum) {
  float px[3], py[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q[3] = {v[3 * c], v[3 * c + 1], v[3 * c + 2]};
    float pa = pick(q, r.perm[0]) - r.op[0];
    float pb = pick(q, r.perm[1]) - r.op[1];
    float pc = pick(q, r.perm[2]) - r.op[2];
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

// t of the plane of v0 and normal n along the ray (the reference's
// arithmetic, in its order: v0.n and o.n and d.n left to right)
__device__ __forceinline__ float plane_t(const float* v, const float* n,
                                         const Ray& r) {
  float v0n = v[0] * n[0] + v[1] * n[1];
  v0n = v0n + v[2] * n[2];
  float on = r.o[0] * n[0] + r.o[1] * n[1];
  on = on + r.o[2] * n[2];
  float dn = r.d[0] * n[0] + r.d[1] * n[1];
  dn = dn + r.d[2] * n[2];
  return (v0n - on) / dn;
}

struct Out {
  float* t;      // closest-hit
  int64_t* tri;
  float* u;
  float* v;
  bool* occ;     // any-hit
};

// ---------------------------------------------------------------------------
// The reference: the walk's first design, as it was
// ---------------------------------------------------------------------------

namespace ref {

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

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
bvh_walk_ref_kernel(const float* __restrict__ o_in,
                    const float* __restrict__ d_in,
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

}  // namespace ref

// ---------------------------------------------------------------------------
// The redesigned walk
// ---------------------------------------------------------------------------

struct Tree {
  const float* root_lo;    // node 0's box: node_lo row 0 ...
  const float* root_hi;    // ... and node_hi row 0
  const float4* pairs;     // (n_leaves - 1, 3): the children's boxes
  const float4* tri_rec;   // (n_leaves * leaf_size, 3): v0 v1 v2 n
  const int64_t* order;    // (n_leaves * leaf_size,) original id, -1 padding
  int n_leaves, leaf_size;
};

// The walk's stack: (node, t_enter's bits) of the far children, in local
// memory, one 8-byte entry a push; its depth is a register of the walk's.
struct Stack {
  int2 slot[kStack];
};

__device__ __forceinline__ void push(Stack& st, int& sp, int c, float e) {
  st.slot[sp++] = make_int2(c, __float_as_int(e));
}

__device__ __forceinline__ void pop(const Stack& st, int& sp, int& c,
                                    float& e) {
  const int2 x = st.slot[--sp];
  c = x.x;
  e = __int_as_float(x.y);
}

// A triangle record's three float4: v0 v1 v2 (9 floats), n (3).
__device__ __forceinline__ void unpack(const float4& a, const float4& b,
                                       const float4& c, float (&v)[9],
                                       float (&n)[3]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = c.x; n[0] = c.y; n[1] = c.z; n[2] = c.w;
}

// The nearest hit so far: t (t_max before any), the reordered row and its
// edge functions (u and v are divided out once, at the end of the walk).
struct Best {
  float t;
  int64_t row;
  float e0, e1, esum;
};

// One triangle of a leaf whose entry's t_best is t_hi.  Any-hit: true on a
// hit.  Closest: false; the leaf's nearest (t_leaf, hit) kept in place,
// taken only if strictly closer (the lowest index keeps a tie).
template <bool kAny>
__device__ __forceinline__ bool leaf_tri(const float (&v)[9],
                                         const float (&n)[3], const Ray& r,
                                         float t_hi, int64_t row,
                                         float& t_leaf, Best& hit) {
  const float t = plane_t(v, n, r);
  if (!(t > r.t_min && t < t_hi)) return false;
  float e0, e1, esum;
  if (!edges(v, r, e0, e1, esum)) return false;
  if constexpr (kAny) {
    return true;
  } else {
    if (t < t_leaf) {
      t_leaf = t;
      hit = Best{t, row, e0, e1, esum};
    }
    return false;
  }
}

// The triangles of leaf node `node` against the window (t_min, best.t):
// any-hit, true if one hits; closest, best replaced where the leaf's
// nearest is strictly closer.
template <bool kAny, bool kLeaf8>
__device__ __forceinline__ bool leaf_test(const Tree& tree, int node,
                                          const Ray& r, Best& best) {
  const int64_t base = (int64_t)(node - (tree.n_leaves - 1)) * tree.leaf_size;
  const float t_hi = best.t;  // the leaf's triangles share its entry's
  float t_leaf = t_hi;
  Best hit{t_hi, -1, 0.0f, 0.0f, 1.0f};
  const float4* rec = tree.tri_rec + 3 * base;
  bool any = false;
  if constexpr (kLeaf8) {
    float4 q[24];  // every load of the leaf in flight before its tests
#pragma unroll
    for (int k = 0; k < 24; ++k) q[k] = __ldg(rec + k);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[9], n[3];
      unpack(q[3 * k], q[3 * k + 1], q[3 * k + 2], v, n);
      any |= leaf_tri<kAny>(v, n, r, t_hi, base + k, t_leaf, hit);
    }
  } else {
    for (int k = 0; k < tree.leaf_size && !any; ++k) {
      float v[9], n[3];
      unpack(__ldg(rec + 3 * k), __ldg(rec + 3 * k + 1),
             __ldg(rec + 3 * k + 2), v, n);
      any = leaf_tri<kAny>(v, n, r, t_hi, base + k, t_leaf, hit);
    }
  }
  if (hit.row >= 0 && t_leaf < best.t) best = hit;
  return any;
}

// An inner node's step: the slab tests of both children against (t_min,
// t_hi), the far one pushed when both pass.  Returns whether a child is
// walked on at once, the one the reference pops next (node and e set to
// it), its test having just passed against this t_hi.
__device__ __forceinline__ bool descend(const Tree& tree, const Ray& r,
                                        float t_hi, Stack& st, int& sp,
                                        int& node, float& e) {
  const float4* p = tree.pairs + 3 * node;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  const float lo1[3] = {a.x, a.y, a.z}, hi1[3] = {a.w, b.x, b.y};
  const float lo2[3] = {b.z, b.w, c.x}, hi2[3] = {c.y, c.z, c.w};
  float e1, e2;
  const bool h1 = slab(lo1, hi1, r, t_hi, e1);
  const bool h2 = slab(lo2, hi2, r, t_hi, e2);
  const bool swap = e2 < e1;
  const int c1 = 2 * node + 1, c2 = 2 * node + 2;
  const int first = swap ? c2 : c1, second = swap ? c1 : c2;
  const float e_first = swap ? e2 : e1, e_second = swap ? e1 : e2;
  const bool h_first = swap ? h2 : h1, h_second = swap ? h1 : h2;
  if (h_first && h_second) push(st, sp, first, e_first);
  if (!(h_first || h_second)) return false;
  node = h_second ? second : first;
  e = h_second ? e_second : e_first;
  return true;
}

// The walk from the root (have: its test passed, with t_enter e) as Aila
// and Laine's while-while loop ("Understanding the efficiency of ray
// traversal on GPUs", HPG 2009): an inner loop takes inner nodes until
// this lane holds a leaf, whose triangles are then tested.  A lane's steps
// are those of a loop that takes one node a step, so its leaves, their
// order and its results are the reference's; the lanes of a warp take
// their inner steps together and then test their leaves together, where
// one loop would run both kinds of step in every iteration with a part of
// the lanes each.  Any-hit: true at the first leaf with a hit; closest,
// best kept.
template <bool kAny, bool kLeaf8>
__device__ __forceinline__ bool walk(const Tree& tree, const Ray& r,
                                     Best& best, bool have, float e) {
  const int leaf0 = tree.n_leaves - 1;
  Stack st;
  int sp = 0;
  int node = 0;
  // The leaf met is held in a variable of its own and tested after the
  // inner loop, which ends at the leaf or when the stack runs out; the
  // walk ends after a leaf test.  Shapes in which the inner loop returns or
  // breaks at the leaf compile to the code of a single loop and lost
  // 1.3-2.4x (PERF.md, B1's variants).
  int leaf = -1;
  while (true) {
    while (true) {  // inner nodes, until this lane holds a leaf
      if (!have) {
        if (sp == 0) break;
        pop(st, sp, node, e);
        // the reference's slab test at the pop: t_enter passed against a
        // t_best at least this large when the node was pushed
        if (!(e <= best.t)) continue;
        have = true;
      }
      if (node >= leaf0) {
        leaf = node;
        have = false;
      } else {
        have = descend(tree, r, best.t, st, sp, node, e);
      }
      if (leaf >= 0) break;
    }
    if (leaf >= 0) {
      if (leaf_test<kAny, kLeaf8>(tree, leaf, r, best)) return true;
      leaf = -1;
    }
    if (!have && sp == 0) return false;
  }
}

template <bool kAny, bool kLeaf8>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
                const float* __restrict__ t_min_in, int t_min_step,
                const float* __restrict__ t_max_in, int t_max_step, int n,
                Tree tree, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(o_in, d_in, i, t_min_in[t_min_step * i]);
  Best best{t_max_in[t_max_step * i], -1, 0.0f, 0.0f, 1.0f};
  // no room between t_min and t_max: no triangle can pass the window; the
  // root, pushed untested by the reference, takes its full test here
  bool have = false;
  float e = 0.0f;
  if (best.t > r.t_min) {
    const float lo[3] = {tree.root_lo[0], tree.root_lo[1], tree.root_lo[2]};
    const float hi[3] = {tree.root_hi[0], tree.root_hi[1], tree.root_hi[2]};
    have = slab(lo, hi, r, best.t, e);
  }
  if constexpr (kAny) {
    out.occ[i] = walk<true, kLeaf8>(tree, r, best, have, e);
  } else {
    walk<false, kLeaf8>(tree, r, best, have, e);
    const bool hit = best.row >= 0;
    const float inv_det = 1.0f / best.esum;
    out.t[i] = hit ? best.t : INFINITY;
    out.tri[i] = hit ? tree.order[best.row] : -1;
    out.u[i] = hit ? best.e0 * inv_det : 0.0f;
    out.v[i] = hit ? best.e1 * inv_det : 0.0f;
  }
}

template <bool kAny>
void launch(const float* o, const float* d, const float* t_min,
            int t_min_step, const float* t_max, int t_max_step, int n,
            const Tree& tree, const Out& out, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  // a leaf of 8 with all its loads in flight pays on the any-hit walk
  // only: on the closest-hit walk it holds over 140 registers (PERF.md)
  if (kAny && tree.leaf_size == 8) {
    bvh_walk_kernel<kAny, kAny><<<blocks, kThreads, 0, s>>>(
        o, d, t_min, t_min_step, t_max, t_max_step, n, tree, out);
  } else {
    bvh_walk_kernel<kAny, false><<<blocks, kThreads, 0, s>>>(
        o, d, t_min, t_min_step, t_max, t_max_step, n, tree, out);
  }
}

}  // namespace

extern "C" int nart_bvh_max_depth() { return kMaxDepth; }

// t_min and t_max are (n,) (step 1) or one value for every ray (step 0).
// node_lo and node_hi (n_nodes, 3): only the root's box, row 0, is read;
// node_pairs (n_leaves - 1, 12): row i the boxes of nodes 2i+1 and 2i+2
// (lo, hi, lo, hi); tri_rec (n_leaves * leaf_size, 12): v0, v1, v2, n; both
// 16-byte aligned.  Returns cudaGetLastError() after the launch, or -1 (no
// launch) for a tree deeper than the stack holds.
extern "C" int nart_bvh_hit(const void* o, const void* d, const void* t_min,
                            int t_min_step, const void* t_max, int t_max_step,
                            int n, const void* node_lo, const void* node_hi,
                            const void* node_pairs, const void* tri_rec,
                            const void* order, int n_leaves, int leaf_size,
                            int depth, int any, void* t_out, void* tri_out,
                            void* u_out, void* v_out, void* occ_out,
                            void* stream) {
  if (depth > kMaxDepth) return -1;
  if (n <= 0) return 0;
  const Tree tree{(const float*)node_lo, (const float*)node_hi,
                  (const float4*)node_pairs, (const float4*)tri_rec,
                  (const int64_t*)order, n_leaves, leaf_size};
  const Out out{(float*)t_out, (int64_t*)tri_out, (float*)u_out,
                (float*)v_out, (bool*)occ_out};
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const float* lo = (const float*)t_min;
  const float* hi = (const float*)t_max;
  cudaStream_t s = (cudaStream_t)stream;
  if (any) {
    launch<true>(fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out, s);
  } else {
    launch<false>(fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out, s);
  }
  return (int)cudaGetLastError();
}

// The reference walk (the first design's kernel, as it was), on node_lo,
// node_hi and tri_v as bvh.BVH holds them; otherwise nart_bvh_hit's
// arguments and returns.
extern "C" int nart_bvh_hit_ref(const void* o, const void* d,
                                const void* t_min, int t_min_step,
                                const void* t_max, int t_max_step, int n,
                                const void* node_lo, const void* node_hi,
                                const void* tri_v, const void* order,
                                int n_leaves, int leaf_size, int depth,
                                int any, void* t_out, void* tri_out,
                                void* u_out, void* v_out, void* occ_out,
                                void* stream) {
  if (depth > kMaxDepth) return -1;
  if (n <= 0) return 0;
  ref::Tree tree{(const float*)node_lo, (const float*)node_hi,
                 (const float*)tri_v, (const int64_t*)order, n_leaves,
                 leaf_size};
  Out out{(float*)t_out, (int64_t*)tri_out, (float*)u_out, (float*)v_out,
          (bool*)occ_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const float* lo = (const float*)t_min;
  const float* hi = (const float*)t_max;
  if (any) {
    ref::bvh_walk_ref_kernel<true><<<blocks, kThreads, 0, s>>>(
        fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out);
  } else {
    ref::bvh_walk_ref_kernel<false><<<blocks, kThreads, 0, s>>>(
        fo, fd, lo, t_min_step, hi, t_max_step, n, tree, out);
  }
  return (int)cudaGetLastError();
}
