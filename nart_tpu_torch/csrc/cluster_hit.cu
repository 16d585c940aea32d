// Closest-hit and any-hit ray traversal of the two-level triangle clusters
// built by nart_tpu_torch/cluster_accel.py (build_clusters).
//
// Replaces the two TPU kernels of nart_tpu/pallas_accel.py and the counter
// kernel of tools/kernel_stats.py:
//   * nart_closest_hit        <- _kernel        (intersect_clusters)
//   * nart_any_hit            <- _kernel_any    (intersect_clusters_any)
//   * nart_closest_hit_stats  <- _kernel_stats  (tools/kernel_stats.py run)
//
// Design: one thread per ray.  Each thread walks the superclusters in index
// order, gates each behind a slab test of its AABB against the ray's current
// (t_min, t_best) window, visits the member clusters in the ray's direction-
// octant order (morder: ascending centroid projection on the octant
// diagonal, so near members come first and tighten t_best), gates each
// member with its own slab test and then runs the csize watertight
// triangle tests straight from the (13, n_clusters, csize) planes in global
// memory.  The any-hit walk returns at the first hit.
//
// What bounds it on an H100: the per-triangle watertight arithmetic (about
// 60 float operations and one IEEE division per test) and the divergence
// of the per-ray walk (threads of a warp take different clusters and exit
// at different times).  Plane loads are strided by csize across the 13
// planes and go through L1/L2; the whole scene of the renderer's main cell
// (16 clusters of 128) stays cache-resident.  What this simple design
// leaves on the table: no front-to-back ordering of superclusters, no
// shared-memory staging of cluster planes for a warp that agrees on a
// cluster, no warp-cooperative traversal, no ray sorting.
//
// Numerics: the file is compiled with --fmad=false, so every multiply and
// add rounds on its own, as the op-by-op PyTorch reference does; a fused
// multiply-subtract in the edge functions would break the sign consistency
// watertightness relies on (nart_tpu/geometry.py:24-40).  The FMA-noise
// snap of the edge functions is kept as well, for parity with the
// reference.  No fast-math: t = (v0.n - o.n) / (d.n) is an IEEE division.
//
// The counter kernel is the closest-hit walk itself (the same template,
// kStats = true) and writes, per ray, t and what the walk did: superclusters
// whose slab test passed, member slab tests, clusters whose triangles were
// tested, and the sum over those clusters of the warp's lanes that tested
// the same cluster in the same step (the TPU tool's live-lane census,
// restated for a 32-lane warp).  It is an instrument, bound by the same
// arithmetic as the walk it counts; the counters are what the bounds of
// the two production kernels are reckoned from.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNoise = 2.384185791015625e-07f;  // 2^-22
constexpr float kTiny = 1e-30f;

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float t_min;
  int m0, m1, mj;  // watertight permutation: minor0, minor1, major
  float sx, sy;
  float oa, ob, oc;
  int octant;
};

__device__ __forceinline__ float comp(const float* v, int axis) {
  return axis == 0 ? v[0] : (axis == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ void setup_ray(const float* o, const float* d,
                                          int i, float t_min, Ray& r) {
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[3 * i + k];
    r.d[k] = d[3 * i + k];
    r.inv[k] = 1.0f / (r.d[k] == 0.0f ? kTiny : r.d[k]);
  }
  r.t_min = t_min;
  // C++ tie-break of the reference: x>y ? (x>z ? 0 : 2) : (y>z ? 1 : 2)
  float ax = fabsf(r.d[0]), ay = fabsf(r.d[1]), az = fabsf(r.d[2]);
  r.mj = ax > ay ? (ax > az ? 0 : 2) : (ay > az ? 1 : 2);
  r.m0 = (r.mj + 1) % 3;
  r.m1 = (r.mj + 2) % 3;
  float sz = 1.0f / comp(r.d, r.mj);
  r.sx = -comp(r.d, r.m0) * sz;
  r.sy = -comp(r.d, r.m1) * sz;
  r.oa = comp(r.o, r.m0);
  r.ob = comp(r.o, r.m1);
  r.oc = comp(r.o, r.mj);
  r.octant = (r.d[0] > 0.0f ? 4 : 0) + (r.d[1] > 0.0f ? 2 : 0) +
             (r.d[2] > 0.0f ? 1 : 0);
}

// Slab test of box c of a (6, n) lo/hi table against the (t_lo, t_hi) window
// (pallas_accel._cluster_slab).
__device__ __forceinline__ bool slab(const float* __restrict__ box, int n,
                                     int c, const Ray& r, float t_lo,
                                     float t_hi) {
  float ax0 = (box[0 * n + c] - r.o[0]) * r.inv[0];
  float ax1 = (box[3 * n + c] - r.o[0]) * r.inv[0];
  float ay0 = (box[1 * n + c] - r.o[1]) * r.inv[1];
  float ay1 = (box[4 * n + c] - r.o[1]) * r.inv[1];
  float az0 = (box[2 * n + c] - r.o[2]) * r.inv[2];
  float az1 = (box[5 * n + c] - r.o[2]) * r.inv[2];
  float near = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)), fminf(az0, az1));
  float far = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)), fmaxf(az0, az1));
  return fmaxf(near, t_lo) <= fminf(far, t_hi);
}

__device__ __forceinline__ float edge(float ax, float ay, float bx, float by) {
  float p1 = ax * by;
  float p2 = ay * bx;
  float e = p1 - p2;
  float noise = (fabsf(p1) + fabsf(p2)) * kNoise;
  return fabsf(e) <= noise ? 0.0f : e;
}

// Watertight permute-shear test of planes row `row` (geometry.watertight).
// Returns true on a hit with t strictly inside (t_min, t_hi); t, e0, e1,
// esum are set whenever it returns true.
__device__ __forceinline__ bool tri_test(const float* __restrict__ planes,
                                         int stride, int row, const Ray& r,
                                         float t_hi, float& t, float& e0,
                                         float& e1, float& esum) {
  float v[9];
  for (int k = 0; k < 9; ++k) v[k] = planes[k * stride + row];
  float nx = planes[9 * stride + row];
  float ny = planes[10 * stride + row];
  float nz = planes[11 * stride + row];
  float v0n = planes[12 * stride + row];
  float d_dot_n = r.d[0] * nx + r.d[1] * ny + r.d[2] * nz;
  float o_dot_n = r.o[0] * nx + r.o[1] * ny + r.o[2] * nz;
  t = (v0n - o_dot_n) / d_dot_n;
  if (!(t > r.t_min && t < t_hi)) return false;
  float px[3], py[3];
  for (int k = 0; k < 3; ++k) {
    const float* c = v + 3 * k;
    float ca = comp(c, r.m0) - r.oa;
    float cb = comp(c, r.m1) - r.ob;
    float cc = comp(c, r.mj) - r.oc;
    px[k] = ca + cc * r.sx;
    py[k] = cb + cc * r.sy;
  }
  e0 = edge(px[1], py[1], px[2], py[2]);
  e1 = edge(px[2], py[2], px[0], py[0]);
  float e2 = edge(px[0], py[0], px[1], py[1]);
  bool neg = (e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f);
  bool pos = (e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f);
  if ((neg && pos) || (fabsf(e0) + fabsf(e1) + fabsf(e2) == 0.0f)) return false;
  esum = e0 + e1 + e2;
  return true;
}

struct Accel {
  const float* planes;   // (13, n_cl, csize)
  const float* aabb;     // (6, n_cl)
  const float* sc_aabb;  // (6, n_sc)
  const int* morder;     // (8, n_cl)
  const int* order;      // (n_cl * csize,) original triangle id
  int n_cl, n_sc, sc_size, csize;
};

// Per-ray counters of the walk (kStats only), all (N,) int32.
struct Stats {
  int* visited;   // superclusters whose slab test passed
  int* slabs;     // member-cluster slab tests done
  int* tested;    // clusters whose triangles were tested
  int* together;  // sum over tested clusters of the warp's lanes on the
                  // same cluster in the same step
};

template <bool kStats>
__global__ void closest_hit_kernel(const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   const float* __restrict__ t_min,
                                   const float* __restrict__ t_max, int n,
                                   Accel a, float* __restrict__ t_out,
                                   long long* __restrict__ tri_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out, Stats st) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  setup_ray(o, d, i, t_min[i], r);
  float t_best = t_max[i];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  [[maybe_unused]] int n_visited = 0, n_slabs = 0, n_tested = 0,
                       n_together = 0;
  const int stride = a.n_cl * a.csize;
  const int* morder = a.morder + r.octant * a.n_cl;
  for (int sc = 0; sc < a.n_sc; ++sc) {
    if (!slab(a.sc_aabb, a.n_sc, sc, r, r.t_min, t_best)) continue;
    if constexpr (kStats) ++n_visited;
    for (int j = 0; j < a.sc_size; ++j) {
      int c = morder[sc * a.sc_size + j];
      if constexpr (kStats) ++n_slabs;
      if (!slab(a.aabb, a.n_cl, c, r, r.t_min, t_best)) continue;
      if constexpr (kStats) {
        ++n_tested;
        n_together += __popc(__match_any_sync(__activemask(), c));
      }
      int row0 = c * a.csize;
      for (int k = 0; k < a.csize; ++k) {
        float t, e0, e1, esum;
        // strict t < t_best: within a cluster the lowest row wins a tie
        if (tri_test(a.planes, stride, row0 + k, r, t_best, t, e0, e1, esum)) {
          t_best = t;
          best = row0 + k;
          float inv_det = 1.0f / esum;
          bu = e0 * inv_det;
          bv = e1 * inv_det;
        }
      }
    }
  }
  t_out[i] = best >= 0 ? t_best : INFINITY;
  if constexpr (kStats) {
    st.visited[i] = n_visited;
    st.slabs[i] = n_slabs;
    st.tested[i] = n_tested;
    st.together[i] = n_together;
  } else {
    tri_out[i] = best >= 0 ? (long long)a.order[best] : -1LL;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

__global__ void any_hit_kernel(const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ t_min,
                               const float* __restrict__ t_max, int n,
                               Accel a, bool* __restrict__ occ_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tmax = t_max[i];
  // parked or culled lanes (t_max <= 0) are never occluded
  if (!(tmax > 0.0f)) {
    occ_out[i] = false;
    return;
  }
  Ray r;
  setup_ray(o, d, i, t_min[i], r);
  const int stride = a.n_cl * a.csize;
  const int* morder = a.morder + r.octant * a.n_cl;
  for (int sc = 0; sc < a.n_sc; ++sc) {
    if (!slab(a.sc_aabb, a.n_sc, sc, r, r.t_min, tmax)) continue;
    for (int j = 0; j < a.sc_size; ++j) {
      int c = morder[sc * a.sc_size + j];
      if (!slab(a.aabb, a.n_cl, c, r, r.t_min, tmax)) continue;
      int row0 = c * a.csize;
      for (int k = 0; k < a.csize; ++k) {
        float t, e0, e1, esum;
        if (tri_test(a.planes, stride, row0 + k, r, tmax, t, e0, e1, esum)) {
          occ_out[i] = true;
          return;
        }
      }
    }
  }
  occ_out[i] = false;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int nart_closest_hit(const void* o, const void* d,
                                const void* t_min, const void* t_max, int n,
                                const void* planes, const void* aabb,
                                const void* sc_aabb, const void* morder,
                                const void* order, int n_cl, int n_sc,
                                int sc_size, int csize, void* t_out,
                                void* tri_out, void* u_out, void* v_out,
                                void* stream) {
  if (n <= 0) return 0;
  Accel a{(const float*)planes, (const float*)aabb, (const float*)sc_aabb,
          (const int*)morder,   (const int*)order,  n_cl,
          n_sc,                 sc_size,            csize};
  closest_hit_kernel<false><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)t_min,
      (const float*)t_max, n, a, (float*)t_out, (long long*)tri_out,
      (float*)u_out, (float*)v_out, Stats{});
  return (int)cudaGetLastError();
}

extern "C" int nart_closest_hit_stats(
    const void* o, const void* d, const void* t_min, const void* t_max, int n,
    const void* planes, const void* aabb, const void* sc_aabb,
    const void* morder, int n_cl, int n_sc, int sc_size, int csize,
    void* t_out, void* visited_out, void* slabs_out, void* tested_out,
    void* together_out, void* stream) {
  if (n <= 0) return 0;
  Accel a{(const float*)planes, (const float*)aabb, (const float*)sc_aabb,
          (const int*)morder,   nullptr,            n_cl,
          n_sc,                 sc_size,            csize};
  Stats st{(int*)visited_out, (int*)slabs_out, (int*)tested_out,
           (int*)together_out};
  closest_hit_kernel<true><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)t_min,
      (const float*)t_max, n, a, (float*)t_out, nullptr, nullptr, nullptr,
      st);
  return (int)cudaGetLastError();
}

extern "C" int nart_any_hit(const void* o, const void* d, const void* t_min,
                            const void* t_max, int n, const void* planes,
                            const void* aabb, const void* sc_aabb,
                            const void* morder, int n_cl, int n_sc,
                            int sc_size, int csize, void* occ_out,
                            void* stream) {
  if (n <= 0) return 0;
  Accel a{(const float*)planes, (const float*)aabb, (const float*)sc_aabb,
          (const int*)morder,   nullptr,            n_cl,
          n_sc,                 sc_size,            csize};
  any_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)t_min,
      (const float*)t_max, n, a, (bool*)occ_out);
  return (int)cudaGetLastError();
}
