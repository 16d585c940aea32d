// Closest-hit and any-hit ray traversal of the two-level triangle clusters
// built by nart_tpu_torch/cluster_accel.py (build_clusters).
//
// Replaces the two TPU kernels of nart_tpu/pallas_accel.py and the counter
// kernel of tools/kernel_stats.py:
//   * nart_closest_hit        <- _kernel        (intersect_clusters)
//   * nart_any_hit            <- _kernel_any    (intersect_clusters_any)
//   * nart_closest_hit_stats  <- _kernel_stats  (tools/kernel_stats.py run)
//   * nart_any_hit_stats      <- _kernel_stats' counters, on _kernel_any's
//                                walk (the TPU tool counts the closest-hit
//                                walk only)
// All four are one template, walk_kernel<kTiles, kAny, kStats>.
//
// The walk, per ray (unchanged by the design below, so every ray meets the
// same clusters in the same order with the same t_best): superclusters in
// index order, each behind a slab test of its AABB against the ray's
// (t_min, t_best) window; the members of a supercluster that passed in the
// ray's direction-octant order (morder: ascending centroid projection on
// the octant diagonal, so near members come first and tighten t_best),
// each behind its own slab test; then the cluster's csize watertight
// triangle tests.  The any-hit walk leaves at the first cluster with a hit,
// and never starts where t_max <= 0.
//
// What bounds it on an H100: not HBM bytes (a scene's planes are read by
// every warp and stay in L1/L2: 106 KB for the renderer's main scene) and
// not the arithmetic rate (a triangle test is 76 float operations, one of
// them an IEEE division), but how the walk schedules them.  A thread that
// walks alone runs csize dependent load-test steps for each cluster, with
// 13 strided loads a step, while the lanes of its warp that want another
// cluster, or none, wait: scheduler slots lost to divergence and exposed
// load latency.
//
// Design: a warp owns 32 consecutive rays and tests each cluster together.
// The lanes step through (supercluster, member) in lockstep, each doing its
// own slab tests (where sc_size is 1 the member's box is the supercluster's
// and is tested once).  At a member step the lanes that passed are grouped
// by the cluster they want (ballot on the first pending lane's cluster; one
// group where sc_size is 1).  For each group the whole warp loads the
// cluster once, lane L taking rows L, L+32, ... (kTiles = csize/32 rows of
// 13 floats in registers; the loads are coalesced, since consecutive rows
// of a plane are consecutive addresses), then loops over the group's rays:
// the ray's constants come from a per-warp slot in shared memory written
// once at the start (48 B a ray, read as a broadcast), its current t_best
// from the owning lane by shuffle, and every lane runs its kTiles tests,
// which are independent, so the loads, the divisions and the edge functions
// overlap.  The ray's major axis is uniform across the warp inside that
// loop, so the watertight permutation is a three-way uniform branch into
// code with constant indices.  Closest-hit reduces with two
// __reduce_min_sync: the least order-preserving image of t, then the least
// row among the lanes that hold it, so ties go to the lowest row within a
// cluster, and across clusters a hit must be strictly closer -- the rule of
// the plain version.  Any-hit is one __any_sync.  A cluster thus costs a
// warp (rays that want it) x kTiles steps with 32 lanes busy, instead of
// csize steps with those rays' lanes busy.  What is left is the count of
// the tests' own instructions (on the renderer's main scene a second pass
// of every test adds several times what a second pass of every load adds;
// nart_tpu_torch/kernel_variants.py times both), so a test runs
// its edge functions first and the plane equation with its division only
// where they pass, which a warp seldom has to wait for; and the kernel is
// held to 128 registers so that 16 warps an SM hide the rest.
//
// Not used, and why.  Tensor cores: watertightness needs every float32
// product and difference rounded on its own (the edge functions' signs
// must be consistent between neighbouring triangles,
// nart_tpu/geometry.py:24-40); TF32 keeps 10 mantissa bits, and a matrix
// unit sums products without rounding each.  TMA: a cluster is 6.5 KB that
// is already cache-resident, and a coalesced warp load of 13 x kTiles
// registers has nothing left for a copy engine to save.
//
// Numerics: the file is compiled with --fmad=false, so every multiply and
// add rounds on its own, as the op-by-op PyTorch reference does.  The
// FMA-noise snap of the edge functions is kept as well, for parity with the
// reference.  No fast-math: t = (v0.n - o.n) / (d.n) is an IEEE division.
//
// The counter entries are the walks themselves (kStats = true) and write,
// per ray, what the walk did: supercluster slab tests made (every
// supercluster for closest-hit; for any-hit those met before the ray was
// occluded), superclusters whose slab test passed, member
// steps taken (one slab test each where sc_size > 1), clusters whose
// triangles were tested, and the sum over those clusters of the size of the
// group that tested it with the ray (the TPU tool's live-lane census,
// restated for a 32-lane warp: how many rays share one load of a cluster).
// They are instruments; the bounds of the two production kernels are
// reckoned from their counters.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNoise = 2.384185791015625e-07f;  // 2^-22
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoHit = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kBlocksPerSm = 4;  // 16 warps an SM: at most 128 registers

// What the triangle tests need of a ray, as the warp reads it from shared
// memory: a = (o, t_min), b = (d, sx), c = (sy, major axis, -, -).
struct RaySlot {
  float4 a, b, c;
};

// Slab range of box c of a (6, n) lo/hi table along a ray, and the test of
// that range against the (t_lo, t_hi) window (pallas_accel._cluster_slab).
__device__ __forceinline__ void slab_range(const float* __restrict__ box,
                                           int n, int c, const float (&o)[3],
                                           const float (&inv)[3], float& near,
                                           float& far) {
  float ax0 = (box[0 * n + c] - o[0]) * inv[0];
  float ax1 = (box[3 * n + c] - o[0]) * inv[0];
  float ay0 = (box[1 * n + c] - o[1]) * inv[1];
  float ay1 = (box[4 * n + c] - o[1]) * inv[1];
  float az0 = (box[2 * n + c] - o[2]) * inv[2];
  float az1 = (box[5 * n + c] - o[2]) * inv[2];
  near = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)), fminf(az0, az1));
  far = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)), fmaxf(az0, az1));
}
__device__ __forceinline__ bool in_window(float near, float far, float t_lo,
                                          float t_hi) {
  return fmaxf(near, t_lo) <= fminf(far, t_hi);
}

__device__ __forceinline__ float edge(float ax, float ay, float bx, float by) {
  float p1 = ax * by;
  float p2 = ay * bx;
  float e = p1 - p2;
  float noise = (fabsf(p1) + fabsf(p2)) * kNoise;
  return fabsf(e) <= noise ? 0.0f : e;
}

// Watertight permute-shear test of one triangle held in registers
// (geometry.watertight); kMj is the ray's major axis.  Returns true on a
// hit with t strictly inside (t_min, t_hi); t, e0, e1, esum are set
// whenever it returns true.
template <int kMj>
__device__ __forceinline__ bool tri_test(const float (&p)[13],
                                         const float (&o)[3],
                                         const float (&d)[3], float t_min,
                                         float sx, float sy, float t_hi,
                                         float& t, float& e0, float& e1,
                                         float& esum) {
  constexpr int kM0 = (kMj + 1) % 3, kM1 = (kMj + 2) % 3;
  float px[3], py[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ca = p[3 * k + kM0] - o[kM0];
    float cb = p[3 * k + kM1] - o[kM1];
    float cc = p[3 * k + kMj] - o[kMj];
    px[k] = ca + cc * sx;
    py[k] = cb + cc * sy;
  }
  e0 = edge(px[1], py[1], px[2], py[2]);
  e1 = edge(px[2], py[2], px[0], py[0]);
  float e2 = edge(px[0], py[0], px[1], py[1]);
  bool neg = (e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f);
  bool pos = (e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f);
  if ((neg && pos) || (fabsf(e0) + fabsf(e1) + fabsf(e2) == 0.0f)) return false;
  // the plane equation after the edge functions: few triangles pass them,
  // so a warp seldom pays for the division (the order changes no value)
  float d_dot_n = d[0] * p[9] + d[1] * p[10] + d[2] * p[11];
  float o_dot_n = o[0] * p[9] + o[1] * p[10] + o[2] * p[11];
  t = (p[12] - o_dot_n) / d_dot_n;
  if (!(t > t_min && t < t_hi)) return false;
  esum = e0 + e1 + e2;
  return true;
}

// The lane's nearest hit among its kTiles triangles (rows row0 + lane,
// + 32, ...: ascending, so a strict < keeps the lowest row of a tie).
template <int kTiles, int kMj>
__device__ __forceinline__ bool lane_test(const float (&p)[kTiles][13],
                                          const float (&o)[3],
                                          const float (&d)[3], float t_min,
                                          float sx, float sy, float t_hi,
                                          float& t, int& tile, float& e0,
                                          float& e1, float& esum) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    float tk, e0k, e1k, esk;
    if (tri_test<kMj>(p[k], o, d, t_min, sx, sy, hit ? t : t_hi, tk, e0k, e1k,
                      esk)) {
      hit = true;
      t = tk;
      tile = k;
      e0 = e0k;
      e1 = e1k;
      esum = esk;
    }
  }
  return hit;
}

// Order-preserving map of a float's bits to unsigned, and back.
__device__ __forceinline__ unsigned float_key(float x) {
  unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Accel {
  const float* planes;   // (13, n_cl, csize)
  const float* aabb;     // (6, n_cl)
  const float* sc_aabb;  // (6, n_sc)
  const int* morder;     // (8, n_cl)
  const int* order;      // (n_cl * csize,) original triangle id
  int n_cl, n_sc, sc_size, csize;
};

// Per-ray outputs; the counters (kStats only) are (N,) int32.
struct Out {
  float* t;        // closest-hit
  long long* tri;  // closest-hit, not kStats
  float* u;
  float* v;
  bool* occ;       // any-hit
  int* visited;    // superclusters whose slab test passed
  int* slabs;      // member steps taken
  int* tested;     // clusters whose triangles were tested
  int* together;   // sum over tested clusters of the group's size
  int* sc_tests;   // supercluster slab tests made
};

template <int kTiles, bool kAny, bool kStats>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
            const float* __restrict__ t_min_in,
            const float* __restrict__ t_max_in, int n, Accel a, Out out) {
  __shared__ RaySlot slots[kWarpsPerBlock][kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  RaySlot* warp_slots = slots[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int ld = i < n ? i : n - 1;  // lanes past the end walk nothing

  float o[3], inv[3], dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = o_in[3 * ld + k];
    dir[k] = d_in[3 * ld + k];
    inv[k] = 1.0f / (dir[k] == 0.0f ? kTiny : dir[k]);
  }
  const float t_min = t_min_in[ld];
  float t_best = t_max_in[ld];
  // parked or culled lanes (t_max <= 0) never join the any-hit walk
  bool alive = i < n && (!kAny || t_best > 0.0f);
  {
    // C++ tie-break of the reference: x>y ? (x>z ? 0 : 2) : (y>z ? 1 : 2)
    float ax = fabsf(dir[0]), ay = fabsf(dir[1]), az = fabsf(dir[2]);
    int mj = ax > ay ? (ax > az ? 0 : 2) : (ay > az ? 1 : 2);
    float dj = mj == 0 ? dir[0] : (mj == 1 ? dir[1] : dir[2]);
    float d0 = mj == 0 ? dir[1] : (mj == 1 ? dir[2] : dir[0]);  // minor 0
    float d1 = mj == 0 ? dir[2] : (mj == 1 ? dir[0] : dir[1]);  // minor 1
    float sz = 1.0f / dj;
    warp_slots[lane].a = make_float4(o[0], o[1], o[2], t_min);
    warp_slots[lane].b = make_float4(dir[0], dir[1], dir[2], -d0 * sz);
    warp_slots[lane].c = make_float4(-d1 * sz, __int_as_float(mj), 0.0f, 0.0f);
  }
  __syncwarp();
  const int octant = (dir[0] > 0.0f ? 4 : 0) + (dir[1] > 0.0f ? 2 : 0) +
                     (dir[2] > 0.0f ? 1 : 0);
  const int* morder = a.morder + octant * a.n_cl;
  const int stride = a.n_cl * a.csize;

  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  [[maybe_unused]] int n_visited = 0, n_slabs = 0, n_tested = 0,
                       n_together = 0, n_sc_tests = 0;

  for (int sc = 0; sc < a.n_sc; ++sc) {
    if constexpr (kAny) {
      if (!__any_sync(kFull, alive)) break;  // every ray occluded or parked
    }
    if constexpr (kStats) n_sc_tests += alive;
    float near, far;
    slab_range(a.sc_aabb, a.n_sc, sc, o, inv, near, far);
    const bool in_sc = alive && in_window(near, far, t_min, t_best);
    if constexpr (kStats) n_visited += in_sc;
    if (!__any_sync(kFull, in_sc)) continue;
    for (int j = 0; j < a.sc_size; ++j) {
      // sc_size 1: the member is cluster sc and its box the supercluster's,
      // just tested
      int c = sc;
      bool want = false;
      if (in_sc && alive) {  // an occluded any-hit ray has left the walk
        if constexpr (kStats) ++n_slabs;
        want = true;
        if (a.sc_size > 1) {
          c = morder[sc * a.sc_size + j];
          slab_range(a.aabb, a.n_cl, c, o, inv, near, far);
          want = in_window(near, far, t_min, t_best);
        }
      }
      unsigned pending = __ballot_sync(kFull, want);
      while (pending) {
        const int cg = __shfl_sync(kFull, c, __ffs(pending) - 1);
        const unsigned group = __ballot_sync(kFull, want && c == cg);
        pending &= ~group;
        if constexpr (kStats) {
          if ((group >> lane) & 1u) {
            ++n_tested;
            n_together += __popc(group);
          }
        }
        // the whole warp tests cluster cg for the group's rays, kTiles * 32
        // rows at a time (one pass unless csize > 32 * kTiles)
        for (int base = 0; base < a.csize; base += kTiles * kWarp) {
          float p[kTiles][13];
#pragma unroll
          for (int k = 0; k < kTiles; ++k) {
            const int r = base + k * kWarp + lane;
            const float* src = a.planes + cg * a.csize + r;
#pragma unroll
            for (int q = 0; q < 13; ++q) {
              // rows past the cluster's end: zero planes cannot hit
              p[k][q] = r < a.csize ? src[q * stride] : 0.0f;
            }
          }
          unsigned rest = group;
          while (rest) {
            const int owner = __ffs(rest) - 1;
            rest &= rest - 1;
            const float4 ra = warp_slots[owner].a;
            const float4 rb = warp_slots[owner].b;
            const float4 rc = warp_slots[owner].c;
            const float ro[3] = {ra.x, ra.y, ra.z};
            const float rd[3] = {rb.x, rb.y, rb.z};
            const float t_hi = __shfl_sync(kFull, t_best, owner);
            const int mj = __float_as_int(rc.y);
            float t = 0.0f, e0 = 0.0f, e1 = 0.0f, esum = 1.0f;
            int tile = 0;
            bool hit;
            // mj is the owner's: uniform across the warp
            if (mj == 0) {
              hit = lane_test<kTiles, 0>(p, ro, rd, ra.w, rb.w, rc.x, t_hi, t,
                                         tile, e0, e1, esum);
            } else if (mj == 1) {
              hit = lane_test<kTiles, 1>(p, ro, rd, ra.w, rb.w, rc.x, t_hi, t,
                                         tile, e0, e1, esum);
            } else {
              hit = lane_test<kTiles, 2>(p, ro, rd, ra.w, rb.w, rc.x, t_hi, t,
                                         tile, e0, e1, esum);
            }
            if constexpr (kAny) {
              if (__any_sync(kFull, hit) && lane == owner) {
                best = 0;
                alive = false;
              }
            } else {
              const unsigned key = hit ? float_key(t) : kNoHit;
              const unsigned key_min = __reduce_min_sync(kFull, key);
              if (key_min != kNoHit) {  // uniform
                const unsigned row =
                    cg * a.csize + base + tile * kWarp + lane;
                const unsigned row_min = __reduce_min_sync(
                    kFull, key == key_min ? row : kNoHit);
                const int src_lane = (row_min - cg * a.csize) & (kWarp - 1);
                const float inv_det = 1.0f / esum;
                const float u = __shfl_sync(kFull, e0 * inv_det, src_lane);
                const float v = __shfl_sync(kFull, e1 * inv_det, src_lane);
                if (lane == owner) {
                  t_best = key_float(key_min);
                  best = (int)row_min;
                  bu = u;
                  bv = v;
                }
              }
            }
          }
        }
      }
    }
  }
  if (i >= n) return;
  if constexpr (kAny) {
    out.occ[i] = best >= 0;
  } else {
    out.t[i] = best >= 0 ? t_best : INFINITY;
    if constexpr (!kStats) {
      out.tri[i] = best >= 0 ? (long long)a.order[best] : -1LL;
      out.u[i] = bu;
      out.v[i] = bv;
    }
  }
  if constexpr (kStats) {
    out.visited[i] = n_visited;
    out.slabs[i] = n_slabs;
    out.tested[i] = n_tested;
    out.together[i] = n_together;
    out.sc_tests[i] = n_sc_tests;
  }
}

// kTiles rows a lane holds: csize / 32, rounded up to 1, 2 or 4 (a larger
// cluster is tested in passes of 128 rows).
template <bool kAny, bool kStats>
int launch(const void* o, const void* d, const void* t_min, const void* t_max,
           int n, const void* planes, const void* aabb, const void* sc_aabb,
           const void* morder, const void* order, int n_cl, int n_sc,
           int sc_size, int csize, Out out, void* stream) {
  if (n <= 0) return 0;
  Accel a{(const float*)planes, (const float*)aabb, (const float*)sc_aabb,
          (const int*)morder,   (const int*)order,  n_cl,
          n_sc,                 sc_size,            csize};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const float* lo = (const float*)t_min;
  const float* hi = (const float*)t_max;
  if (csize > 2 * kWarp) {
    walk_kernel<4, kAny, kStats><<<blocks, kThreads, 0, s>>>(fo, fd, lo, hi, n,
                                                             a, out);
  } else if (csize > kWarp) {
    walk_kernel<2, kAny, kStats><<<blocks, kThreads, 0, s>>>(fo, fd, lo, hi, n,
                                                             a, out);
  } else {
    walk_kernel<1, kAny, kStats><<<blocks, kThreads, 0, s>>>(fo, fd, lo, hi, n,
                                                             a, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nart_closest_hit(const void* o, const void* d,
                                const void* t_min, const void* t_max, int n,
                                const void* planes, const void* aabb,
                                const void* sc_aabb, const void* morder,
                                const void* order, int n_cl, int n_sc,
                                int sc_size, int csize, void* t_out,
                                void* tri_out, void* u_out, void* v_out,
                                void* stream) {
  Out out{};
  out.t = (float*)t_out;
  out.tri = (long long*)tri_out;
  out.u = (float*)u_out;
  out.v = (float*)v_out;
  return launch<false, false>(o, d, t_min, t_max, n, planes, aabb, sc_aabb,
                              morder, order, n_cl, n_sc, sc_size, csize, out,
                              stream);
}

extern "C" int nart_any_hit(const void* o, const void* d, const void* t_min,
                            const void* t_max, int n, const void* planes,
                            const void* aabb, const void* sc_aabb,
                            const void* morder, int n_cl, int n_sc,
                            int sc_size, int csize, void* occ_out,
                            void* stream) {
  Out out{};
  out.occ = (bool*)occ_out;
  return launch<true, false>(o, d, t_min, t_max, n, planes, aabb, sc_aabb,
                             morder, nullptr, n_cl, n_sc, sc_size, csize, out,
                             stream);
}

// The counter entries: `hit_out` is t (float32) for the closest-hit walk and
// the occlusion (bool) for the any-hit walk.
template <bool kAny>
int launch_stats(const void* o, const void* d, const void* t_min,
                 const void* t_max, int n, const void* planes,
                 const void* aabb, const void* sc_aabb, const void* morder,
                 int n_cl, int n_sc, int sc_size, int csize, void* hit_out,
                 void* visited_out, void* slabs_out, void* tested_out,
                 void* together_out, void* sc_tests_out, void* stream) {
  Out out{};
  if (kAny) {
    out.occ = (bool*)hit_out;
  } else {
    out.t = (float*)hit_out;
  }
  out.visited = (int*)visited_out;
  out.slabs = (int*)slabs_out;
  out.tested = (int*)tested_out;
  out.together = (int*)together_out;
  out.sc_tests = (int*)sc_tests_out;
  return launch<kAny, true>(o, d, t_min, t_max, n, planes, aabb, sc_aabb,
                            morder, nullptr, n_cl, n_sc, sc_size, csize, out,
                            stream);
}

extern "C" int nart_closest_hit_stats(
    const void* o, const void* d, const void* t_min, const void* t_max, int n,
    const void* planes, const void* aabb, const void* sc_aabb,
    const void* morder, int n_cl, int n_sc, int sc_size, int csize,
    void* t_out, void* visited_out, void* slabs_out, void* tested_out,
    void* together_out, void* sc_tests_out, void* stream) {
  return launch_stats<false>(o, d, t_min, t_max, n, planes, aabb, sc_aabb,
                             morder, n_cl, n_sc, sc_size, csize, t_out,
                             visited_out, slabs_out, tested_out, together_out,
                             sc_tests_out, stream);
}

extern "C" int nart_any_hit_stats(
    const void* o, const void* d, const void* t_min, const void* t_max, int n,
    const void* planes, const void* aabb, const void* sc_aabb,
    const void* morder, int n_cl, int n_sc, int sc_size, int csize,
    void* occ_out, void* visited_out, void* slabs_out, void* tested_out,
    void* together_out, void* sc_tests_out, void* stream) {
  return launch_stats<true>(o, d, t_min, t_max, n, planes, aabb, sc_aabb,
                            morder, n_cl, n_sc, sc_size, csize, occ_out,
                            visited_out, slabs_out, tested_out, together_out,
                            sc_tests_out, stream);
}
