// The port's host runtime core: .geo mesh parsing (fan triangulation and
// world transform), .vol density-grid parsing, and the LBVH build (Morton
// sort, then the bottom-up box tree).
//
// Counterpart of nart_tpu/native/core.cpp, with the same extern "C" entry
// points and the same float32 order of operations, so that every output has
// the bits of the numpy versions in geo.py (load_geo_plain), vol.py
// (load_vol_plain) and bvh.py (build_bvh_arrays), which the CPU tests hold
// it to (tests/test_torch_native.py).  It is host code: no kernel, nothing
// on the card.  It replaces no TPU kernel either: the JAX package keeps
// this cold path in C++ too (the reference's scene.cpp:77-343 and :825-867,
// bvh.cpp:252-326).
//
// Built by cuda_build.build_host("core") with g++ -O3 -ffp-contract=off:
// a multiply and an add are never contracted into an FMA, whatever the
// host, so each product rounds on its own as in numpy (the host twin of the
// kernels' --fmad=false).  Bound with ctypes by native.py.
//
// A parse runs in two calls: *_open parses the file into this thread's
// buffers and returns the sizes, the caller allocates, and *_read_into
// copies the result out and frees the buffers.  Every entry returns 0 on
// success; on failure 1 (a malformed file) or 2 (a file that cannot be
// opened), with the reason in core_last_error().

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

constexpr int kBadFile = 1;
constexpr int kNoFile = 2;

int fail(int code, const std::string& why) {
  g_error = why;
  return code;
}

// The whole file in memory, NUL-terminated (strtod stops at the NUL).
int read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return fail(kNoFile, std::string("could not open ") + path);
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return fail(kBadFile, std::string("could not size ") + path);
  }
  out->assign(static_cast<size_t>(n), '\0');
  const size_t got =
      n > 0 ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n))
    return fail(kBadFile, std::string("short read on ") + path);
  return 0;
}

// Whitespace-separated numbers, each parsed as a double (as numpy's
// fromfile(sep=" ") does) and narrowed where the caller asks.
class Numbers {
 public:
  explicit Numbers(const std::string& text)
      : p_(text.c_str()), end_(text.c_str() + text.size()) {}

  bool next(double* out) {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' ||
                         *p_ == '\r' || *p_ == '\v' || *p_ == '\f'))
      ++p_;
    if (p_ >= end_) return false;
    char* q = nullptr;
    *out = std::strtod(p_, &q);
    if (q == p_) return false;
    p_ = q;
    return true;
  }

  // float64 -> float32, rounded to nearest (numpy's astype(np.float32))
  bool next_f32(float* out) {
    double v;
    if (!next(&v)) return false;
    *out = static_cast<float>(v);
    return true;
  }

  // an index: a number in [0, 2^32), truncated (numpy's astype(np.int64))
  bool next_index(uint32_t* out, bool* bad) {
    double v;
    if (!next(&v)) return false;
    if (!(v >= 0.0 && v < 4294967296.0)) {
      *bad = true;
      return false;
    }
    *out = static_cast<uint32_t>(v);
    return true;
  }

  // the most numbers the rest of the text can hold (each takes a character
  // and a separator), so that a count read from the file is checked before
  // anything is allocated for it
  uint64_t most_left() const {
    return static_cast<uint64_t>(end_ - p_ + 1) / 2;
  }

 private:
  const char* p_;
  const char* end_;
};

// ---------------------------------------------------------------------------
// .geo meshes
// ---------------------------------------------------------------------------

struct Mesh {
  std::vector<float> v, n, uv;  // (T, 3, 3), (T, 3, 3), (T, 3, 2)
};
thread_local Mesh g_mesh;

// One index section of nvi corners; its largest index in *top.
// An optional section (the uvs) that is absent altogether sets *absent.
int read_indices(Numbers* nums, uint64_t nvi, std::vector<uint32_t>* idx,
                 uint32_t* top, bool* absent) {
  if (nvi > nums->most_left()) {
    double v;
    if (absent != nullptr && !nums->next(&v)) {
      *absent = true;
      return 0;
    }
    return fail(kBadFile, "truncated index section");
  }
  idx->resize(nvi);
  *top = 0;
  for (uint64_t i = 0; i < nvi; ++i) {
    bool bad = false;
    if (!nums->next_index(&(*idx)[i], &bad)) {
      if (bad) return fail(kBadFile, "an index is not in [0, 2^32)");
      if (absent != nullptr && i == 0) {
        *absent = true;
        return 0;
      }
      return fail(kBadFile, "truncated index section");
    }
    *top = std::max(*top, (*idx)[i]);
  }
  return 0;
}

int read_floats(Numbers* nums, uint64_t count, std::vector<float>* out) {
  if (count > nums->most_left())
    return fail(kBadFile, "truncated coordinate section");
  out->resize(count);
  for (uint64_t i = 0; i < count; ++i)
    if (!nums->next_f32(&(*out)[i]))
      return fail(kBadFile, "truncated coordinate section");
  return 0;
}

}  // namespace

extern "C" {

const char* core_last_error() { return g_error.c_str(); }

// Parses a .geo mesh (numFaces, faceVertCount[], vertIndex[], vertCoord[],
// normIndex[], normCoord[], then optionally uvIndex[], uvCoord[]),
// fan-triangulates it and moves it to world space: p' = M[:3,:3] p +
// M[:3,3] with m16 the row-major 4x4 objectToWorld, n' = normalize(N n)
// with nm9 the row-major normal matrix inv(M)[:3,:3]^T (the caller's, in
// numpy's float32).  Sets *n_tris; geo_read_into copies the mesh out.
int geo_open(const char* path, const float* m16, const float* nm9,
             int64_t* n_tris) {
  g_mesh = Mesh();
  std::string text;
  if (int rc = read_file(path, &text)) return rc;
  Numbers nums(text);

  double count;
  if (!nums.next(&count)) return fail(kBadFile, "could not read face count");
  if (!(count >= 0.0 && count < 4294967296.0))
    return fail(kBadFile, "bad face count");
  const uint64_t n_faces = static_cast<uint64_t>(count);
  if (n_faces > nums.most_left())
    return fail(kBadFile, "truncated face counts");
  std::vector<uint32_t> faces(n_faces);
  uint64_t nvi = 0;
  for (uint64_t i = 0; i < n_faces; ++i) {
    bool bad = false;
    if (!nums.next_index(&faces[i], &bad))
      return fail(kBadFile, bad ? "bad face vertex count"
                                : "truncated face counts");
    nvi += faces[i];
  }
  if (nvi == 0) return fail(kBadFile, "the mesh has no face corners");

  std::vector<uint32_t> vert_idx, norm_idx, uv_idx;
  std::vector<float> verts, norms, uvs;
  uint32_t top_v, top_n, top_uv;
  bool no_uvs = false;
  if (int rc = read_indices(&nums, nvi, &vert_idx, &top_v, nullptr)) return rc;
  if (int rc = read_floats(&nums, (uint64_t{top_v} + 1) * 3, &verts)) return rc;
  if (int rc = read_indices(&nums, nvi, &norm_idx, &top_n, nullptr)) return rc;
  if (int rc = read_floats(&nums, (uint64_t{top_n} + 1) * 3, &norms)) return rc;
  if (int rc = read_indices(&nums, nvi, &uv_idx, &top_uv, &no_uvs)) return rc;
  if (!no_uvs)
    if (int rc = read_floats(&nums, (uint64_t{top_uv} + 1) * 2, &uvs))
      return rc;

  // world space, one float32 operation at a time, left to right
  for (size_t i = 0; i < verts.size(); i += 3) {
    const float x = verts[i], y = verts[i + 1], z = verts[i + 2];
    for (int r = 0; r < 3; ++r)
      verts[i + r] =
          m16[4 * r] * x + m16[4 * r + 1] * y + m16[4 * r + 2] * z +
          m16[4 * r + 3];
  }
  for (size_t i = 0; i < norms.size(); i += 3) {
    const float x = norms[i], y = norms[i + 1], z = norms[i + 2];
    float w[3];
    for (int r = 0; r < 3; ++r)
      w[r] = nm9[3 * r] * x + nm9[3 * r + 1] * y + nm9[3 * r + 2] * z;
    const float len = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
    const float inv = 1.0f / std::max(len, 1e-20f);
    for (int r = 0; r < 3; ++r) norms[i + r] = w[r] * inv;
  }

  // fan triangulation: face (i0, ..., ik) -> (i0, ij+1, ij+2)
  // (scene.cpp:274-282); faces of fewer than 3 corners make none
  uint64_t tris = 0;
  for (uint32_t c : faces) tris += c >= 2 ? c - 2 : 0;
  g_mesh.v.resize(tris * 9);
  g_mesh.n.resize(tris * 9);
  g_mesh.uv.resize(tris * 6);
  // the uvs of a mesh without any: the reference Triangle's defaults
  // (geometry.h:58-60), (0, 0) (0, 1) (1, 0)
  static const float kDefaultUV[6] = {0.f, 0.f, 0.f, 1.f, 1.f, 0.f};
  uint64_t first = 0, t = 0;
  for (uint32_t c : faces) {
    for (uint32_t j = 0; j + 2 < c; ++j, ++t) {
      const uint64_t corner[3] = {first, first + j + 1, first + j + 2};
      for (int k = 0; k < 3; ++k) {
        std::memcpy(&g_mesh.v[t * 9 + k * 3], &verts[vert_idx[corner[k]] * 3ull],
                    3 * sizeof(float));
        std::memcpy(&g_mesh.n[t * 9 + k * 3], &norms[norm_idx[corner[k]] * 3ull],
                    3 * sizeof(float));
        const float* uv = no_uvs ? &kDefaultUV[k * 2]
                                 : &uvs[uv_idx[corner[k]] * 2ull];
        std::memcpy(&g_mesh.uv[t * 6 + k * 2], uv, 2 * sizeof(float));
      }
    }
    first += c;
  }
  *n_tris = static_cast<int64_t>(tris);
  return 0;
}

// Copies the mesh of this thread's last geo_open out (v, n: (T, 3, 3); uv:
// (T, 3, 2) float32) and frees it.
int geo_read_into(float* v, float* n, float* uv) {
  std::memcpy(v, g_mesh.v.data(), g_mesh.v.size() * sizeof(float));
  std::memcpy(n, g_mesh.n.data(), g_mesh.n.size() * sizeof(float));
  std::memcpy(uv, g_mesh.uv.data(), g_mesh.uv.size() * sizeof(float));
  g_mesh = Mesh();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .vol density grids (scene.cpp:825-867): bmin.xyz bmax.xyz res.xyz, then
// resX * resY * resZ densities, x fastest
// ---------------------------------------------------------------------------

namespace {
thread_local std::vector<float> g_density;
}  // namespace

extern "C" {

// header9: bmin.xyz, bmax.xyz (float32 values, widened) and the three
// resolutions; vol_read_into copies the densities out.
int vol_open(const char* path, double* header9) {
  g_density = std::vector<float>();
  std::string text;
  if (int rc = read_file(path, &text)) return rc;
  Numbers nums(text);
  double h[9];
  for (int i = 0; i < 9; ++i)
    if (!nums.next(&h[i])) return fail(kBadFile, "truncated .vol header");
  for (int i = 0; i < 6; ++i) header9[i] = static_cast<float>(h[i]);
  double count = 1.0;  // exact: the check below bounds it by the file size
  for (int i = 6; i < 9; ++i) {
    if (!(h[i] >= 0.0 && h[i] < 2147483648.0))
      return fail(kBadFile, "bad .vol resolution");
    header9[i] = std::trunc(h[i]);
    count *= header9[i];
    if (count > static_cast<double>(nums.most_left()))
      return fail(kBadFile, "truncated .vol density data");
  }
  g_density.resize(static_cast<size_t>(count));
  for (size_t i = 0; i < g_density.size(); ++i)
    if (!nums.next_f32(&g_density[i]))
      return fail(kBadFile, "truncated .vol density data");
  return 0;
}

// Copies the densities of this thread's last vol_open out and frees them.
int vol_read_into(float* density) {
  std::memcpy(density, g_density.data(), g_density.size() * sizeof(float));
  g_density = std::vector<float>();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LBVH build (bvh.py build_bvh_arrays, the same bits)
// ---------------------------------------------------------------------------

namespace {

// 10 bits spread to every third of 30 (cluster_accel._expand_bits)
inline uint32_t spread10(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// np.clip(a * 1024.0, 0, 1023).astype(np.uint32) in float32
inline uint32_t quantize10(float a) {
  const float s = std::min(std::max(a * 1024.0f, 0.0f), 1023.0f);
  return static_cast<uint32_t>(s);
}

}  // namespace

extern "C" {

// The complete binary tree over Morton-ordered leaves of leaf_size
// triangles.  tri_v: (t, 3, 3) float32, t >= 1; n_leaves: the power of two
// the caller computed, >= ceil(t / leaf_size).  Writes (caller-allocated):
// node_lo, node_hi (2 n_leaves - 1, 3), node i's children 2i+1 and 2i+2,
// the leaves last, padding leaves +inf / -inf; order (n_leaves leaf_size,)
// the original id of each slot, -1 on padding; tri_out (n_leaves leaf_size,
// 3, 3) the triangles in that order, zeros on padding.
int lbvh_build(const float* tri_v, int64_t t, int32_t leaf_size,
               int32_t n_leaves, float* node_lo, float* node_hi,
               int32_t* order, float* tri_out) {
  if (t < 1 || leaf_size < 1 || n_leaves < 1 ||
      static_cast<int64_t>(n_leaves) * leaf_size < t)
    return fail(kBadFile, "bad lbvh_build sizes");
  const float inf = std::numeric_limits<float>::infinity();
  const size_t nt = static_cast<size_t>(t);
  std::vector<float> lo(nt * 3), hi(nt * 3);
  float scene_lo[3] = {inf, inf, inf}, scene_hi[3] = {-inf, -inf, -inf};
  for (size_t i = 0; i < nt; ++i) {
    const float* v = tri_v + i * 9;
    for (int a = 0; a < 3; ++a) {
      const float m = std::min(std::min(v[a], v[3 + a]), v[6 + a]);
      const float M = std::max(std::max(v[a], v[3 + a]), v[6 + a]);
      lo[i * 3 + a] = m;
      hi[i * 3 + a] = M;
      scene_lo[a] = std::min(scene_lo[a], m);
      scene_hi[a] = std::max(scene_hi[a], M);
    }
  }
  float extent[3];
  for (int a = 0; a < 3; ++a)
    extent[a] = std::max(scene_hi[a] - scene_lo[a], 1e-12f);

  std::vector<uint32_t> code(nt);
  for (size_t i = 0; i < nt; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      const float c = 0.5f * (lo[i * 3 + a] + hi[i * 3 + a]);
      q[a] = quantize10((c - scene_lo[a]) / extent[a]);
    }
    code[i] = (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
  }
  std::vector<int32_t> by_code(nt);
  std::iota(by_code.begin(), by_code.end(), 0);
  std::stable_sort(by_code.begin(), by_code.end(),
                   [&](int32_t a, int32_t b) { return code[a] < code[b]; });

  const size_t slots = static_cast<size_t>(n_leaves) * leaf_size;
  std::fill(order, order + slots, -1);
  std::fill(tri_out, tri_out + slots * 9, 0.0f);
  for (size_t i = 0; i < nt; ++i) {
    order[i] = by_code[i];
    std::memcpy(tri_out + i * 9, tri_v + static_cast<size_t>(by_code[i]) * 9,
                9 * sizeof(float));
  }

  const size_t n_nodes = 2 * static_cast<size_t>(n_leaves) - 1;
  const size_t leaf0 = static_cast<size_t>(n_leaves) - 1;
  std::fill(node_lo, node_lo + n_nodes * 3, inf);
  std::fill(node_hi, node_hi + n_nodes * 3, -inf);
  for (size_t k = 0; k < nt; ++k) {  // padding slots keep +-inf
    float* nl = node_lo + (leaf0 + k / leaf_size) * 3;
    float* nh = node_hi + (leaf0 + k / leaf_size) * 3;
    const size_t src = static_cast<size_t>(order[k]);
    for (int a = 0; a < 3; ++a) {
      nl[a] = std::min(nl[a], lo[src * 3 + a]);
      nh[a] = std::max(nh[a], hi[src * 3 + a]);
    }
  }
  for (size_t i = leaf0; i-- > 0;) {
    for (int a = 0; a < 3; ++a) {
      node_lo[i * 3 + a] =
          std::min(node_lo[(2 * i + 1) * 3 + a], node_lo[(2 * i + 2) * 3 + a]);
      node_hi[i * 3 + a] =
          std::max(node_hi[(2 * i + 1) * 3 + a], node_hi[(2 * i + 2) * 3 + a]);
    }
  }
  return 0;
}

}  // extern "C"
