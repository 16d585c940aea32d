// The BSDF lobe mixture of a path round, one thread a lane: the port's
// counterparts of nart_tpu/bxdf.py's bsdf_sample_f (:618, with _lobe_sample
// :566 and _vndf_sample :212), bsdf_f (:594) and bsdf_pdf (:602), and of
// XLA's autodiff of their f.  nart_tpu_torch/bsdf_ops.py binds the entries:
//   * nart_bsdf_sample  (X1) BSDF::Sample_f: the lobe pick by u1, the picked
//                       lobe's sample, its eta, the other lobe's f and pdf
//                       mixed in off the specular path, pdf / n_lobes there;
//                       also one int32 of lobe bits a lane for X3
//   * nart_bsdf_sample_eval  (X2, redesigned) X1's sample and bsdf_f with
//                       bsdf_pdf at a second direction wi_b of the same
//                       lanes in one launch: a path round's strategy-A
//                       sample and strategy-B eval (bxdf.py :618, :594,
//                       :602), X1's and X2's bits
//   * nart_bsdf_eval    (X2's first design) bsdf_f and bsdf_pdf of one (wo,
//                       wi) in a launch of its own: the kernel of
//                       eval_f_pdf, and the reference the sample+eval
//                       launch's eval outputs are held to; no path launches
//                       it
//   * nart_bsdf_f_bwd   (X3) the vector-Jacobian product of X1's f, alpha_i
//                       and eta_sampled (mode 0) or of X2's f (mode 1) with
//                       wi held fixed, as every call site detaches wi and
//                       pdf: per-lane rows of the gradients of rho_d, rho_s,
//                       tau, eta, alpha0, alpha_prime, wo and eta_outer (no
//                       reduction, no atomics; autograd sums them into the
//                       leaves through the look-ups' backwards)
//   * nart_bsdf_sample_ref, nart_bsdf_f_bwd_ref: X1's and X3's first design,
//                       the references the redesign is held to (X1 bit for
//                       bit, X3 to the float64 VJP's tolerance); no path
//                       launches them
//
// No Pallas kernel stands behind these functions: on the TPU XLA fuses the
// JAX package's masked evaluation of every lobe kind on every lane into a
// few fusions.  The port's plain versions (nart_tpu_torch/bxdf.py) run the
// same masked evaluation op by op: ~2,500 small kernels a bsdf_sample_f,
// 80% of a path round's.  Here a lane computes only its own lobes.
//
// One copy of the lobe math: every function below that f depends on is a
// template on its scalar type T, float in X1 and X2 and Dual in X3.  A Dual
// carries the value, computed by the very operations of the float version
// (so X3 follows X1's and X2's branches bit for bit), and its derivatives
// along six directions: eta, alpha (alpha_prime or alpha0, as use_prime
// picks), wo.x, wo.y, wo.z and eta_outer (forward mode).  Every lobe's f is
// a table row times a scalar, or a constant (LobeF): rho_d / pi, rho_s * s,
// tau * s, rho_s (TIR), tau (index-matched), 1 (a grazing mirror) or 0, so
// the rows' gradients are the cotangent times the scalar, and the scalar's
// six derivatives give the rest.  The sampling itself (VNDF, refraction,
// the choices) is float only: its results are detached.  A derivative is
// torch's where the plain autograd defines one (abs' sign(0) = 0, a clamp
// passes the gradient on its closed interval, a where only to the branch
// taken), and an unselected branch is never evaluated.
//
// Numerics: the file is compiled with --fmad=false, and each float
// operation is the plain version's on the card, in its order, rounded where
// it rounds: torch's sum over a last dimension of 3 adds ((x0 + x2) + x1)
// from a zero (so -0 comes out +0), torch.linalg.cross rounds each
// component's difference of products once, fused (a1 b2 - a2 b1 =
// fma(a1, b2, -(a2 b1))), x ** 2 is x * x, 1.0 / x is the reciprocal, clamps
// are fminf / fmaxf passing NaN through, and cosf, sinf, sqrtf and division
// give the card's torch kernels' bits (checked per operation on an H100:
// chip_smoke.py phase 27 holds every output of X1 and X2 to the plain
// version's bits).
//
// What bounds it on an H100: the bytes.  X1 moves 157 bytes a lane (each
// input read once, each output written once), X2's first design 117, the
// sample+eval launch 185 (X1's 157, wi_b's 12 in, f_b's and pdf_b's 16
// out; X1 then X2 in two launches move 274), X3 205: at 65,536 lanes
// 2.3-4.0 us at 3.35 TB/s.  A lane's operations take less: at most ~400
// float32 ones in X1 and X2, ~1,300-1,600 float64 ones in X3's
// duals (counted by a host build with counting scalars:
// chip_smoke.py's BSDF_OPS).  The first design (Design with both steps
// off below, the _ref entries) read a lane's table row by a runtime index
// (an 88-byte stack frame in X1), and X3 kept a lane's dual inputs and its
// rows' gradients in a 496-byte stack frame and took seven float64
// divisions for each dual division, with no FMA (224 registers).  The
// redesign's two steps are switches of Design, so that `python -m
// nart_tpu_torch.kernel_variants --kernel bsdf` builds and times them
// alone and together (PERF.md, X1 and X3):
//   1. kRcp: X3's duals take one float64 reciprocal a division (and one
//      rsqrt a square root) and multiply by it for the value and the
//      tangents, and update the tangents with explicit fma() (which
//      --fmad=false leaves alone).  The float32 value keeps its operations.
//   2. kConstRows: no local memory.  A lobe's table row is picked by
//      constant indices (a select over the three rows), the rows'
//      gradients are per-table sums of named scalars, and a dual is
//      selected member by member on values (pick): a select of two duals'
//      addresses kept the lane's inputs in local memory.  Stack frame 0 B
//      in X1, X2 and X3.
// X2's redesign is a launch, not a step of Design.  X2 alone was a short
// launch of its own (65,536 lanes are one wave of 512 blocks, ~15 warps an
// SM, too few to hide a lane's chain of loads, branches, divisions and
// square roots) right after X1's strategy-A launch on the same lanes.
// Strategy B's direction depends on no BSDF output, so
// nart_bsdf_sample_eval takes both in one launch of twice X1's blocks:
// the first half runs X1's body (sample_lane), the second X2's (eval_lane)
// at wi_b, the same functions and so the same bits; one launch a round
// fewer, and twice the warps of a one-wave launch.  A lane's rows are read
// by two threads (the second read may meet the first in L2).  Measured
// and not taken (`kernel_variants --kernel bsdf`, the "SE" variants): one
// thread a lane running X1's body, then X2's on the same loaded lane (each
// row read once, but a thread's chain twice as long at the same warps an
// SM: 1.18x X1 then X2 at 65,536 lanes, slower than them at 262,144), and
// the two bodies in warps of one block (its early warps wait for its
// late ones).  No shared memory, no atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int SPECULAR = 1, GLOSSY = 2, DIFFUSE = 4, TRANSMISSIVE = 8;
constexpr int L_LAMBERT = 0, L_TS = 1, L_DIELECTRIC = 2, L_SPECULAR = 3;
// the Python constants as torch casts them to float32
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kInvPi = static_cast<float>(1.0 / 3.141592653589793);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

// The design's switches (see the steps above)
template <bool kRcp_, bool kConstRows_>
struct Design {
  static constexpr bool kRcp = kRcp_;
  static constexpr bool kConstRows = kConstRows_;
};
using FirstDesign = Design<false, false>;
// the redesign (kernel_variants' substitutions edit these lines)
constexpr bool kRcpOn = true;
constexpr bool kConstRowsOn = true;
using Redesign = Design<kRcpOn, kConstRowsOn>;

// ---------------------------------------------------------------------------
// Scalars: float, and Dual (value + 6 derivatives)
// ---------------------------------------------------------------------------

constexpr int kDirs = 6;
enum { D_ETA, D_ALPHA, D_WOX, D_WOY, D_WOZ, D_ETA_OUTER };

// v: the float32 value, by the float version's operations, which decides
// every branch; w: the same value in float64, at which the derivatives d
// are taken (so X3 is the float64 VJP of the plain version along the
// float32 forward's branches); d: the derivatives along the six directions
template <class D>
struct Dual {
  float v;
  double w;
  double d[kDirs];
  __device__ __forceinline__ Dual(float x = 0.0f) : v(x), w(x) {
#pragma unroll
    for (int k = 0; k < kDirs; ++k) d[k] = 0.0;
  }
  // x with derivative 1 along direction k
  __device__ __forceinline__ static Dual seed(float x, int k) {
    Dual r(x);
#pragma unroll
    for (int j = 0; j < kDirs; ++j) r.d[j] = j == k ? 1.0 : 0.0;
    return r;
  }
};

__device__ __forceinline__ float val(float x) { return x; }
template <class D>
__device__ __forceinline__ float val(const Dual<D>& x) {
  return x.v;
}

template <class D>
__device__ __forceinline__ Dual<D> operator+(const Dual<D>& a,
                                             const Dual<D>& b) {
  Dual<D> r(a.v + b.v);
  r.w = a.w + b.w;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <class D>
__device__ __forceinline__ Dual<D> operator-(const Dual<D>& a,
                                             const Dual<D>& b) {
  Dual<D> r(a.v - b.v);
  r.w = a.w - b.w;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <class D>
__device__ __forceinline__ Dual<D> operator-(const Dual<D>& a) {
  Dual<D> r(-a.v);
  r.w = -a.w;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = -a.d[k];
  return r;
}
template <class D>
__device__ __forceinline__ Dual<D> operator*(const Dual<D>& a,
                                             const Dual<D>& b) {
  Dual<D> r(a.v * b.v);
  r.w = a.w * b.w;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) {
    if constexpr (D::kRcp)
      r.d[k] = fma(a.d[k], b.w, a.w * b.d[k]);
    else
      r.d[k] = a.d[k] * b.w + a.w * b.d[k];
  }
  return r;
}
template <class D>
__device__ __forceinline__ Dual<D> operator/(const Dual<D>& a,
                                             const Dual<D>& b) {
  Dual<D> r(a.v / b.v);
  if constexpr (D::kRcp) {
    const double inv = __drcp_rn(b.w);
    r.w = a.w * inv;
#pragma unroll
    for (int k = 0; k < kDirs; ++k)
      r.d[k] = fma(-r.w, b.d[k], a.d[k]) * inv;
  } else {
    r.w = a.w / b.w;
#pragma unroll
    for (int k = 0; k < kDirs; ++k)
      r.d[k] = (a.d[k] - r.w * b.d[k]) / b.w;
  }
  return r;
}
template <class D>
__device__ __forceinline__ bool operator<(const Dual<D>& a,
                                          const Dual<D>& b) {
  return a.v < b.v;
}
template <class D>
__device__ __forceinline__ bool operator>(const Dual<D>& a,
                                          const Dual<D>& b) {
  return a.v > b.v;
}
template <class D>
__device__ __forceinline__ bool operator>=(const Dual<D>& a,
                                           const Dual<D>& b) {
  return a.v >= b.v;
}
template <class D>
__device__ __forceinline__ bool operator==(const Dual<D>& a,
                                           const Dual<D>& b) {
  return a.v == b.v;
}
template <class D>
__device__ __forceinline__ bool operator!=(const Dual<D>& a,
                                           const Dual<D>& b) {
  return a.v != b.v;
}

// torch.sqrt, .abs() (gradient sign(x), 0 at 0), clamp(min=) / clamp(max=)
// (NaN passes; the gradient on the closed side, as clamp's backward)
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
template <class D>
__device__ __forceinline__ Dual<D> sqrt_(const Dual<D>& x) {
  Dual<D> r(sqrtf(x.v));
  if (!(x.w > 0.0)) {  // positive in float32 only: no slope in float64
    r.w = 0.0;
    return r;
  }
  double h;
  if constexpr (D::kRcp) {
    const double rs = rsqrt(x.w);
    r.w = x.w * rs;
    h = 0.5 * rs;
  } else {
    r.w = sqrt(x.w);
    h = 0.5 / r.w;
  }
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = x.d[k] * h;
  return r;
}
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
template <class D>
__device__ __forceinline__ Dual<D> abs_(const Dual<D>& x) {
  Dual<D> r(fabsf(x.v));
  r.w = fabs(x.w);
  double s = x.w > 0.0 ? 1.0 : x.w < 0.0 ? -1.0 : 0.0;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = x.d[k] * s;
  return r;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
template <class D>
__device__ __forceinline__ Dual<D> clamp_min(const Dual<D>& x, float lo) {
  if (isnan(x.v)) return x;
  Dual<D> r = x.v >= lo ? x : Dual<D>(lo);
  r.v = fmaxf(x.v, lo);
  r.w = fmax(r.w, static_cast<double>(lo));  // the float64 twin too
  return r;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
template <class D>
__device__ __forceinline__ Dual<D> clamp_max(const Dual<D>& x, float hi) {
  if (isnan(x.v)) return x;
  Dual<D> r = x.v <= hi ? x : Dual<D>(hi);
  r.v = fminf(x.v, hi);
  r.w = fmin(r.w, static_cast<double>(hi));
  return r;
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// c ? a : b of two scalars that are lvalues.  For a Dual under step 2,
// member by member on values: a select of the two objects' addresses
// would keep whatever they live in (a lane's inputs) in local memory
template <class T>
constexpr bool kValueSelect = false;
template <class D>
constexpr bool kValueSelect<Dual<D>> = D::kConstRows;
__device__ __forceinline__ float pick(bool c, float a, float b) {
  return c ? a : b;
}
__device__ __forceinline__ double pick(bool c, double a, double b) {
  return c ? a : b;
}
template <class D>
__device__ __forceinline__ Dual<D> pick(bool c, const Dual<D>& a,
                                        const Dual<D>& b) {
  Dual<D> r(pick(c, a.v, b.v));
  r.w = pick(c, a.w, b.w);
#pragma unroll
  for (int k = 0; k < kDirs; ++k) r.d[k] = pick(c, a.d[k], b.d[k]);
  return r;
}

// ---------------------------------------------------------------------------
// Vectors and the plain version's helpers
// ---------------------------------------------------------------------------

template <class T>
struct V3 {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ V3<T> v3(T x, T y, T z) {
  return V3<T>{x, y, z};
}
template <class T>
__device__ __forceinline__ V3<T> lift(const V3<float>& a) {
  return V3<T>{T(a.x), T(a.y), T(a.z)};
}
template <class T>
__device__ __forceinline__ V3<T> operator+(const V3<T>& a, const V3<T>& b) {
  return V3<T>{a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator-(const V3<T>& a, const V3<T>& b) {
  return V3<T>{a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator-(const V3<T>& a) {
  return V3<T>{-a.x, -a.y, -a.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator*(const T& s, const V3<T>& a) {
  return V3<T>{s * a.x, s * a.y, s * a.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator*(const V3<T>& a, const T& s) {
  return V3<T>{a.x * s, a.y * s, a.z * s};
}
template <class T>
__device__ __forceinline__ V3<T> sel(bool c, const V3<T>& a,
                                     const V3<T>& b) {
  return c ? a : b;
}
template <class D>
__device__ __forceinline__ V3<Dual<D>> sel(bool c, const V3<Dual<D>>& a,
                                           const V3<Dual<D>>& b) {
  if constexpr (kValueSelect<Dual<D>>)
    return V3<Dual<D>>{pick(c, a.x, b.x), pick(c, a.y, b.y),
                       pick(c, a.z, b.z)};
  else
    return c ? a : b;
}

// torch's sum over a last dimension of 3 on the card: ((x0 + x2) + x1),
// begun from a zero
template <class T>
__device__ __forceinline__ T sum3(const T& x0, const T& x1, const T& x2) {
  return ((x0 + x2) + x1) + T(0.0f);
}
template <class T>
__device__ __forceinline__ T dot(const V3<T>& a, const V3<T>& b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// bxdf._normalize: the zero vector is divided by 1
template <class T>
__device__ __forceinline__ V3<T> normalize(const V3<T>& v) {
  T n2 = sum3(v.x * v.x, v.y * v.y, v.z * v.z);
  bool zero = n2 == T(0.0f);
  T d = zero ? T(1.0f) : sqrt_(n2);
  return V3<T>{v.x / d, v.y / d, v.z / d};
}
// torch.linalg.cross on the card: each component one fused rounding
__device__ __forceinline__ V3<float> cross(const V3<float>& a,
                                           const V3<float>& b) {
  return V3<float>{__fmaf_rn(a.y, b.z, -(a.z * b.y)),
                   __fmaf_rn(a.z, b.x, -(a.x * b.z)),
                   __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

template <class T>
__device__ __forceinline__ T safe_sqrt(const T& x) {
  return x > T(0.0f) ? sqrt_(x) : T(0.0f);
}
template <class T>
__device__ __forceinline__ T safe_div(const T& a, const T& b) {
  return b != T(0.0f) ? a / b : T(0.0f);
}
// bxdf.reflect: 2 * dot(w1, w2) * w2 - w1
__device__ __forceinline__ V3<float> reflect(const V3<float>& w1,
                                             const V3<float>& w2) {
  float t = 2.0f * dot(w1, w2);
  return t * w2 - w1;
}

// bxdf.fresnel (bxdf.cpp:3-22); eta_o == eta_i gives 0
template <class T>
__device__ __forceinline__ T fresnel(const T& eta_o, const T& eta_i,
                                     const T& cos_theta) {
  T cos_o = clamp_max(abs_(cos_theta), 1.0f);
  T sin_o = safe_sqrt(T(1.0f) - cos_o * cos_o);
  T sin_i = safe_div(eta_o, eta_i) * sin_o;
  bool tir = sin_i > T(1.0f);
  T sc = clamp_max(sin_i, 1.0f);
  T cos_i = safe_sqrt(T(1.0f) - sc * sc);
  bool denom_small = abs_(cos_o + cos_i) < T(1e-5f);
  T f_para = safe_div(eta_i * cos_o - eta_o * cos_i,
                      eta_i * cos_o + eta_o * cos_i);
  T f_perp = safe_div(eta_o * cos_o - eta_i * cos_i,
                      eta_o * cos_o + eta_i * cos_i);
  T fr = (f_para * f_para + f_perp * f_perp) * T(0.5f);
  fr = denom_small ? T(0.0f) : fr;
  fr = tir ? T(1.0f) : fr;
  return eta_o == eta_i ? T(0.0f) : fr;
}

// Smith Lambda, G, G1 and Trowbridge-Reitz D of bxdf.py
template <class T>
__device__ __forceinline__ T lambda_(const T& z, const T& alpha) {
  T sin_t = safe_sqrt(T(1.0f) - z * z);
  T tan_t = safe_div(sin_t, z);
  return (T(-1.0f) + sqrt_(T(1.0f) + alpha * alpha * tan_t * tan_t)) *
         T(0.5f);
}
template <class T>
__device__ __forceinline__ T g_(const T& wo_z, const T& wi_z, const T& alpha) {
  return T(1.0f) / (T(1.0f) + lambda_(wo_z, alpha) + lambda_(wi_z, alpha));
}
template <class T>
__device__ __forceinline__ T g1(const T& z, const T& alpha) {
  return T(1.0f) / (T(1.0f) + lambda_(z, alpha));
}
template <class T>
__device__ __forceinline__ T d_ggx(const T& z, const T& alpha) {
  T z2 = z * z;
  T sin2 = clamp_min(T(1.0f) - z2, 0.0f);
  T tan2 = safe_div(sin2, z2);
  T a2 = alpha * alpha;
  T q = T(1.0f) + tan2 / a2;
  T denom = (T(kPi) * a2 * (z2 * z2)) * (q * q);
  return z == T(0.0f) ? T(0.0f) : safe_div(T(1.0f), denom);
}

// ---------------------------------------------------------------------------
// A lobe's f: a table row times a scalar, or a constant
// ---------------------------------------------------------------------------

enum { F_ZERO = -1, F_RHO_D = 0, F_RHO_S = 1, F_TAU = 2, F_ONE = 3 };

template <class T>
struct LobeF {
  int tab;
  T s;
};
template <class T>
__device__ __forceinline__ LobeF<T> lf(int tab, T s) {
  return LobeF<T>{tab, s};
}
template <class T>
__device__ __forceinline__ LobeF<T> lf_zero() {
  return LobeF<T>{F_ZERO, T(0.0f)};
}

// one lane's descriptor and inputs (the rows of the BsdfDesc tensors)
template <class T>
struct Lane {
  float rho[3][3];  // rho_d, rho_s, tau
  T eta, alpha, eta_outer;
  V3<T> wo;
};

// the value of f's channel c (the row by constant indices where the
// design says so)
template <class D, class T>
__device__ __forceinline__ float f_value(const Lane<T>& L, const LobeF<T>& f,
                                         int c) {
  if (f.tab == F_ZERO) return 0.0f;
  if (f.tab == F_ONE) return 1.0f;
  if constexpr (D::kConstRows) {
    const float r = f.tab == F_RHO_D   ? L.rho[F_RHO_D][c]
                    : f.tab == F_RHO_S ? L.rho[F_RHO_S][c]
                                       : L.rho[F_TAU][c];
    return r * val(f.s);
  }
  return L.rho[f.tab][c] * val(f.s);
}

// ---------------------------------------------------------------------------
// Lobes (bxdf.py's lambert_*, ts_*, dielectric_*, specular_*, specdiel_*)
// ---------------------------------------------------------------------------

template <class T>
__device__ __forceinline__ LobeF<T> ts_f(const Lane<T>& L,
                                         const V3<T>& wi) {
  const V3<T>& wo = L.wo;
  V3<T> wh = normalize(wo + wi);
  T g = g_(wo.z, wi.z, L.alpha);
  T d = d_ggx(wh.z, L.alpha);
  T fr = fresnel(L.eta_outer, L.eta, dot(wh, wi));
  T denom = T(4.0f) * wo.z * wi.z;
  T s = safe_div(g * d * fr, denom);
  bool bad = wo.z < T(0.0f) || wi.z < T(0.0f) || denom == T(0.0f);
  return bad ? lf_zero<T>() : lf(F_RHO_S, s);
}

template <class T>
__device__ __forceinline__ float ts_pdf(const Lane<T>& L, const V3<T>& wi) {
  const V3<T>& wo = L.wo;
  V3<T> wh = normalize(wo + wi);
  T cos_h = clamp_max(dot(wo, wh), 1.0f);
  T pdf = safe_div(d_ggx(wh.z, L.alpha) * cos_h * g1(wo.z, L.alpha), wo.z);
  pdf = clamp_min(safe_div(pdf, T(4.0f) * cos_h), 0.0f);
  return val(wh.z < T(0.0f) ? T(0.0f) : pdf);
}

template <class T>
__device__ __forceinline__ void oriented_etas(const Lane<T>& L, T& eta_o,
                                              T& eta_i) {
  bool below = L.wo.z < T(0.0f);
  if constexpr (kValueSelect<T>) {
    eta_o = pick(below, L.eta, L.eta_outer);
    eta_i = pick(below, L.eta_outer, L.eta);
  } else {
    eta_o = below ? L.eta : L.eta_outer;
    eta_i = below ? L.eta_outer : L.eta;
  }
}

template <class T>
__device__ __forceinline__ LobeF<T> dielectric_f(const Lane<T>& L,
                                                 const V3<T>& wi) {
  const V3<T>& wo = L.wo;
  T eta_o, eta_i;
  oriented_etas(L, eta_o, eta_i);
  bool same_side = wo.z * wi.z >= T(0.0f);
  if (same_side) {
    V3<T> wh_r = normalize(wo + wi);
    wh_r = sel(wh_r.z < T(0.0f), -wh_r, wh_r);
    T fr_r = fresnel(eta_o, eta_i, abs_(dot(wh_r, wo)));
    T denom_r = T(4.0f) * wo.z * wi.z;
    T s = safe_div(g_(wo.z, wi.z, L.alpha) * d_ggx(wh_r.z, L.alpha) * fr_r,
                   denom_r);
    return lf(F_RHO_S, s);
  }
  V3<T> wh_t = normalize(eta_o * wo + eta_i * wi);
  wh_t = sel(wh_t.z < T(0.0f), -wh_t, wh_t);
  T fr_t = fresnel(eta_o, eta_i, abs_(dot(wh_t, wo)));
  if (fr_t >= T(1.0f)) return lf_zero<T>();
  T wi_dot_wh = dot(wi, wh_t);
  T wo_dot_wh = dot(wo, wh_t);
  T num = g_(wo.z, wi.z, L.alpha) * d_ggx(wh_t.z, L.alpha) *
          (T(1.0f) - fr_t) * abs_(wi_dot_wh) * abs_(wo_dot_wh) * eta_o *
          eta_o;
  T q = eta_i * wi_dot_wh + eta_o * wo_dot_wh;
  T den = q * q * abs_(wo.z * wi.z);
  return lf(F_TAU, safe_div(num, den));
}

__device__ __forceinline__ float dielectric_pdf(const Lane<float>& L,
                                                const V3<float>& wi) {
  const V3<float>& wo = L.wo;
  float eta_o, eta_i;
  oriented_etas(L, eta_o, eta_i);
  bool same_side = wo.z * wi.z >= 0.0f;
  float pdf;
  if (same_side) {
    V3<float> wh_r = normalize(wo + wi);
    wh_r = sel(wh_r.z < 0.0f, -wh_r, wh_r);
    float c = clamp_max(dot(wo, wh_r), 1.0f);
    float cos_h = fabsf(c);
    float pdf_r = safe_div(d_ggx(wh_r.z, L.alpha) * c * g1(wo.z, L.alpha),
                           wo.z);
    pdf = clamp_min(safe_div(pdf_r, 4.0f * cos_h), 0.0f);
  } else {
    V3<float> wh_t = normalize(eta_o * wo + eta_i * wi);
    wh_t = sel(wh_t.z < 0.0f, -wh_t, wh_t);
    float pdf_t = safe_div(d_ggx(wh_t.z, L.alpha) *
                               clamp_max(fabsf(dot(wo, wh_t)), 1.0f) *
                               g1(wo.z, L.alpha),
                           fabsf(wo.z));
    float wi_dot_wh = dot(wi, wh_t);
    float wo_dot_wh = dot(wo, wh_t);
    float den = eta_i * wi_dot_wh + eta_o * wo_dot_wh;
    float jdet = safe_div(fabsf(wi_dot_wh) * eta_i * eta_i, den * den);
    pdf = pdf_t * jdet;
  }
  return L.eta_outer == L.eta ? 0.0f : pdf;
}

// specular_sample's f at its wi = (-wo.x, -wo.y, wo.z), detached: wi_z is
// a constant of the derivative
template <class T>
__device__ __forceinline__ LobeF<T> specular_f(const Lane<T>& L, float wi_z) {
  T fr = fresnel(L.eta_outer, L.eta, T(wi_z));
  if (wi_z == 0.0f) return lf(F_ONE, T(0.0f));
  return lf(F_RHO_S, safe_div(fr, T(fabsf(wi_z))));
}

// specdiel_sample: the whole lobe (its f reads the undetached directions)
template <class T>
struct SpecDiel {
  LobeF<T> f;
  V3<float> wi;
  float pdf;
  int64_t flags;
};
template <class T>
__device__ __forceinline__ SpecDiel<T> specdiel(const Lane<T>& L, float u2x,
                                                int64_t prev_flags) {
  const V3<T>& wo = L.wo;
  bool matched = L.eta_outer == L.eta;
  T eta_o, eta_i;
  oriented_etas(L, eta_o, eta_i);
  T fr = fresnel(eta_o, eta_i, abs_(wo.z));
  bool choose_reflect = u2x < val(fr);
  V3<T> wi_refl = v3(-wo.x, -wo.y, wo.z);

  T cos_o = wo.z;
  T sin_o = safe_sqrt(T(1.0f) - cos_o * cos_o);
  T ratio = safe_div(eta_o, eta_i);
  T sin_i = ratio * sin_o;
  bool tir = sin_i >= T(1.0f);
  // the normal n = (0, 0, 1) as the plain version multiplies it
  V3<T> b = v3(T(0.0f) * cos_o, T(0.0f) * cos_o, T(1.0f) * cos_o);
  V3<T> a = wo - b;
  V3<T> c = (-a) * ratio;
  T sc = clamp_max(sin_i, 1.0f);
  T s = safe_sqrt(T(1.0f) - sc * sc);
  V3<T> dvec = v3(T(-0.0f) * s, T(-0.0f) * s, T(-1.0f) * s);
  dvec = sel(cos_o < T(0.0f), -dvec, dvec);
  V3<T> wi_refr = normalize(c + dvec);

  SpecDiel<T> r;
  if (matched) {
    r.f = lf(F_TAU, T(1.0f));
    r.wi = V3<float>{-val(wo.x), -val(wo.y), -val(wo.z)};
    r.pdf = 0.0f;
    r.flags = prev_flags | TRANSMISSIVE;
    return r;
  }
  bool refl_or_tir = choose_reflect || tir;
  const V3<T>& w = refl_or_tir ? wi_refl : wi_refr;
  r.wi = V3<float>{val(w.x), val(w.y), val(w.z)};
  if (choose_reflect) {
    r.f = wi_refl.z == T(0.0f)
              ? lf(F_ONE, T(0.0f))
              : lf(F_RHO_S, safe_div(fr, abs_(wi_refl.z)));
  } else if (tir) {
    r.f = lf(F_RHO_S, T(1.0f));
  } else {
    r.f = lf(F_TAU, safe_div(ratio * ratio * (T(1.0f) - fr),
                             abs_(wi_refr.z)));
  }
  r.pdf = choose_reflect ? val(fr) : 1.0f - val(fr);
  r.flags = refl_or_tir ? SPECULAR : (SPECULAR | TRANSMISSIVE);
  return r;
}

// _lobe_f and _lobe_pdf: a lobe of any code at (wo, wi); specular lobes
// give f = 0 and pdf = 0
template <class T>
__device__ __forceinline__ LobeF<T> lobe_f(const Lane<T>& L, int64_t code,
                                           const V3<T>& wi) {
  if (code == L_LAMBERT) return lf(F_RHO_D, T(kInvPi));
  if (code == L_TS) return ts_f(L, wi);
  if (code == L_DIELECTRIC) return dielectric_f(L, wi);
  return lf_zero<T>();
}
__device__ __forceinline__ float lobe_pdf(const Lane<float>& L, int64_t code,
                                          const V3<float>& wi) {
  if (code == L_LAMBERT) return wi.z * kInvPi;  // un-clamped (parity)
  if (code == L_TS) return ts_pdf(L, wi);
  if (code == L_DIELECTRIC) return dielectric_pdf(L, wi);
  return 0.0f;
}

// sampling.uniform_sample_disk
__device__ __forceinline__ void disk(float ux, float uy, float& dx,
                                     float& dy) {
  float r = sqrtf(ux);
  float theta = uy * kTwoPi;
  dx = r * cosf(theta);
  dy = r * sinf(theta);
}

// bxdf._vndf_sample (values only: its result is detached)
__device__ __forceinline__ V3<float> vndf_sample(const V3<float>& wo,
                                                 float alpha, float ux,
                                                 float uy, bool flip_lower) {
  V3<float> wo_h = normalize(v3(wo.x * alpha, wo.y * alpha, wo.z));
  if (flip_lower) wo_h = sel(wo.z < 0.0f, -wo_h, wo_h);
  V3<float> t1 = v3(wo_h.y, -wo_h.x, 0.0f);
  bool vertical = wo.x == 0.0f && wo.y == 0.0f;
  t1 = normalize(sel(vertical, v3(1.0f, 0.0f, 0.0f), t1));
  V3<float> t2 = normalize(cross(t1, wo_h));
  float dx, dy;
  disk(ux, uy, dx, dy);
  float s = (1.0f + wo_h.z) * 0.5f;
  dy = s * dy + (1.0f - s) * sqrtf(clamp_min(1.0f - dx * dx, 0.0f));
  float hx = sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f));
  V3<float> wh = hx * wo_h + dx * t1 + dy * t2;
  return normalize(v3(wh.x * alpha, wh.y * alpha, wh.z));
}

// bxdf._micro_flags
__device__ __forceinline__ int64_t micro_flags(float alpha, float spec_below) {
  int64_t flags = alpha >= 1.0f ? DIFFUSE : GLOSSY;
  return alpha > spec_below ? flags : SPECULAR;
}

// _refract: refraction about the microfacet wh
__device__ __forceinline__ V3<float> refract(const V3<float>& w,
                                             const V3<float>& wh,
                                             float eta_ratio, float cos_o,
                                             float sin_i) {
  V3<float> b = wh * cos_o;
  V3<float> a = w - b;
  V3<float> c = (-a) * eta_ratio;
  V3<float> d = (-wh) * safe_sqrt(1.0f - sin_i * sin_i);
  d = sel(dot(w, wh) < 0.0f, -d, d);
  return normalize(c + d);
}

// one lane's sampled lobe (_lobe_sample)
struct Sample {
  LobeF<float> f;
  V3<float> wi;
  float pdf;
  int64_t flags;
  float alpha_i;
};

__device__ __forceinline__ Sample lobe_sample(const Lane<float>& L,
                                              int64_t code, float u1,
                                              float ux, float uy,
                                              int64_t prev_flags) {
  const V3<float>& wo = L.wo;
  Sample r;
  if (code == L_LAMBERT) {
    float dx, dy;
    disk(ux, uy, dx, dy);
    float z = sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f));
    r.wi = v3(dx, dy, z);
    r.pdf = z * kInvPi;
    r.f = lf(F_RHO_D, kInvPi);
    r.flags = DIFFUSE;
    r.alpha_i = 1.0f;
  } else if (code == L_TS) {
    V3<float> wh = vndf_sample(wo, L.alpha, ux, uy, false);
    r.wi = normalize(reflect(wo, wh));
    r.pdf = ts_pdf(L, r.wi);
    r.f = ts_f(L, r.wi);
    r.flags = micro_flags(L.alpha, 0.001f);
    r.alpha_i = L.alpha;
  } else if (code == L_DIELECTRIC) {
    float eta_o, eta_i;
    oriented_etas(L, eta_o, eta_i);
    V3<float> wh = vndf_sample(wo, L.alpha, ux, uy, true);
    float fr = fresnel(eta_o, eta_i, fabsf(dot(wh, wo)));
    float cos_o = clamp(dot(wo, wh), -1.0f, 1.0f);
    float sin_o = safe_sqrt(1.0f - cos_o * cos_o);
    float ratio = safe_div(eta_o, eta_i);
    float sin_i = ratio * sin_o;
    bool tir = sin_i >= 1.0f;
    bool reflect_choice = u1 < fr;
    bool do_reflect = reflect_choice || tir;
    V3<float> wi = do_reflect
                       ? normalize(reflect(wo, wh))
                       : refract(wo, wh, ratio, cos_o, clamp_max(sin_i, 1.0f));
    float pdf_scale = reflect_choice ? fr : 1.0f - fr;
    int64_t flags = micro_flags(L.alpha, 0.0001f);
    if (L.eta_outer == L.eta) {  // index-matched pass-through
      r.wi = -wo;
      r.pdf = 0.0f;
      r.f = lf(F_TAU, 1.0f);
      r.flags = prev_flags | TRANSMISSIVE;
    } else {
      r.wi = wi;
      r.pdf = dielectric_pdf(L, wi) * pdf_scale;
      r.f = dielectric_f(L, wi);
      r.flags = do_reflect ? flags : (flags | TRANSMISSIVE);
    }
    r.alpha_i = L.alpha;
  } else if (code == L_SPECULAR) {
    r.wi = v3(-wo.x, -wo.y, wo.z);
    r.pdf = 1.0f;
    r.f = specular_f(L, wo.z);
    r.flags = SPECULAR;
    r.alpha_i = 0.0f;
  } else {  // L_SPECDIEL, and any other code (the plain select's default)
    SpecDiel<float> s = specdiel(L, ux, prev_flags);
    r.f = s.f;
    r.wi = s.wi;
    r.pdf = s.pdf;
    r.flags = s.flags;
    r.alpha_i = 0.0f;
  }
  return r;
}

// X3's f of the sampled lobe at X1's wi (the sampling's decisions follow
// from the same values)
template <class T>
__device__ __forceinline__ LobeF<T> sampled_f(const Lane<T>& L, int64_t code,
                                              const V3<float>& wi, float ux,
                                              int64_t prev_flags) {
  if (code == L_LAMBERT) return lf(F_RHO_D, T(kInvPi));
  if (code == L_TS) return ts_f(L, lift<T>(wi));
  if (code == L_DIELECTRIC) {
    if (L.eta_outer == L.eta) return lf(F_TAU, T(1.0f));
    return dielectric_f(L, lift<T>(wi));
  }
  if (code == L_SPECULAR) return specular_f(L, wi.z);
  return specdiel(L, ux, prev_flags).f;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// X1's lobe bits: picked code + 1 (bits 0-2), the other code + 1 (3-5),
// the other lobe added (6)
__device__ __forceinline__ int32_t pack_bits(int64_t code, int64_t other,
                                             bool add) {
  return static_cast<int32_t>(((code + 1) & 7) | (((other + 1) & 7) << 3) |
                              (add ? 64 : 0));
}

struct Args {
  // inputs
  const int64_t* n_lobes;
  const int64_t* lobe;  // (N, 2)
  const float* rho_d;   // (N, 3)
  const float* rho_s;
  const float* tau;
  const float* eta;
  const float* alpha0;
  const float* alpha_prime;
  const float* wo;  // (N, 3)
  const float* wi;  // (N, 3): X2's input; X3's: X1's output or X2's input
  const float* u1;
  const float* u2;  // (N, 2)
  const uint8_t* use_prime;
  const float* eta_outer;
  const int64_t* prev_flags;
  const int32_t* bits;  // X3 mode 0: X1's lobe bits
  const float* g_f;     // X3: cotangents (null: zero)
  const float* g_alpha_i;
  const float* g_eta_sampled;
  const float* wi_b;  // (N, 3): the sample+eval launch's eval direction
  // outputs
  float* f;  // (N, 3)
  float* wi_out;
  float* pdf;
  int64_t* flags;
  float* alpha_i;
  float* eta_sampled;
  int32_t* bits_out;
  float* f_b;  // (N, 3): the sample+eval launch's eval outputs
  float* pdf_b;
  float* g_rho[3];  // X3: (N, 3) each
  float* g_eta;
  float* g_alpha0;
  float* g_alpha_prime;
  float* g_wo;  // (N, 3)
  float* g_eta_outer;
  int64_t n;
};

template <class T>
__device__ __forceinline__ Lane<T> load_lane(const Args& a, int64_t i) {
  Lane<T> L;
  const float* tabs[3] = {a.rho_d, a.rho_s, a.tau};
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < 3; ++c) L.rho[t][c] = tabs[t][3 * i + c];
  float alpha = a.use_prime[i] ? a.alpha_prime[i] : a.alpha0[i];
  L.eta = T(a.eta[i]);
  L.alpha = T(alpha);
  L.eta_outer = T(a.eta_outer[i]);
  L.wo = V3<T>{T(a.wo[3 * i]), T(a.wo[3 * i + 1]), T(a.wo[3 * i + 2])};
  return L;
}

// a lane's lobe count and its two lobe codes
struct Lobes {
  int64_t n, l0, l1;
};
__device__ __forceinline__ Lobes load_lobes(const Args& a, int64_t i) {
  return Lobes{a.n_lobes[i], a.lobe[2 * i], a.lobe[2 * i + 1]};
}

// BSDF::Sample_f's lobe pick: the lane's u1 * n_lobes chooses lobe 0 or 1
__device__ __forceinline__ void pick_lobes(const Lobes& lb, float u1,
                                           int64_t& code, int64_t& other) {
  float n_f = static_cast<float>(lb.n);
  int64_t idx = static_cast<int64_t>(u1 * n_f);
  idx = idx < 0 ? 0 : idx > 1 ? 1 : idx;
  code = idx == 0 ? lb.l0 : lb.l1;
  other = idx == 1 ? lb.l0 : lb.l1;
}

// X1's body on a loaded lane: BSDF::Sample_f at (u1, u2, prev_flags), its
// seven outputs written
template <class D>
__device__ __forceinline__ void sample_lane(const Args& a, int64_t i,
                                            const Lane<float>& L,
                                            const Lobes& lb, float u1,
                                            float u2x, float u2y,
                                            int64_t prev_flags) {
  float n_f = static_cast<float>(lb.n);
  float u1r = u1 * n_f - floorf(u1 * n_f);  // glm::fract
  int64_t code, other;
  pick_lobes(lb, u1, code, other);

  Sample s = lobe_sample(L, code, u1r, u2x, u2y, prev_flags);
  // mix in the other lobe when the sampled flags are not SPECULAR
  bool non_spec = (s.flags & SPECULAR) == 0;
  bool mix = non_spec && lb.n >= 2 && other != L_SPECULAR && other != 4;
  float p_other = mix ? lobe_pdf(L, other, s.wi) : 0.0f;
  bool add = mix && p_other > 0.0f;
  LobeF<float> fo = add ? lobe_f(L, other, s.wi) : lf_zero<float>();
  float pdf = s.pdf + (add ? p_other : 0.0f);
  pdf = non_spec ? pdf / n_f : pdf;  // parity: only off the specular path
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.f[3 * i + c] =
        f_value<D>(L, s.f, c) + (add ? f_value<D>(L, fo, c) : 0.0f);
  }
  a.wi_out[3 * i] = s.wi.x;
  a.wi_out[3 * i + 1] = s.wi.y;
  a.wi_out[3 * i + 2] = s.wi.z;
  a.pdf[i] = pdf;
  a.flags[i] = s.flags;
  a.alpha_i[i] = s.alpha_i;
  a.eta_sampled[i] = code == L_LAMBERT ? 0.0f : L.eta;
  a.bits_out[i] = pack_bits(code, other, add);
}

// X2's body on a loaded lane: bsdf_f and bsdf_pdf at wi, written to f (3
// values) and pdf
template <class D>
__device__ __forceinline__ void eval_lane(const Lane<float>& L,
                                          const Lobes& lb,
                                          const V3<float>& wi, float* f,
                                          float* pdf) {
  bool two = lb.n >= 2;
  LobeF<float> f0 = lobe_f(L, lb.l0, wi);
  LobeF<float> f1 = two ? lobe_f(L, lb.l1, wi) : lf_zero<float>();
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f[c] = f_value<D>(L, f0, c) + (two ? f_value<D>(L, f1, c) : 0.0f);
  float p = lobe_pdf(L, lb.l0, wi);
  p = p + (two ? lobe_pdf(L, lb.l1, wi) : 0.0f);
  *pdf = p / static_cast<float>(lb.n);
}

template <class D>
__global__ void __launch_bounds__(kThreads)
    bsdf_sample_kernel(const Args a) {
  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= a.n) return;
  Lane<float> L = load_lane<float>(a, i);
  sample_lane<D>(a, i, L, load_lobes(a, i), a.u1[i], a.u2[2 * i],
                 a.u2[2 * i + 1], a.prev_flags[i]);
}

template <class D>
__global__ void __launch_bounds__(kThreads) bsdf_eval_kernel(const Args a) {
  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= a.n) return;
  Lane<float> L = load_lane<float>(a, i);
  V3<float> wi{a.wi[3 * i], a.wi[3 * i + 1], a.wi[3 * i + 2]};
  eval_lane<D>(L, load_lobes(a, i), wi, a.f + 3 * i, a.pdf + i);
}

// X2's redesign: one launch of twice X1's blocks.  The first half of the
// blocks runs X1's body on lanes 0..n-1, the second half X2's body at wi_b
// on the same lanes (a block runs one body, so the two never diverge in a
// warp).  A thread loads its lane's inputs before its first store.
template <class D>
__global__ void __launch_bounds__(kThreads)
    bsdf_sample_eval_kernel(const Args a) {
  const int64_t half = (a.n + kThreads - 1) / kThreads * kThreads;
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const bool eval = t >= half;  // the same in a block
  const int64_t i = eval ? t - half : t;
  if (i >= a.n) return;
  const Lane<float> L = load_lane<float>(a, i);
  const Lobes lb = load_lobes(a, i);
  if (eval) {
    const V3<float> wi_b{a.wi_b[3 * i], a.wi_b[3 * i + 1], a.wi_b[3 * i + 2]};
    eval_lane<D>(L, lb, wi_b, a.f_b + 3 * i, a.pdf_b + i);
  } else {
    sample_lane<D>(a, i, L, lb, a.u1[i], a.u2[2 * i], a.u2[2 * i + 1],
                   a.prev_flags[i]);
  }
}

// The rows' gradients: the first design adds g[c] * s to g_rho[table][c]
// term by term (RowArray); under step 2 a term adds its s to its table's
// sum (RowSums: named scalars, no array), times g[c] at the end (from a
// zero, as the first design's sum begins)
struct RowArray {
  double g_rho[3][3] = {};
  __device__ __forceinline__ double get(int t, int c, const float (&)[3]) {
    return g_rho[t][c];
  }
};
struct RowSums {
  double w_d = 0.0, w_s = 0.0, w_t = 0.0;
  __device__ __forceinline__ void add(int tab, double s) {
    w_d += tab == F_RHO_D ? s : 0.0;
    w_s += tab == F_RHO_S ? s : 0.0;
    w_t += tab == F_TAU ? s : 0.0;
  }
  __device__ __forceinline__ double get(int t, int c, const float (&g)[3]) {
    return 0.0 + g[c] * (t == F_RHO_D ? w_d : t == F_RHO_S ? w_s : w_t);
  }
};
template <class D>
using RowGrads = std::conditional_t<D::kConstRows, RowSums, RowArray>;

// one term's contribution to the gradients: g . (row * s)
template <class D>
__device__ __forceinline__ void add_term(const Lane<Dual<D>>& L,
                                         const LobeF<Dual<D>>& f,
                                         const float (&g)[3],
                                         RowGrads<D>& rg,
                                         double (&g_s)[kDirs]) {
  if (f.tab < F_RHO_D || f.tab > F_TAU) return;  // zero or a constant
  double gs = 0.0;
  if constexpr (D::kConstRows) {
    rg.add(f.tab, f.s.w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r0 = L.rho[F_RHO_D][c], r1 = L.rho[F_RHO_S][c],
                  r2 = L.rho[F_TAU][c];
      const float r = f.tab == F_RHO_D ? r0 : f.tab == F_RHO_S ? r1 : r2;
      gs += static_cast<double>(g[c]) * r;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rg.g_rho[f.tab][c] += g[c] * f.s.w;
      gs += static_cast<double>(g[c]) * L.rho[f.tab][c];
    }
  }
#pragma unroll
  for (int k = 0; k < kDirs; ++k) {
    if constexpr (D::kRcp)
      g_s[k] = fma(gs, f.s.d[k], g_s[k]);
    else
      g_s[k] += gs * f.s.d[k];
  }
}

// the lane's inputs as duals, each seeded along its own direction
template <class D>
__device__ __forceinline__ Lane<Dual<D>> dual_lane(const Lane<float>& Lf) {
  Lane<Dual<D>> L;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < 3; ++c) L.rho[t][c] = Lf.rho[t][c];
  L.eta = Dual<D>::seed(Lf.eta, D_ETA);
  L.alpha = Dual<D>::seed(Lf.alpha, D_ALPHA);
  L.eta_outer = Dual<D>::seed(Lf.eta_outer, D_ETA_OUTER);
  L.wo = V3<Dual<D>>{Dual<D>::seed(Lf.wo.x, D_WOX),
                     Dual<D>::seed(Lf.wo.y, D_WOY),
                     Dual<D>::seed(Lf.wo.z, D_WOZ)};
  return L;
}

// a lane's terms (kMode 0: X1's sampled lobe and the other it mixed in,
// from X1's bits; 1: X2's lobes) added to rg and g_s; returns X1's lobe
template <class D, int kMode>
__device__ __forceinline__ int64_t add_terms(const Args& a, int64_t i,
                                             const Lane<Dual<D>>& L,
                                             const V3<float>& wi,
                                             const float (&g)[3],
                                             RowGrads<D>& rg,
                                             double (&g_s)[kDirs]) {
  if (kMode == 0) {
    int32_t bits = a.bits[i];
    int64_t code = (bits & 7) - 1;
    int64_t other = ((bits >> 3) & 7) - 1;
    add_term(L, sampled_f(L, code, wi, a.u2[2 * i], a.prev_flags[i]), g, rg,
             g_s);
    if (bits & 64) add_term(L, lobe_f(L, other, lift<Dual<D>>(wi)), g, rg, g_s);
    return code;
  }
  V3<Dual<D>> wi_d = lift<Dual<D>>(wi);
  add_term(L, lobe_f(L, a.lobe[2 * i], wi_d), g, rg, g_s);
  if (a.n_lobes[i] >= 2)
    add_term(L, lobe_f(L, a.lobe[2 * i + 1], wi_d), g, rg, g_s);
  return 0;
}

template <class D, int kMode>  // kMode 0: X1's outputs, 1: X2's
__global__ void __launch_bounds__(kThreads) bsdf_f_bwd_kernel(const Args a) {
  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= a.n) return;
  const Lane<float> Lf = load_lane<float>(a, i);
  V3<float> wi{a.wi[3 * i], a.wi[3 * i + 1], a.wi[3 * i + 2]};
  float g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) g[c] = a.g_f ? a.g_f[3 * i + c] : 0.0f;
  RowGrads<D> rg;
  double g_dir[kDirs] = {};
  int64_t code = add_terms<D, kMode>(a, i, dual_lane<D>(Lf), wi, g, rg, g_dir);
  if (kMode == 0) {
    // alpha_i = alpha on the microfacet lobes; eta_sampled = eta but on
    // Lambert
    if (a.g_alpha_i && (code == L_TS || code == L_DIELECTRIC))
      g_dir[D_ALPHA] += a.g_alpha_i[i];
    if (a.g_eta_sampled && code != L_LAMBERT)
      g_dir[D_ETA] += a.g_eta_sampled[i];
  }
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.g_rho[t][3 * i + c] = static_cast<float>(rg.get(t, c, g));
  a.g_eta[i] = static_cast<float>(g_dir[D_ETA]);
  float g_alpha = static_cast<float>(g_dir[D_ALPHA]);
  bool prime = a.use_prime[i];
  a.g_alpha_prime[i] = prime ? g_alpha : 0.0f;
  a.g_alpha0[i] = prime ? 0.0f : g_alpha;
  a.g_wo[3 * i] = static_cast<float>(g_dir[D_WOX]);
  a.g_wo[3 * i + 1] = static_cast<float>(g_dir[D_WOY]);
  a.g_wo[3 * i + 2] = static_cast<float>(g_dir[D_WOZ]);
  a.g_eta_outer[i] = static_cast<float>(g_dir[D_ETA_OUTER]);
}

// in[] order of every entry: n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
// alpha_prime, wo, wi, u1, u2, use_prime, eta_outer, prev_flags, bits, g_f,
// g_alpha_i, g_eta_sampled, wi_b (an entry's unused inputs may be null)
Args args_in(const void* const* in, int64_t n) {
  Args a = {};
  a.n_lobes = static_cast<const int64_t*>(in[0]);
  a.lobe = static_cast<const int64_t*>(in[1]);
  a.rho_d = static_cast<const float*>(in[2]);
  a.rho_s = static_cast<const float*>(in[3]);
  a.tau = static_cast<const float*>(in[4]);
  a.eta = static_cast<const float*>(in[5]);
  a.alpha0 = static_cast<const float*>(in[6]);
  a.alpha_prime = static_cast<const float*>(in[7]);
  a.wo = static_cast<const float*>(in[8]);
  a.wi = static_cast<const float*>(in[9]);
  a.u1 = static_cast<const float*>(in[10]);
  a.u2 = static_cast<const float*>(in[11]);
  a.use_prime = static_cast<const uint8_t*>(in[12]);
  a.eta_outer = static_cast<const float*>(in[13]);
  a.prev_flags = static_cast<const int64_t*>(in[14]);
  a.bits = static_cast<const int32_t*>(in[15]);
  a.g_f = static_cast<const float*>(in[16]);
  a.g_alpha_i = static_cast<const float*>(in[17]);
  a.g_eta_sampled = static_cast<const float*>(in[18]);
  a.wi_b = static_cast<const float*>(in[19]);
  a.n = n;
  return a;
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// X1's seven outputs, out[0..6]
Args sample_args(const void* const* in, void* const* out, int64_t n) {
  Args a = args_in(in, n);
  a.f = static_cast<float*>(out[0]);
  a.wi_out = static_cast<float*>(out[1]);
  a.pdf = static_cast<float*>(out[2]);
  a.flags = static_cast<int64_t*>(out[3]);
  a.alpha_i = static_cast<float*>(out[4]);
  a.eta_sampled = static_cast<float*>(out[5]);
  a.bits_out = static_cast<int32_t*>(out[6]);
  return a;
}

template <class D>
int launch_sample(const void* const* in, void* const* out, int64_t n,
                  void* stream) {
  bsdf_sample_kernel<D><<<blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sample_args(in, out, n));
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch_f_bwd(const void* const* in, void* const* out, int64_t n,
                 int mode, void* stream) {
  Args a = args_in(in, n);
  for (int t = 0; t < 3; ++t) a.g_rho[t] = static_cast<float*>(out[t]);
  a.g_eta = static_cast<float*>(out[3]);
  a.g_alpha0 = static_cast<float*>(out[4]);
  a.g_alpha_prime = static_cast<float*>(out[5]);
  a.g_wo = static_cast<float*>(out[6]);
  a.g_eta_outer = static_cast<float*>(out[7]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    bsdf_f_bwd_kernel<D, 0><<<blocks(n), kThreads, 0, s>>>(a);
  else
    bsdf_f_bwd_kernel<D, 1><<<blocks(n), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X1. out: f, wi, pdf, flags (int64), alpha_i, eta_sampled, bits (int32)
int nart_bsdf_sample(const void* const* in, void* const* out, int64_t n,
                     void* stream) {
  return launch_sample<Redesign>(in, out, n, stream);
}

// X1's first design (the reference), on the same arguments
int nart_bsdf_sample_ref(const void* const* in, void* const* out, int64_t n,
                         void* stream) {
  return launch_sample<FirstDesign>(in, out, n, stream);
}

// X2's first design, the kernel of eval_f_pdf (no path launches it).
// out: f, pdf
int nart_bsdf_eval(const void* const* in, void* const* out, int64_t n,
                   void* stream) {
  Args a = args_in(in, n);
  a.f = static_cast<float*>(out[0]);
  a.pdf = static_cast<float*>(out[1]);
  bsdf_eval_kernel<Redesign><<<blocks(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// X2's redesign: X1 and X2 (at wi_b) in one launch.  out: X1's seven
// (f, wi, pdf, flags, alpha_i, eta_sampled, bits), then X2's f_b, pdf_b
int nart_bsdf_sample_eval(const void* const* in, void* const* out, int64_t n,
                          void* stream) {
  Args a = sample_args(in, out, n);
  a.f_b = static_cast<float*>(out[7]);
  a.pdf_b = static_cast<float*>(out[8]);
  bsdf_sample_eval_kernel<Redesign><<<2 * blocks(n), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// X3, mode 0 (X1's f, alpha_i, eta_sampled; wi is X1's, bits X1's) or 1
// (X2's f).  out: g_rho_d, g_rho_s, g_tau, g_eta, g_alpha0, g_alpha_prime,
// g_wo, g_eta_outer
int nart_bsdf_f_bwd(const void* const* in, void* const* out, int64_t n,
                    int mode, void* stream) {
  return launch_f_bwd<Redesign>(in, out, n, mode, stream);
}

// X3's first design (the reference), on the same arguments
int nart_bsdf_f_bwd_ref(const void* const* in, void* const* out, int64_t n,
                        int mode, void* stream) {
  return launch_f_bwd<FirstDesign>(in, out, n, mode, stream);
}

}  // extern "C"
