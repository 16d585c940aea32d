"""Development tool: what each design choice of csrc/cluster_hit.cu (K1,
K2), csrc/bvh_walk.cu (B1), csrc/bsdf.cu (X1-X3) or csrc/vol_step.cu
(V1, V2) buys.

    python -m nart_tpu_torch.kernel_variants [--rounds 3] [--reps 20]
    python -m nart_tpu_torch.kernel_variants --kernel bvh [--rounds 3]
    python -m nart_tpu_torch.kernel_variants --kernel bsdf [--rounds 3]
    python -m nart_tpu_torch.kernel_variants --kernel vol [--rounds 3]

Builds the kernel source as it is and variants of it made by exact text
substitution (``VARIANTS``; a substitution whose anchor is not found exactly
once raises, so an edit of the source that outdates a variant shows at
once, and tests/test_torch_kernel_variants.py checks it without a card):

  * ``loads twice`` / ``tests twice``: each cluster tile is loaded, or each
    ray's triangle tests are run, a second time with the same results.  The
    time a variant adds is what one pass of loads, or of tests, costs inside
    the kernel.  (Compiling a pass out instead would find no hits and so
    lengthen the walk.)
  * ``no register cap``: ``__launch_bounds__`` without its blocks-per-SM
    argument, so the compiler takes the registers it wants and fewer warps
    fit an SM;
  * ``plane first``: the triangle test solves the plane equation, with its
    IEEE division, before the edge functions instead of after them.

It prints ptxas' registers and spill bytes for every instantiation of every
variant, then, ``--rounds`` times over, one row per variant: CUDA-event
medians (ms) of the closest-hit and any-hit kernels on 65,536 camera rays
and 131,072 rays from hit points of the macbeth scene and on 65,536 rays
through a 40,000-triangle soup, and whether every output equals the
as-built kernel's.  The package's wrappers are left as they are: the tool
hands them a variant's library in place of the one cuda_build would load.

``--kernel bvh`` does the same for B1 (``BVH_VARIANTS``): one loop that
takes one node a step, a leaf or an inner node (in place of the
while-while walk's inner loop, then the leaf); the while-while walk in two
other shapes (the leaf tested as the node the inner loop broke at, the
loop returning when the stack runs out; the leaf held in a variable of its
own, the inner loop breaking at it, the walk ending where that loop finds
the stack empty); the while-while walk with a postponed leaf (a lane that
meets a leaf puts it off and walks on until it meets a second or every
lane of its warp holds one, each leaf's t_enter checked against t_best
again before its tests, which keeps the bits); the stack's depth in local
memory, in the stack's struct (in place of a register); all 24 loads of a
leaf of 8 in flight on the closest-hit walk too; a leaf of 8 tested plane
first (the planes of all 8 from two of each record's three loads, then the
edge functions of those whose t passed, in index order); the loop for
every leaf size on the any-hit walk too; the stack in shared memory
([slot][thread], depth + 1 entries); blocks of 64 threads in place of
128.  Its rows time the closest-hit and any-hit entries on the three ray
sets (bvh trees of the same triangles) on the device (calls captured into
one CUDA graph, replay ms over calls), beside the reference kernel
(nart_bvh_hit_ref, the walk's first design) in every round, and check
every output against the reference's bits.

``--kernel bsdf`` does the same for X1 and X3 (``BSDF_VARIANTS``): the
source's design switches (``kRcpOn``, ``kConstRowsOn``: csrc/bsdf.cu's
steps 1 and 2) and two steps that were measured and not taken (3, lanes
regrouped by lobe in a block; 4, X3's directions in two passes or its
blocks an SM), each by text substitution: every step off (the first
design), each step alone, steps 1-2 (as built) with each form of step 4,
steps 1-3, and steps 1-4 together; and the sample+eval launch in the
shapes measured and not taken (``SE_VARIANTS``: one thread a lane running
X1's body then X2's on the same loaded lane, that with the bodies the
other way round or capped at nine blocks an SM, and the two bodies in
the warps of one block).  Its rows time X1, X2's first design
(nart_bsdf_eval), X3 (both modes) and the sample+eval launch (X2's
redesign, nart_bsdf_sample_eval: "SE") on two lane sets, phase 27's
macbeth mid-trace round (``testing.mid_trace_bsdf``, 1280x720 @ 1:
strategy A's sample and strategy B's eval), 65,536 lanes of one kind
(``testing.bsdf_lane_set``, "glossy": one lobe, so regrouping has nothing
to regroup) and macbeth's round four times over (262,144 lanes), on the
device (calls captured into one CUDA graph) beside the
reference entries (nart_bsdf_sample_ref, nart_bsdf_f_bwd_ref; for "SE", X1
then X2 as built, the two launches it replaces: the "X1 + X2" against
"sample+eval" reading, in turns round by round) in every round; X1's, X2's
and SE's outputs must be the reference's bits, X3's within rtol 1e-5 /
atol 1e-6 of the reference's (their share of equal bits printed).

``--kernel vol`` does the same for V1 and V2 (``VOL_VARIANTS``): the
redesign's switches (csrc/vol_step.cu's ``VOL_AS_BUILT``: the select for
x / x, the slab clip under a branch, the 32-bit cell index, the row as
two 16-byte loads read once, the later draws off the chain, the small
sine and cosine, V2's rows as 16-byte stores), every one off ("steps
off": the first design's lane arithmetic, with the redesign's one-node
interface), each one off alone, a step measured and not taken ("stage":
a block's (N, 3) rows staged through shared memory with 16-byte loads
and stores), and blocks of 32 and 64 threads.  Its rows time V1 (with
an accumulator, as the machines call it) and V2 at k = 4 on volume_blob
1280x720 @ 4's static-machine states at round 60 and on
testing.vol_lane_set's edge set (32,768 lanes each), on the device, beside
the reference entries (nart_vol_steps_ref, nart_vol_steps_bwd_ref: the
first designs, V1 with its zero-filled count) and the node floor (an empty
kernel of V1's grid; a one-element fill) in every round; every output
must be the reference's bits.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from . import (bsdf_ops, bvh, camera, cluster_accel as ca, cuda_build,
               testing, vol_ops)
from .kernel_stats import DEFAULT_SCENE
from .scene import load_scene

SOURCE = os.path.join(cuda_build.SRC_DIR, "cluster_hit.cu")
BVH_SOURCE = os.path.join(cuda_build.SRC_DIR, "bvh_walk.cu")
BSDF_SOURCE = os.path.join(cuda_build.SRC_DIR, "bsdf.cu")
VOL_SOURCE = os.path.join(cuda_build.SRC_DIR, "vol_step.cu")
VOL_SCENE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
    "golden", "volume_blob.json")

# a zero that the compiler cannot know, for the repeated passes
_ZERO = [
    ("struct Accel {",
     "__device__ volatile int g_zero;\n\nstruct Accel {"),
    ("  const int stride = a.n_cl * a.csize;\n",
     "  const int stride = a.n_cl * a.csize;\n  const int zero = g_zero;\n"),
]
_LOAD = "              p[k][q] = r < a.csize ? src[q * stride] : 0.0f;\n"
_REDUCE = """            if constexpr (kAny) {
              if (__any_sync(kFull, hit) && lane == owner) {
"""
_PLANE = """  float d_dot_n = d[0] * p[9] + d[1] * p[10] + d[2] * p[11];
  float o_dot_n = o[0] * p[9] + o[1] * p[10] + o[2] * p[11];
  t = (p[12] - o_dot_n) / d_dot_n;
  if (!(t > t_min && t < t_hi)) return false;
"""
_EDGES = "  float px[3], py[3];\n#pragma unroll\n  for (int k = 0; k < 3; ++k) {\n    float ca ="

VARIANTS = {
    "as built": [],
    "loads twice": _ZERO + [(_LOAD, _LOAD + """              {
                const float again =
                    r < a.csize ? src[q * stride + zero] : 0.0f;
                p[k][q] = again == p[k][q] ? p[k][q] : again;
              }
""")],
    "tests twice": _ZERO + [(_REDUCE, """            {
              float t2 = 0.0f, f0 = 0.0f, f1 = 0.0f, fs = 1.0f;
              int tile2 = 0;
              const float hi2 = t_hi + (float)zero;
              const bool hit2 =
                  mj == 0 ? lane_test<kTiles, 0>(p, ro, rd, ra.w, rb.w, rc.x,
                                                 hi2, t2, tile2, f0, f1, fs)
                  : mj == 1
                      ? lane_test<kTiles, 1>(p, ro, rd, ra.w, rb.w, rc.x, hi2,
                                             t2, tile2, f0, f1, fs)
                      : lane_test<kTiles, 2>(p, ro, rd, ra.w, rb.w, rc.x, hi2,
                                             t2, tile2, f0, f1, fs);
              hit = hit && hit2 && t2 == t && tile2 == tile;
            }
""" + _REDUCE)],
    "no register cap": [("__launch_bounds__(kThreads, kBlocksPerSm)",
                         "__launch_bounds__(kThreads)")],
    "plane first": [(_PLANE, ""), (_EDGES, _PLANE + _EDGES)],
}


# B1's variants (csrc/bvh_walk.cu)
_BVH_STACK = """struct Stack {
  int2 slot[kStack];
};
"""
_BVH_SHARED_STACK = """extern __shared__ int2 g_stack[];  // [slot][thread]

struct Stack {
  int2* slot = g_stack + threadIdx.x;
};
"""
_BVH_LAUNCH = """            const Tree& tree, const Out& out, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
"""
_BVH_KERNELS = ("<<<blocks, kThreads, 0, s>>>(\n        o, d, t_min, "
                "t_min_step, t_max, t_max_step, n, tree, out);\n  }")
_BVH_LEAF8 = """    float4 q[24];  // every load of the leaf in flight before its tests
#pragma unroll
    for (int k = 0; k < 24; ++k) q[k] = __ldg(rec + k);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[9], n[3];
      unpack(q[3 * k], q[3 * k + 1], q[3 * k + 2], v, n);
      any |= leaf_tri<kAny>(v, n, r, t_hi, base + k, t_leaf, hit);
    }
"""
_BVH_PLANE_FIRST = """    // the planes of all 8 first, from v0 and n (each record's first and
    // third float4), then the edge functions of those whose t passed the
    // window, in index order
    unsigned cand = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 a = __ldg(rec + 3 * k), c = __ldg(rec + 3 * k + 2);
      const float v0[3] = {a.x, a.y, a.z}, n[3] = {c.y, c.z, c.w};
      const float t = plane_t(v0, n, r);
      if (t > r.t_min && t < t_hi) cand |= 1u << k;
    }
    while (cand != 0 && !any) {
      const int k = __ffs(cand) - 1;
      cand &= cand - 1;
      float v[9], n[3];
      unpack(__ldg(rec + 3 * k), __ldg(rec + 3 * k + 1),
             __ldg(rec + 3 * k + 2), v, n);
      any = leaf_tri<kAny>(v, n, r, t_hi, base + k, t_leaf, hit);
    }
"""
_BVH_WALK = """  int leaf = -1;
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
"""
_BVH_ONE_A_STEP = """  while (true) {
    if (!have) {
      if (sp == 0) return false;
      pop(st, sp, node, e);
      if (!(e <= best.t)) continue;
    }
    if (node >= leaf0) {
      have = false;
      if (leaf_test<kAny, kLeaf8>(tree, node, r, best)) return true;
    } else {
      have = descend(tree, r, best.t, st, sp, node, e);
    }
  }
"""
# the same walk with the leaf tested where the inner loop breaks (node
# itself), the loop returning when the stack runs out
_BVH_LEAF_IN_LOOP = """  while (true) {
    while (true) {  // inner nodes, until this lane holds a leaf
      if (!have) {
        if (sp == 0) return false;
        pop(st, sp, node, e);
        if (!(e <= best.t)) continue;
      }
      if (node >= leaf0) break;
      have = descend(tree, r, best.t, st, sp, node, e);
    }
    have = false;
    if (leaf_test<kAny, kLeaf8>(tree, node, r, best)) return true;
  }
"""
# the leaf held in a variable of its own, the inner loop breaking at it and
# the walk ending where that loop finds the stack empty
_BVH_LEAF_ONCE = """  int leaf = -1;
  while (true) {
    while (true) {  // inner nodes, until this lane holds a leaf
      if (!have) {
        if (sp == 0) break;
        pop(st, sp, node, e);
        if (!(e <= best.t)) continue;
        have = true;
      }
      if (node >= leaf0) {
        leaf = node;
        have = false;
        break;
      }
      have = descend(tree, r, best.t, st, sp, node, e);
    }
    if (leaf < 0) return false;  // the stack ran out
    if (leaf_test<kAny, kLeaf8>(tree, leaf, r, best)) return true;
    leaf = -1;
  }
"""
# the postponed leaf: a leaf met is put off while the lane walks on through
# inner nodes, until it meets a second one or every lane of its warp holds
# one; the inner steps between prune with a t_best that has not seen the
# put-off leaf, so each leaf's t_enter is checked against t_best again just
# before its triangles are tested (a box inside another is entered no
# earlier), which keeps the bits
_BVH_POSTPONED = """  int leaf = -1;  // the put-off leaf
  float leaf_e = 0.0f;
  while (true) {
    while (true) {  // inner nodes
      if (!have) {
        if (sp == 0) break;
        pop(st, sp, node, e);
        if (!(e <= best.t)) continue;
        have = true;
      }
      if (node >= leaf0) {
        if (leaf >= 0) break;  // a second leaf: test both
        leaf = node;
        leaf_e = e;
        have = false;
      } else {
        have = descend(tree, r, best.t, st, sp, node, e);
      }
      if (__all_sync(__activemask(), leaf >= 0)) break;
    }
    if (leaf >= 0) {
      if (leaf_e <= best.t && leaf_test<kAny, kLeaf8>(tree, leaf, r, best))
        return true;
      leaf = -1;
    }
    if (have && node >= leaf0) {
      have = false;
      if (e <= best.t && leaf_test<kAny, kLeaf8>(tree, node, r, best))
        return true;
    }
    if (!have && sp == 0) return false;
  }
"""
_BVH_LEAF8_ENTRIES = [("if (kAny && tree.leaf_size == 8) {",
                       "if (tree.leaf_size == 8) {"),
                      ("bvh_walk_kernel<kAny, kAny><<<",
                       "bvh_walk_kernel<kAny, true><<<")]

BVH_VARIANTS = {
    "as built": [],
    "one node a step": [(_BVH_WALK, _BVH_ONE_A_STEP)],
    "leaf in the loop": [(_BVH_WALK, _BVH_LEAF_IN_LOOP)],
    "leaf held once": [(_BVH_WALK, _BVH_LEAF_ONCE)],
    "postponed leaf": [(_BVH_WALK, _BVH_POSTPONED)],
    "depth in memory": [
        (_BVH_STACK, _BVH_STACK.replace("struct Stack {\n",
                                        "struct Stack {\n  int sp = 0;\n")),
        ("  Stack st;\n  int sp = 0;\n", "  Stack st;\n  int& sp = st.sp;\n")],
    "leaf8 closest": _BVH_LEAF8_ENTRIES,
    "plane first": [(_BVH_LEAF8, _BVH_PLANE_FIRST)] + _BVH_LEAF8_ENTRIES,
    "leaf loop any": [("if (kAny && tree.leaf_size == 8) {",
                       "if (false) {")],
    "shared stack": [
        (_BVH_STACK, _BVH_SHARED_STACK),
        ("  st.slot[sp++] = make_int2", "  st.slot[kThreads * sp++] = make_int2"),
        ("  const int2 x = st.slot[--sp];",
         "  const int2 x = st.slot[kThreads * --sp];"),
        (_BVH_LAUNCH, _BVH_LAUNCH.replace("cudaStream_t s) {",
                                          "cudaStream_t s, int depth) {")
         + "  const size_t smem = (size_t)(depth + 1) * kThreads * "
           "sizeof(int2);\n"),
        (_BVH_KERNELS + " else {", _BVH_KERNELS.replace(", 0, s>>>",
                                                        ", smem, s>>>")
         + " else {"),
        (_BVH_KERNELS + "\n}", _BVH_KERNELS.replace(", 0, s>>>",
                                                    ", smem, s>>>") + "\n}"),
        ("n, tree, out, s);\n  } else {",
         "n, tree, out, s, depth);\n  } else {"),
        ("n, tree, out, s);\n  }\n  return",
         "n, tree, out, s, depth);\n  }\n  return"),
    ],
    "64 threads": [("constexpr int kThreads = 128;",
                    "constexpr int kThreads = 64;")],
}

# X1's and X3's variants (csrc/bsdf.cu): its design switches (steps 1 and
# 2) set by substitution, and the steps measured and not taken: 3, a block's
# lanes regrouped by lobe (a counting sort in shared memory, warp by warp:
# each thread computes the block's lane at its sorted slot; no lane's
# arithmetic changes), and 4, X3's six directions in two passes (each
# recomputing the value) or its blocks an SM for __launch_bounds__
BSDF_AS_BUILT = {"kRcpOn": "true", "kConstRowsOn": "true"}
_BSDF_SAMPLE_HEAD = """    bsdf_sample_kernel(const Args a) {
  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
"""
_BSDF_BWD_HEAD = """bsdf_f_bwd_kernel(const Args a) {
  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
"""
_BSDF_PICK = "// BSDF::Sample_f's lobe pick"
# a key below kKeys (two lobe codes + 1, three bits each); every thread of
# the block calls regroup (lanes past n give the last key and compute
# nothing), which returns the lane this thread computes
_BSDF_REGROUP = """constexpr int kKeys = 64;
struct Regroup {
  int count[kKeys];
  int16_t order[kThreads];
};

__device__ __forceinline__ int lobe_key(int64_t code, int64_t other) {
  return static_cast<int>(((code + 1) & 7) | (((other + 1) & 7) << 3));
}

__device__ __forceinline__ int64_t regroup(Regroup& s, int64_t base,
                                           int key) {
  const unsigned kFull = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31;
  if (t < kKeys) s.count[t] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  int start = 0;
  if (lane == leader) start = atomicAdd(&s.count[key], __popc(peers));
  start = __shfl_sync(kFull, start, leader) +
          __popc(peers & ((1u << lane) - 1u));
  __syncthreads();
  if (t < 32) {  // exclusive scan of the counts, two a lane
    const int c0 = s.count[2 * t], c1 = s.count[2 * t + 1];
    int incl = c0 + c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    s.count[2 * t] = incl - c0 - c1;
    s.count[2 * t + 1] = incl - c1;
  }
  __syncthreads();
  s.order[s.count[key] + start] = static_cast<int16_t>(t);
  __syncthreads();
  return base + s.order[t];
}

"""
_BSDF_REGROUP_X1 = """  {
    __shared__ Regroup s;
    int key = kKeys - 1;
    if (i < a.n) {
      int64_t code, other;
      pick_lobes(load_lobes(a, i), a.u1[i], code, other);
      key = lobe_key(code, other);
    }
    i = regroup(s, i - threadIdx.x, key);
  }
"""
_BSDF_REGROUP_X3 = """  {
    __shared__ Regroup s;
    int key = kKeys - 1;
    if (i < a.n) {
      if (kMode == 0) {
        key = a.bits[i] & (kKeys - 1);
      } else {
        const int64_t two = a.n_lobes[i] >= 2;
        key = lobe_key(a.lobe[2 * i], two ? a.lobe[2 * i + 1] : -1);
      }
    }
    i = regroup(s, i - threadIdx.x, key);
  }
"""
_BSDF_ONE_PASS = """  RowGrads<D> rg;
  double g_dir[kDirs] = {};
  int64_t code = add_terms<D, kMode>(a, i, dual_lane<D>(Lf), wi, g, rg, g_dir);
"""
_BSDF_TWO_PASSES = """  RowGrads<D> rg;
  double g_dir[kAllDirs];
  int64_t code = 0;
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {  // directions p * kDirs on
    const int k0 = p * kDirs;
    Lane<Dual<D>> L = dual_lane<D>(Lf);
    L.eta = Dual<D>::seed(Lf.eta, D_ETA - k0);
    L.alpha = Dual<D>::seed(Lf.alpha, D_ALPHA - k0);
    L.eta_outer = Dual<D>::seed(Lf.eta_outer, D_ETA_OUTER - k0);
    L.wo = V3<Dual<D>>{Dual<D>::seed(Lf.wo.x, D_WOX - k0),
                       Dual<D>::seed(Lf.wo.y, D_WOY - k0),
                       Dual<D>::seed(Lf.wo.z, D_WOZ - k0)};
    RowGrads<D> rg_p;  // every pass's; the first's kept
    double g_s[kDirs] = {};
    code = add_terms<D, kMode>(a, i, L, wi, g, rg_p, g_s);
    if (p == 0) rg = rg_p;
#pragma unroll
    for (int k = 0; k < kDirs; ++k)
#pragma unroll
      for (int q = 0; q < kPasses; ++q)  // constant indices only
        if (q == p) g_dir[q * kDirs + k] = g_s[k];
  }
"""
_BSDF_BWD_BOUNDS = ("__global__ void __launch_bounds__(kThreads) "
                    "bsdf_f_bwd_kernel(const Args a) {")

# the sample+eval launch (X2's redesign) in other shapes, measured and not
# taken: its kernel's head and its two-threads-a-lane body as built, and
# its launch
_SE_HEAD = ("__global__ void __launch_bounds__(kThreads)\n"
            "    bsdf_sample_eval_kernel(const Args a) {\n")
_SE_TWO_THREADS = """  const int64_t half = (a.n + kThreads - 1) / kThreads * kThreads;
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
"""
_SE_LAUNCH = "bsdf_sample_eval_kernel<Redesign><<<2 * blocks(n), kThreads, 0,"
# one thread a lane: X1's body, then X2's at wi_b on the same loaded lane
# (each row read once, a thread's chain twice as long)
_SE_ONE_THREAD = """  int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= a.n) return;
  const Lane<float> L = load_lane<float>(a, i);
  const Lobes lb = load_lobes(a, i);
  const float u1 = a.u1[i], u2x = a.u2[2 * i], u2y = a.u2[2 * i + 1];
  const int64_t prev_flags = a.prev_flags[i];
  const V3<float> wi_b{a.wi_b[3 * i], a.wi_b[3 * i + 1], a.wi_b[3 * i + 2]};
"""
_SE_BODIES = ["  sample_lane<D>(a, i, L, lb, u1, u2x, u2y, prev_flags);\n",
              "  eval_lane<D>(L, lb, wi_b, a.f_b + 3 * i, a.pdf_b + i);\n"]


def _se_one_thread(eval_first=False, blocks=None):
    """The one-thread-a-lane kernel's substitutions: its bodies in either
    order, its blocks an SM for __launch_bounds__."""
    head = (_SE_HEAD if blocks is None else
            _SE_HEAD.replace("(kThreads)", f"(kThreads, {blocks})"))
    bodies = _SE_BODIES[::-1] if eval_first else _SE_BODIES
    return [(_SE_HEAD + _SE_TWO_THREADS,
             head + _SE_ONE_THREAD + "".join(bodies) + "}\n"),
            (_SE_LAUNCH, _SE_LAUNCH.replace("2 * blocks(n)", "blocks(n)"))]


# two threads a lane in one block: its first two warps sample its 64
# lanes, its last two evaluate them
_SE_SAME_BLOCK_HEAD = """  constexpr int kLanes = kThreads / 2;
  const bool eval = threadIdx.x >= kLanes;  // the same in a warp
  const int64_t i = blockIdx.x * static_cast<int64_t>(kLanes) +
                    (eval ? threadIdx.x - kLanes : threadIdx.x);
"""
SE_VARIANTS = {
    "SE one thread a lane": _se_one_thread(),
    "SE one thread, eval first": _se_one_thread(eval_first=True),
    "SE one thread, nine blocks": _se_one_thread(blocks=9),
    "SE two warps a role": [
        ("".join(_SE_TWO_THREADS.splitlines(keepends=True)[:4]),
         _SE_SAME_BLOCK_HEAD),
        (_SE_LAUNCH, _SE_LAUNCH.replace("2 * blocks(n)", "blocks(2 * n)"))],
}


def _bsdf_steps(rcp=True, rows=True, regroup=(), split=False, blocks=1):
    """The substitutions of one variant of csrc/bsdf.cu: steps 1 (rcp) and
    2 (rows) on or off, step 3 for the kernels in regroup ("X1", "X3"),
    step 4's two passes (split) and X3's blocks an SM."""
    subs = [(f"constexpr bool {k} = true;", f"constexpr bool {k} = false;")
            for k, on in (("kRcpOn", rcp), ("kConstRowsOn", rows)) if not on]
    if regroup:
        subs.append((_BSDF_PICK, _BSDF_REGROUP + _BSDF_PICK))
    if "X1" in regroup:
        subs.append((_BSDF_SAMPLE_HEAD, _BSDF_SAMPLE_HEAD + _BSDF_REGROUP_X1))
    if "X3" in regroup:
        subs.append((_BSDF_BWD_HEAD, _BSDF_BWD_HEAD + _BSDF_REGROUP_X3))
    if split:
        subs += [("constexpr int kDirs = 6;",
                  "constexpr int kPasses = 2, kAllDirs = 6, "
                  "kDirs = kAllDirs / kPasses;"),
                 (_BSDF_ONE_PASS, _BSDF_TWO_PASSES)]
    if blocks > 1:
        subs.append((_BSDF_BWD_BOUNDS, _BSDF_BWD_BOUNDS.replace(
            "(kThreads)", f"(kThreads, {blocks})")))
    return subs


_OFF = dict(rcp=False, rows=False)
BSDF_VARIANTS = {
    "as built": [],
    "first design": _bsdf_steps(**_OFF),
    "1 rcp + fma": _bsdf_steps(rows=False),
    "2 const rows": _bsdf_steps(rcp=False),
    "3 regroup X1": _bsdf_steps(**_OFF, regroup=("X1",)),
    "3 regroup X3": _bsdf_steps(**_OFF, regroup=("X3",)),
    "4 split": _bsdf_steps(**_OFF, split=True),
    "4 four blocks": _bsdf_steps(**_OFF, blocks=4),
    "1-2 + split": _bsdf_steps(split=True),
    "1-2 + three blocks": _bsdf_steps(blocks=3),
    "1-2 + four blocks": _bsdf_steps(blocks=4),
    "1-3": _bsdf_steps(regroup=("X1", "X3")),
    "1-4 (split, three blocks)": _bsdf_steps(regroup=("X1", "X3"),
                                             split=True, blocks=3),
    **SE_VARIANTS,
}

# V1/V2's redesign steps (csrc/vol_step.cu's switches, as built), and the
# variants: every step off, each step off alone, the staged rows, the
# block size
VOL_AS_BUILT = {"kSelectOn": "true", "kClipOn": "true", "kIdx32On": "true",
                "kRowOn": "true", "kDrawsOn": "true", "kTrigOn": "true",
                "kRowStoreOn": "true"}
_VOL_THREADS = "constexpr int kThreads = 128;"


def _vol_flip(*names):
    return [(f"constexpr bool {k} = true;", f"constexpr bool {k} = false;")
            for k in names]


# V1/V2's "stage" variant (measured, and not taken): a block's (N, 3) rows
# staged through shared memory with 16-byte loads and stores; the shipped
# kernels, whole, and their staged forms
_VOL_V1 = """// V1.  out: the 11 state fields (VolState's order), died, esc (bool), the
// caller's int64 accumulator of segment starts (added to)
__global__ void __launch_bounds__(kThreads) vol_steps_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned seg = 0;
  if (i < a.n) {
    const Medium m = medium_of(a);
    Lane L = lane_of(a, i);
    bool died = false, esc = false;
    for (int s = 0; s < a.k; ++s) {
      seg += (L.alive && L.new_ray) ? 1u : 0u;
      bool died_s, esc_s;
      flight_step<false>(L, m, died_s, esc_s, nullptr);
      died = died || died_s;
      esc = esc || esc_s;
    }
    static_cast<bool*>(a.out[0])[i] = L.alive;
    static_cast<bool*>(a.out[1])[i] = L.new_ray;
    static_cast<int64_t*>(a.out[2])[i] = L.bounce;
    static_cast<float*>(a.out[3])[i] = L.u_mode;
    static_cast<float*>(a.out[4])[i] = L.t_cur;
    static_cast<float*>(a.out[5])[i] = L.t_exit;
    for (int c = 0; c < 3; ++c) {
      static_cast<float*>(a.out[6])[3 * i + c] = L.o[c];
      static_cast<float*>(a.out[7])[3 * i + c] = L.d[c];
      static_cast<float*>(a.out[9])[3 * i + c] = L.beta[c];
      static_cast<float*>(a.out[10])[3 * i + c] = L.l[c];
    }
    static_cast<int64_t*>(a.out[8])[i] = static_cast<int64_t>(L.st);
    static_cast<bool*>(a.out[11])[i] = died;
    static_cast<bool*>(a.out[12])[i] = esc;
  }
  // the segment starts: a warp's sum, one integer atomic into the
  // caller's accumulator
  for (int off = 16; off > 0; off >>= 1)
    seg += __shfl_down_sync(0xffffffffu, seg, off);
  if ((threadIdx.x & 31) == 0 && seg != 0)
    atomicAdd(static_cast<unsigned long long*>(a.out[13]),
              static_cast<unsigned long long>(seg));
}

"""
_VOL_V1_STAGED = """// (the "stage" variant) a block's slice of an (N, 3) float tensor (3 *
// count floats from lane `base` on) into shared memory and back: 16-byte
// accesses where the tensor is 16-byte aligned (a block's slice starts at
// a multiple of 16 bytes: kThreads is a multiple of 4), else 4-byte ones
__device__ __forceinline__ void rows_in(const float* src, float* sh,
                                        int64_t base, int count) {
  const float* g = src + 3 * base;
  const int nf = 3 * count;
  int j0 = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0) {
    const int n4 = nf >> 2;
    for (int j = threadIdx.x; j < n4; j += kThreads)
      reinterpret_cast<float4*>(sh)[j] =
          __ldg(reinterpret_cast<const float4*>(g) + j);
    j0 = 4 * n4;
  }
  for (int j = j0 + threadIdx.x; j < nf; j += kThreads) sh[j] = __ldg(g + j);
}

__device__ __forceinline__ void rows_out(float* dst, const float* sh,
                                         int64_t base, int count) {
  float* g = dst + 3 * base;
  const int nf = 3 * count;
  int j0 = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0) {
    const int n4 = nf >> 2;
    for (int j = threadIdx.x; j < n4; j += kThreads)
      reinterpret_cast<float4*>(g)[j] =
          reinterpret_cast<const float4*>(sh)[j];
    j0 = 4 * n4;
  }
  for (int j = j0 + threadIdx.x; j < nf; j += kThreads) g[j] = sh[j];
}

// a lane's scalars from the tensors, its (N, 3) rows from the block's
// staged slices
__device__ __forceinline__ Lane staged_lane(const Args& a, int64_t i,
                                            float (*sh)[3 * kThreads]) {
  Lane L;
  L.alive = a.alive[i];
  L.new_ray = a.new_ray[i];
  L.bounce = a.bounce[i];
  L.u_mode = a.u_mode[i];
  L.t_cur = a.t_cur[i];
  L.t_exit = a.t_exit[i];
  L.st = static_cast<uint32_t>(a.state[i]);
  const int t = 3 * threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    L.o[c] = sh[0][t + c];
    L.d[c] = sh[1][t + c];
    L.beta[c] = sh[2][t + c];
    L.l[c] = sh[3][t + c];
  }
  return L;
}

// V1.  out: the 11 state fields (VolState's order), died, esc (bool), the
// caller's int64 accumulator of segment starts (added to)
__global__ void __launch_bounds__(kThreads) vol_steps_kernel(const Args a) {
  __shared__ __align__(16) float sh[4][3 * kThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + threadIdx.x;
  const int count =
      static_cast<int>(a.n - base < kThreads ? a.n - base : kThreads);
  const float* in[4] = {a.o, a.d, a.beta, a.l_out};
  for (int r = 0; r < 4; ++r) rows_in(in[r], sh[r], base, count);
  __syncthreads();
  unsigned seg = 0;
  if (i < a.n) {
    const Medium m = medium_of(a);
    Lane L = staged_lane(a, i, sh);
    bool died = false, esc = false;
    for (int s = 0; s < a.k; ++s) {
      seg += (L.alive && L.new_ray) ? 1u : 0u;
      bool died_s, esc_s;
      flight_step<false>(L, m, died_s, esc_s, nullptr);
      died = died || died_s;
      esc = esc || esc_s;
    }
    static_cast<bool*>(a.out[0])[i] = L.alive;
    static_cast<bool*>(a.out[1])[i] = L.new_ray;
    static_cast<int64_t*>(a.out[2])[i] = L.bounce;
    static_cast<float*>(a.out[3])[i] = L.u_mode;
    static_cast<float*>(a.out[4])[i] = L.t_cur;
    static_cast<float*>(a.out[5])[i] = L.t_exit;
    const int t = 3 * threadIdx.x;  // a thread's own slots: no barrier
    for (int c = 0; c < 3; ++c) {
      sh[0][t + c] = L.o[c];
      sh[1][t + c] = L.d[c];
      sh[2][t + c] = L.beta[c];
      sh[3][t + c] = L.l[c];
    }
    static_cast<int64_t*>(a.out[8])[i] = static_cast<int64_t>(L.st);
    static_cast<bool*>(a.out[11])[i] = died;
    static_cast<bool*>(a.out[12])[i] = esc;
  }
  __syncthreads();
  const int outs[4] = {6, 7, 9, 10};
  for (int r = 0; r < 4; ++r)
    rows_out(static_cast<float*>(a.out[outs[r]]), sh[r], base, count);
  // the segment starts: a warp's sum, one integer atomic into the
  // caller's accumulator
  for (int off = 16; off > 0; off >>= 1)
    seg += __shfl_down_sync(0xffffffffu, seg, off);
  if ((threadIdx.x & 31) == 0 && seg != 0)
    atomicAdd(static_cast<unsigned long long*>(a.out[13]),
              static_cast<unsigned long long>(seg));
}

"""
_VOL_V2 = """// V2, K steps.  out: g_beta_in, g_l_in (N, 3), rows (K, N, 8), idx (K, N)
// int64, the partials of sigma_a, sigma_s (N,) and le (N, 3)
template <int K>
__global__ void __launch_bounds__(kThreads)
    vol_steps_bwd_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const Medium m = medium_of(a);
  Lane L = lane_of(a, i);
  Rec rec[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bool died_s, esc_s;
    flight_step<true>(L, m, died_s, esc_s, &rec[s]);
  }
  double gb[3], gl[3], p_le[3] = {0.0, 0.0, 0.0};
  for (int c = 0; c < 3; ++c) {
    gb[c] = a.g_beta[3 * i + c];
    gl[c] = a.g_l[3 * i + c];
  }
  double p_sa = 0.0, p_ss = 0.0;
  float* rows = static_cast<float*>(a.out[2]);
  int64_t* idx = static_cast<int64_t*>(a.out[3]);
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    float row[8];
    step_back(rec[s], m, gb, gl, row, p_sa, p_ss, p_le);
    float* dst = rows + (s * a.n + i) * 8;
    if constexpr (kRowStoreOn) {  // a row is 32 bytes, 32-byte aligned
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(row[0], row[1], row[2], row[3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(row[4], row[5], row[6], row[7]);
    } else {
      for (int k = 0; k < 8; ++k) dst[k] = row[k];
    }
    idx[s * a.n + i] = rec[s].idx;
  }
  for (int c = 0; c < 3; ++c) {
    static_cast<float*>(a.out[0])[3 * i + c] = static_cast<float>(gb[c]);
    static_cast<float*>(a.out[1])[3 * i + c] = static_cast<float>(gl[c]);
    static_cast<float*>(a.out[6])[3 * i + c] = static_cast<float>(p_le[c]);
  }
  static_cast<float*>(a.out[4])[i] = static_cast<float>(p_sa);
  static_cast<float*>(a.out[5])[i] = static_cast<float>(p_ss);
}

"""
_VOL_V2_STAGED = """// V2, K steps.  out: g_beta_in, g_l_in (N, 3), rows (K, N, 8), idx (K, N)
// int64, the partials of sigma_a, sigma_s (N,) and le (N, 3)
template <int K>
__global__ void __launch_bounds__(kThreads)
    vol_steps_bwd_kernel(const Args a) {
  __shared__ __align__(16) float sh[6][3 * kThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + threadIdx.x;
  const int count =
      static_cast<int>(a.n - base < kThreads ? a.n - base : kThreads);
  const float* in[6] = {a.o, a.d, a.beta, a.l_out, a.g_beta, a.g_l};
  for (int r = 0; r < 6; ++r) rows_in(in[r], sh[r], base, count);
  __syncthreads();
  if (i < a.n) {
  const Medium m = medium_of(a);
  Lane L = staged_lane(a, i, sh);
  Rec rec[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bool died_s, esc_s;
    flight_step<true>(L, m, died_s, esc_s, &rec[s]);
  }
  double gb[3], gl[3], p_le[3] = {0.0, 0.0, 0.0};
  const int t = 3 * threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    gb[c] = sh[4][t + c];
    gl[c] = sh[5][t + c];
  }
  double p_sa = 0.0, p_ss = 0.0;
  float* rows = static_cast<float*>(a.out[2]);
  int64_t* idx = static_cast<int64_t*>(a.out[3]);
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    float row[8];
    step_back(rec[s], m, gb, gl, row, p_sa, p_ss, p_le);
    float* dst = rows + (s * a.n + i) * 8;
    if constexpr (kRowStoreOn) {  // a row is 32 bytes, 32-byte aligned
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(row[0], row[1], row[2], row[3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(row[4], row[5], row[6], row[7]);
    } else {
      for (int k = 0; k < 8; ++k) dst[k] = row[k];
    }
    idx[s * a.n + i] = rec[s].idx;
  }
  for (int c = 0; c < 3; ++c) {  // a thread's own slots: no barrier
    sh[0][t + c] = static_cast<float>(gb[c]);
    sh[1][t + c] = static_cast<float>(gl[c]);
    sh[2][t + c] = static_cast<float>(p_le[c]);
  }
  static_cast<float*>(a.out[4])[i] = static_cast<float>(p_sa);
  static_cast<float*>(a.out[5])[i] = static_cast<float>(p_ss);
  }
  __syncthreads();
  const int outs[3] = {0, 1, 6};
  for (int r = 0; r < 3; ++r)
    rows_out(static_cast<float*>(a.out[outs[r]]), sh[r], base, count);
}

"""


VOL_VARIANTS = {
    "as built": [],
    "steps off": _vol_flip(*VOL_AS_BUILT),
    **{f"no {k[1:-2].lower()}": _vol_flip(k) for k in VOL_AS_BUILT},
    "stage": [(_VOL_V1, _VOL_V1_STAGED), (_VOL_V2, _VOL_V2_STAGED)],
    "32 threads": [(_VOL_THREADS, _VOL_THREADS.replace("128", "32"))],
    "64 threads": [(_VOL_THREADS, _VOL_THREADS.replace("128", "64"))],
}
KERNELS = {"cluster": (SOURCE, VARIANTS), "bvh": (BVH_SOURCE, BVH_VARIANTS),
           "bsdf": (BSDF_SOURCE, BSDF_VARIANTS),
           "vol": (VOL_SOURCE, VOL_VARIANTS)}


def variant_sources(kernel="cluster") -> dict:
    """{variant: its source text} of a kernel's source ("cluster", "bvh",
    "bsdf" or "vol"), each substitution applied exactly once."""
    source, variants = KERNELS[kernel]
    with open(source) as f:
        base = f.read()
    out = {}
    for name, subs in variants.items():
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"variant {name!r}: anchor found "
                                 f"{text.count(old)} times:\n{old}")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_kernels(report):
    """(kernel's mangled name, registers, stack frame bytes, spill store
    bytes, spill load bytes) of every entry function in a ptxas -v
    report."""
    rows = []
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used "
            r"(\d+) registers", report, re.S):
        name, frame, st, ld, regs = m.groups()
        rows.append((name, int(regs), int(frame), int(st), int(ld)))
    return sorted(rows)


def bsdf_design(name):
    """The Design switches in a csrc/bsdf.cu kernel's mangled name, for a
    log line: ' (the first design)', ' (the redesign)' or ' (rcp 1, rows
    0)' and the like; '' for another kernel."""
    m = re.search(r"DesignILb([01])ELb([01])E", name)
    if m is None:
        return ""
    return {("0", "0"): " (the first design)",
            ("1", "1"): " (the redesign)"}.get(
        m.groups(), " (rcp {}, rows {})".format(*m.groups()))


def graph_ms(fn, calls=20, replays=5):
    """Device ms of a call of fn: `calls` calls captured into one CUDA
    graph (after two warm calls on a side stream), the median of `replays`
    replays between CUDA events, over the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _build(name, text):
    """nvcc on one variant's source: (library path, ptxas' report)."""
    root = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(root, exist_ok=True)
    stem = os.path.join(root, re.sub(r"\W+", "_", name))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", stem + ".so", stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    return stem + ".so", proc.stderr


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ray_sets(dev, rng, kind="cluster"):
    """The three ray sets of the smoke run's kernel phase, by its recipe:
    {label: (rays, accel)}, the accel of kind "cluster" (K1's clusters) or
    "bvh" (B1's LBVH) over the same triangles."""
    build, closest = ((ca.build_clusters, ca.intersect_clusters)
                      if kind == "cluster" else
                      (bvh.build_bvh, bvh.intersect_bvh))
    sc = load_scene(DEFAULT_SCENE)
    acc = build(sc.tri_v.numpy()).to(dev)
    n, m = 65536, 131072
    o, d = camera.cast_rays(
        sc.cam_to_world, sc.fov, 1280, 720,
        torch.from_numpy(rng.integers(0, 1280, n)),
        torch.from_numpy(rng.integers(0, 720, n)),
        torch.from_numpy(rng.random((n, 2), dtype=np.float32)))
    o, d = o.to(dev), d.to(dev)
    cam = (o, d, torch.zeros(n, device=dev),
           torch.full((n,), float("inf"), device=dev))
    hit = closest(*cam, acc)
    idx = torch.nonzero(hit.tri >= 0)[:, 0]
    pick = idx[torch.from_numpy(rng.integers(0, len(idx), m)).to(dev)]
    d2 = rng.normal(size=(m, 3)).astype(np.float32)
    d2 = torch.from_numpy(d2 / np.linalg.norm(d2, axis=-1, keepdims=True))
    d2 = d2.to(dev)
    v = sc.tri_v.to(dev)[hit.tri[pick]]
    gn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    side = torch.where((gn * d2).sum(-1) > 0, 1.0, -1.0)
    gn = gn / gn.norm(dim=-1, keepdim=True)
    o2 = (o[pick] + d[pick] * hit.t[pick, None]
          + gn * (1e-3 * side)[:, None]).contiguous()
    t2 = np.where(rng.random(m) < 0.25, 0.0,
                  np.where(rng.random(m) < 0.5, np.inf,
                           rng.exponential(3.0, m))).astype(np.float32)
    sh = (o2, d2, torch.zeros(m, device=dev), torch.from_numpy(t2).to(dev))

    tri = (rng.normal(size=(40000, 3, 3)) * 0.3
           + rng.normal(size=(40000, 1, 3)) * 8.0).astype(np.float32)
    acc_b = build(tri).to(dev)
    ob = (rng.normal(size=(n, 3)) * 10.0).astype(np.float32)
    db = rng.normal(size=(n, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    tb = np.where(rng.random(n) < 0.25, 0.0, np.inf).astype(np.float32)
    soup = (torch.from_numpy(ob).to(dev), torch.from_numpy(db).to(dev),
            torch.zeros(n, device=dev), torch.from_numpy(tb).to(dev))
    return {"camera": (cam, acc), "hit points": (sh, acc),
            "soup": (soup, acc_b)}


def bvh_cases(sets):
    """{"entry set": a call of a B1 entry (closest-hit, any-hit) through
    its wrapper on a ray set of ray_sets(..., "bvh")} (reference=True calls
    nart_bvh_hit_ref instead): each returns a tuple of output tensors."""
    cases = {}
    for label in ("camera", "hit points", "soup"):
        for entry, any_hit in (("closest-hit", False), ("any-hit", True)):
            def call(reference=False, r=sets[label], a=any_hit):
                if reference:
                    out = bvh.bvh_hit_ref_cuda(*r[0], r[1], any_hit=a)
                else:
                    out = (bvh.bvh_any_cuda if a else bvh.bvh_hit_cuda)(
                        *r[0], r[1])
                return (out,) if a else tuple(out)
            cases[f"{entry} {label}"] = call
    return cases


def _run_bvh(built, args):
    """B1's rows: every variant (and the reference, from the as-built
    library) timed on every case, in turns, checked against the
    reference's bits."""
    sets = ray_sets(torch.device("cuda"), np.random.default_rng(0), "bvh")
    for label, (rays, tree) in sets.items():
        print(f"ray set {label}: {rays[0].shape[0]} rays, tree of "
              f"{tree.n_leaves} leaves of {tree.leaf_size}, depth "
              f"{tree.depth}", flush=True)
    cases = bvh_cases(sets)
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    want = {}
    with mock.patch.object(cuda_build, "load",
                           lambda _name: libs["as built"]):
        for label, fn in cases.items():
            want[label] = fn(reference=True)
    for rnd in range(args.rounds):
        rows = [("reference", "as built", True)] + [
            (name, name, False) for name in built]
        for row, lib_name, ref in rows:
            with mock.patch.object(cuda_build, "load",
                                   lambda _name, n=lib_name: libs[n]):
                same = True
                times = []
                for label, fn in cases.items():
                    same &= all(torch.equal(a, b) for a, b in
                                zip(fn(reference=ref), want[label]))
                    ms = graph_ms(lambda f=fn: f(reference=ref), args.reps)
                    times.append(f"{label} {ms:.4f}")
            print(f"round {rnd + 1} {row:14s} " + "  ".join(times)
                  + f"  same={same}", flush=True)
            if not same:
                raise AssertionError(f"variant {row!r} changed a result")


def bsdf_sets(dev, seed=0):
    """X1-X3's lane sets: {"macbeth": phase 27's mid-trace round of macbeth
    1280x720 @ 1 (its strategy A sample and strategy B eval, one
    sample_eval_f call, as the two calls they stand for),
    "glossy": 65,536 lanes of testing.bsdf_lane_set's "glossy" (the sample
    call's inputs, and the eval call's on the same lanes), "macbeth x4":
    macbeth's lanes four times over (262,144: four waves of X1)}: each
    (sample inputs, eval inputs), dicts of tensors on dev."""
    from . import render

    sc = load_scene(DEFAULT_SCENE)
    params = render.load_sessions(DEFAULT_SCENE, {"spp": 1})[0]
    _, _, calls = testing.mid_trace_bsdf(
        lambda: render.RenderSession(sc, params, dev, per_round=True))
    glossy = testing.bsdf_lane_set("glossy", 65536, seed, dev)
    fused = calls["sample A + eval B"]
    return {"macbeth": testing.split_sample_eval(fused),
            "glossy": (glossy, glossy),
            "macbeth x4": testing.split_sample_eval(testing.tiled(fused, 4))}


def bsdf_cases(sets, seed=0):
    """{"kernel set": a call of X1, X2 (its first design, nart_bsdf_eval),
    X3 ("sample" or "eval" mode) or the sample+eval launch (X2's redesign,
    "SE") through its bsdf_ops wrapper on a set of bsdf_sets}
    (reference=True: X1's and X3's first designs; X2's first design has no
    other and runs as built; for "SE", X1 then X2 as built, the two
    launches it replaces): each returns a tuple of output tensors.  X3's
    "sample" mode takes the reference X1's wi and bits, its cotangents are
    normals from seed.  "SE" evaluates at the set's eval direction (the
    same lanes' wi_b on macbeth)."""
    rng = np.random.default_rng(seed)
    cases = {}
    for label, (s, e) in sets.items():
        desc, wo, up, eo = s["desc"], s["wo"], s["use_prime"], s["eta_outer"]
        args = (desc, wo, s["u1"], s["u2"], up, eo, s["prev_flags"])
        x1 = bsdf_ops.sample_ref_cuda(*args)
        n = wo.shape[0]

        def normal(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(wo.device)

        cots = (normal(n, 3), normal(n), normal(n))
        g_e = normal(n, 3)
        e_args = (e["desc"], e["wo"], e["wi"], e["use_prime"],
                  e["eta_outer"])

        def x1_call(reference=False, a=args):
            return (bsdf_ops.sample_ref_cuda if reference
                    else bsdf_ops.sample_cuda)(*a)

        def x2_call(reference=False, a=e_args):
            return bsdf_ops.eval_cuda(*a)

        def x3s_call(reference=False, a=args, x=x1, c=cots):
            return (bsdf_ops.f_bwd_ref_cuda if reference
                    else bsdf_ops.f_bwd_cuda)(
                "sample", a[0], a[1], x[1], a[4], a[5], *c, u2=a[3],
                prev_flags=a[6], bits=x[6])

        def x3e_call(reference=False, a=e_args, g=g_e):
            return (bsdf_ops.f_bwd_ref_cuda if reference
                    else bsdf_ops.f_bwd_cuda)("eval", *a, g)

        def se_call(reference=False, a=args, w=e["wi"]):
            if reference:
                return (*bsdf_ops.sample_cuda(*a),
                        *bsdf_ops.eval_cuda(a[0], a[1], w, a[4], a[5]))
            return bsdf_ops.sample_eval_cuda(*a, w)

        cases[f"X1 {label}"] = x1_call
        cases[f"X2 {label}"] = x2_call
        cases[f"X3s {label}"] = x3s_call
        cases[f"X3e {label}"] = x3e_call
        cases[f"SE {label}"] = se_call
    return cases


def bsdf_same(key, got, want):
    """(outputs within the rule, share of equal bits): X1, X2 and the
    sample+eval launch the reference's bits, X3 within rtol 1e-5 / atol
    1e-6 of the reference's."""
    if key.startswith("X3"):
        return all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                   for a, b in zip(got, want)), testing.bit_share(got, want)
    same = all(torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in zip(got, want))
    return same, float(same)


def _run_bsdf(built, args):
    """X1-X3's rows: every variant (and the reference, from the as-built
    library) timed on every case, in turns, checked against the
    reference's outputs."""
    sets = bsdf_sets(torch.device("cuda"))
    for label, (s, e) in sets.items():
        print(f"lane set {label}: {s['wo'].shape[0]} sample lanes, lobe 0 "
              f"codes -1..4 {torch.bincount(s['desc'].lobe[:, 0] + 1, minlength=6).tolist()}; "
              f"{e['wo'].shape[0]} eval lanes", flush=True)
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    with mock.patch.object(cuda_build, "load",
                           lambda _name: libs["as built"]):
        cases = bsdf_cases(sets)
        want = {key: fn(reference=True) for key, fn in cases.items()}
    for rnd in range(args.rounds):
        rows = [("reference", "as built", True)] + [
            (name, name, False) for name in built]
        for row, lib_name, ref in rows:
            with mock.patch.object(cuda_build, "load",
                                   lambda _name, n=lib_name: libs[n]):
                same = True
                times = []
                for key, fn in cases.items():
                    ok, share = bsdf_same(key, fn(reference=ref), want[key])
                    same &= ok
                    ms = graph_ms(lambda f=fn: f(reference=ref), args.reps)
                    times.append(f"{key} {ms:.4f}" + (
                        f" ({share:.3f} bits)" if key.startswith("X3")
                        and not ref else ""))
            print(f"round {rnd + 1} {row:26s} " + "  ".join(times)
                  + f"  same={same}", flush=True)
            if not same:
                raise AssertionError(f"variant {row!r} changed a result")


VOL_ROUND = 60  # volume_blob's round whose states the vol rows time
VOL_LANES = 32768  # the edge set's lanes


def vol_sets(dev, seed=28):
    """V1/V2's lane sets: {"round 60": volume_blob 1280x720 @ 4's
    static-machine states at round VOL_ROUND (testing.vol_round_states),
    "edge": testing.vol_lane_set's VOL_LANES lanes}: each a dict (vs,
    cells, medium, sigma_maj, bounces, g_beta, g_l) on dev, the cotangents
    normals from seed."""
    from . import render
    from .bench_configs import load_scene_doc

    scene = load_scene_doc(VOL_SCENE, os.path.dirname(VOL_SCENE))
    (params,) = render.load_sessions(
        VOL_SCENE, {"image_width": 1280, "image_height": 720, "spp": 4})
    (st,) = testing.vol_round_states(
        lambda: render.RenderSession(scene, params, dev, per_round=True),
        {VOL_ROUND}).values()
    vs, _, cells, medium, sigma_maj, bounces = st
    rng = np.random.default_rng(seed)
    sets = {"round 60": dict(vs=vs, cells=cells, medium=medium,
                             sigma_maj=sigma_maj, bounces=bounces),
            "edge": testing.vol_lane_set(VOL_LANES, seed, dev)}
    for s in sets.values():
        n = s["vs"].alive.shape[0]
        s["g_beta"], s["g_l"] = (torch.from_numpy(rng.normal(size=(
            n, 3)).astype(np.float32)).to(dev) for _ in range(2))
    return sets


def vol_args(s):
    """steps_bwd_cuda's tensor arguments of a vol_sets set."""
    m = s["medium"]
    return [getattr(s["vs"], f).contiguous() for f in vol_ops.FIELDS] + [
        s["cells"], m.sigma_a, m.sigma_s, m.le, m.bounds_min, m.bounds_max,
        s["sigma_maj"], s["g_beta"], s["g_l"]]


def vol_cases(sets, k=4):
    """{"V1 set" / "V2 set": a call of V1 (with an accumulator, as the
    machines call it) or V2 through its vol_ops wrapper on a vol_sets
    set} (reference=True: the first designs, V1 with its zero-filled
    count): each returns a tuple of output tensors (V1's without the
    count, which the accumulator's calls sum)."""
    cases = {}
    for label, s in sets.items():
        args = vol_args(s)
        shape = tuple(s["medium"].density.shape)
        acc = torch.zeros((), dtype=torch.int64, device=args[0].device)

        def v1(reference=False, a=args, sh=shape, b=s["bounces"], acc=acc):
            if reference:
                return vol_ops.steps_ref_cuda(k, b, sh, *a[:-2])[:-1]
            return vol_ops.steps_cuda(k, b, sh, *a[:-2], seg=acc)[:-1]

        def v2(reference=False, a=args, sh=shape, b=s["bounces"]):
            return (vol_ops.steps_bwd_ref_cuda if reference
                    else vol_ops.steps_bwd_cuda)(k, b, sh, *a)

        cases[f"V1 {label}"] = v1
        cases[f"V2 {label}"] = v2
    return cases


def _run_vol(built, args):
    """V1/V2's rows: every variant (and the reference, from the as-built
    library) timed on every case, in turns, each output the reference's
    bits; the node floor beside them in every round."""
    dev = torch.device("cuda")
    sets = vol_sets(dev)
    for label, s in sets.items():
        print(f"lane set {label}: {s['vs'].alive.shape[0]} lanes, "
              f"{int(s['vs'].alive.sum())} alive", flush=True)
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    with mock.patch.object(cuda_build, "load",
                           lambda _name: libs["as built"]):
        cases = vol_cases(sets)
        want = {key: fn(reference=True) for key, fn in cases.items()}
    n = sets["round 60"]["vs"].alive.shape[0]
    one = torch.zeros((), dtype=torch.int64, device=dev)
    for rnd in range(args.rounds):
        with mock.patch.object(cuda_build, "load",
                               lambda _name: libs["as built"]):
            empty = graph_ms(lambda: vol_ops.node_floor_cuda(n, dev),
                             args.reps)
        fill = graph_ms(lambda: one.zero_(), args.reps)
        print(f"round {rnd + 1} node floor: empty kernel of V1's grid "
              f"({n} lanes) {empty:.4f}, one-element fill {fill:.4f}",
              flush=True)
        rows = [("reference", "as built", True)] + [
            (name, name, False) for name in built]
        for row, lib_name, ref in rows:
            with mock.patch.object(cuda_build, "load",
                                   lambda _name, n=lib_name: libs[n]):
                same = True
                times = []
                for key, fn in cases.items():
                    same &= all(
                        torch.equal(a.contiguous().view(torch.uint8),
                                    b.contiguous().view(torch.uint8))
                        for a, b in zip(fn(reference=ref), want[key]))
                    ms = graph_ms(lambda f=fn: f(reference=ref), args.reps)
                    times.append(f"{key} {ms:.4f}")
            print(f"round {rnd + 1} {row:14s} " + "  ".join(times)
                  + f"  same={same}", flush=True)
            if not same:
                raise AssertionError(f"variant {row!r} changed a result")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="cluster")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    sources = variant_sources(args.kernel)
    with ThreadPoolExecutor() as pool:  # one nvcc each, all started together
        built = dict(zip(sources, pool.map(
            _build, [f"{args.kernel} {n}" for n in sources],
            sources.values())))
    for name, (_, report) in built.items():
        for kname, regs, frame, st, ld in ptxas_kernels(report):
            print(f"ptxas {name}: {kname}{bsdf_design(kname)} {regs} "
                  f"registers, stack frame {frame} B, spill stores {st} B, "
                  f"spill loads {ld} B", flush=True)
    if args.kernel == "bvh":
        _run_bvh(built, args)
        return
    if args.kernel == "bsdf":
        _run_bsdf(built, args)
        return
    if args.kernel == "vol":
        _run_vol(built, args)
        return

    sets = ray_sets(torch.device("cuda"), np.random.default_rng(0))
    cases = {}  # label: a kernel through its wrapper, returning one tensor
    for label in ("camera", "soup"):
        cases["closest-hit " + label] = (
            lambda r=sets[label]: ca.intersect_clusters(*r[0], r[1]).tri)
    for label in ("hit points", "soup"):
        cases["any-hit " + label] = (
            lambda r=sets[label]: ca.intersect_clusters_any(*r[0], r[1]))
    want = {}
    for rnd in range(args.rounds):
        for name, (so, _) in built.items():
            lib = ctypes.CDLL(so)
            with mock.patch.object(cuda_build, "load", lambda _name: lib):
                same = True
                times = []
                for label, fn in cases.items():
                    same &= torch.equal(fn(), want.setdefault(label, fn()))
                    times.append(f"{label} {cuda_ms(fn, args.reps):.4f}")
            print(f"round {rnd + 1} {name:16s} " + "  ".join(times)
                  + f"  same={same}", flush=True)
            if not same:
                raise AssertionError(f"variant {name!r} changed a result")


if __name__ == "__main__":
    main()
