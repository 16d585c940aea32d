"""LBVH acceleration structure: Morton-ordered build + lockstep traversal.

Counterpart of ``nart_tpu/accel.py`` (the "bvh" accel kind; reference
src/core/bvh.cpp's role).  Triangles are sorted by the Morton code of their
centroid, grouped into fixed-size leaves, and a complete binary tree of
AABBs is built bottom-up over the leaf sequence (numpy, on the host; the
same arrays as the JAX package's build).  ``intersect_bvh`` walks it with
an explicit per-ray stack: every live ray pops one node per iteration,
internal nodes push their children nearest-first, leaves run the watertight
test on their triangles, and the loop ends when every stack is empty.

The JAX walk is XLA, not Pallas, so this is plain PyTorch on both devices:
no hand kernel replaces it.  On the card it is a slow path (one host sync
and ~60 small kernels per node visited); the cluster kernels are the fast
one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .cluster_accel import morton3
from .geometry import Hit, edge_fn, ray_shear
from .scene import _to_device

INF = np.float32(np.inf)


@dataclass
class BVH:
    """Complete binary tree over Morton-ordered leaves (array layout).

    Node i's children are 2i+1 and 2i+2; leaves occupy the last `n_leaves`
    slots.  Leaf j covers triangles [j*leaf_size, (j+1)*leaf_size) of the
    reordered soup; `order` maps reordered -> original triangle ids."""

    node_lo: Any  # (n_nodes, 3) f32
    node_hi: Any  # (n_nodes, 3) f32
    order: Any  # (T_padded,) int64 original tri id, -1 = padding
    tri_v: Any  # (T_padded, 3, 3) f32 reordered vertices
    n_leaves: int  # power of two
    leaf_size: int
    depth: int  # tree depth (root = 0)

    def to(self, device):
        return _to_device(self, device)


def build_bvh_arrays(tri_v: np.ndarray, leaf_size: int = 8) -> dict:
    """The LBVH build in numpy (nart_tpu/accel.py _build_bvh_py): a dict of
    node_lo, node_hi, order (int32), tri_v, n_leaves, leaf_size, depth."""
    tri_v = np.asarray(tri_v, np.float32)
    t = len(tri_v)
    lo = tri_v.min(axis=1)  # (T, 3)
    hi = tri_v.max(axis=1)
    centroid = 0.5 * (lo + hi)
    scene_lo = lo.min(axis=0)
    scene_hi = hi.max(axis=0)
    extent = np.maximum(scene_hi - scene_lo, 1e-12)
    unit = (centroid - scene_lo) / extent
    codes = morton3(unit[:, 0], unit[:, 1], unit[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_leaves = 1 << max(
        0, int(np.ceil(np.log2(max(1, (t + leaf_size - 1) // leaf_size)))))
    t_pad = n_leaves * leaf_size
    order_p = np.full(t_pad, -1, np.int32)
    order_p[:t] = order
    tv = np.zeros((t_pad, 3, 3), np.float32)
    tv[:t] = tri_v[order]
    # padding triangles: degenerate, AABB collapsed to +inf so they never hit
    lo_p = np.full((t_pad, 3), INF, np.float32)
    hi_p = np.full((t_pad, 3), -INF, np.float32)
    lo_p[:t] = lo[order]
    hi_p[:t] = hi[order]

    n_nodes = 2 * n_leaves - 1
    node_lo = np.full((n_nodes, 3), INF, np.float32)
    node_hi = np.full((n_nodes, 3), -INF, np.float32)
    leaf0 = n_leaves - 1
    node_lo[leaf0:] = lo_p.reshape(n_leaves, leaf_size, 3).min(axis=1)
    node_hi[leaf0:] = hi_p.reshape(n_leaves, leaf_size, 3).max(axis=1)
    for i in range(leaf0 - 1, -1, -1):
        node_lo[i] = np.minimum(node_lo[2 * i + 1], node_lo[2 * i + 2])
        node_hi[i] = np.maximum(node_hi[2 * i + 1], node_hi[2 * i + 2])
    return dict(node_lo=node_lo, node_hi=node_hi, order=order_p, tri_v=tv,
                n_leaves=n_leaves, leaf_size=leaf_size,
                depth=int(np.log2(n_leaves)))


def build_bvh(tri_v, leaf_size: int = 8) -> BVH:
    """The LBVH of a (T, 3, 3) triangle soup, as CPU tensors."""
    a = build_bvh_arrays(np.asarray(tri_v), leaf_size)
    return BVH(node_lo=torch.from_numpy(a["node_lo"]),
               node_hi=torch.from_numpy(a["node_hi"]),
               order=torch.from_numpy(a["order"]).long(),
               tri_v=torch.from_numpy(a["tri_v"]),
               n_leaves=a["n_leaves"], leaf_size=a["leaf_size"],
               depth=a["depth"])


def _slab_test(o, inv_d, t_min, t_max, lo, hi):
    """Ray-AABB slab test of (N, 3) boxes: (hit, t_entry)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_enter = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
    t_exit = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max)
    return t_enter <= t_exit, t_enter


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _intersect_gathered(o, d, shear, t_min, t_best, tv):
    """Watertight test of each ray against its own (K, 3, 3) triangles
    (N, K, 3, 3): geometry.watertight's math, lowest index on ties.
    Returns (t, idx (-1 when none), u, v), all (N,)."""
    v0, v1, v2 = tv[:, :, 0], tv[:, :, 1], tv[:, :, 2]  # (N, K, 3)
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    t = ((v0 * n).sum(-1) - _dot3(o[:, None, :], n)) / _dot3(d[:, None, :], n)
    in_range = (t > t_min[:, None]) & (t < t_best[:, None])

    p = tv - o[:, None, None, :]
    p = p.gather(-1, shear.perm[:, None, None, :].expand(p.shape))
    px = p[..., 0] + p[..., 2] * shear.sx[:, None, None]
    py = p[..., 1] + p[..., 2] * shear.sy[:, None, None]
    e0 = edge_fn(px[..., 1], py[..., 1], px[..., 2], py[..., 2])
    e1 = edge_fn(px[..., 2], py[..., 2], px[..., 0], py[..., 0])
    e2 = edge_fn(px[..., 0], py[..., 0], px[..., 1], py[..., 1])
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    hit = in_range & ~(neg & pos) & (e0.abs() + e1.abs() + e2.abs() != 0.0)

    t_hit = torch.where(hit, t, INF)
    best = torch.argmin(t_hit, dim=-1, keepdim=True)  # first minimum
    t_sel = t_hit.gather(1, best)[:, 0]
    inv_det = 1.0 / (e0 + e1 + e2).gather(1, best)[:, 0]
    u = e0.gather(1, best)[:, 0] * inv_det
    v = e1.gather(1, best)[:, 0] * inv_det
    idx = torch.where(torch.isfinite(t_sel), best[:, 0], -1)
    return t_sel, idx, u, v


def intersect_bvh(o, d, t_min, t_max, bvh: BVH) -> Hit:
    """Nearest hit with t_min < t < t_max for a ray wavefront: the lockstep
    masked walk of nart_tpu/accel.py intersect_bvh.  Returns a Hit with
    triangle ids in the original soup numbering."""
    n = o.shape[0]
    dev = o.device
    shear = ray_shear(d)
    # guard axis-aligned rays: 0*inf NaNs in the slab test would poison it
    inv_d = 1.0 / torch.where(d == 0.0, float(np.float32(1e-30)), d)
    stack_depth = bvh.depth + 2
    leaf0 = bvh.n_leaves - 1
    last_node = 2 * bvh.n_leaves - 2
    t_min = t_min.expand(n)

    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # root in slot 0
    t_best = t_max.expand(n).to(torch.float32).clone()
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bvh.leaf_size, device=dev)

    def push(stack, sp, mask, node):
        """stack[r, sp[r]] = node[r] and sp[r] += 1 on rows where mask."""
        slot = torch.where(mask, sp, stack_depth - 1)
        keep = stack[rows, stack_depth - 1]
        stack = stack.scatter(1, slot[:, None],
                              torch.where(mask, node, keep)[:, None])
        return stack, sp + mask.to(torch.int64)

    while bool((sp > 0).any()):
        live = sp > 0
        node = torch.where(live, stack[rows, (sp - 1).clamp(min=0)], 0)
        sp = torch.where(live, sp - 1, sp)
        box_hit, _ = _slab_test(o, inv_d, t_min, t_best, bvh.node_lo[node],
                                bvh.node_hi[node])
        box_hit = box_hit & live
        is_leaf = node >= leaf0

        # leaf: the leaf's triangles
        do_tri = box_hit & is_leaf
        base = (node - leaf0).clamp(min=0) * bvh.leaf_size
        tv = bvh.tri_v[base[:, None] + lanes[None, :]]  # (N, K, 3, 3)
        t, idx, uu, vv = _intersect_gathered(
            o, d, shear, t_min, torch.where(do_tri, t_best, -INF), tv)
        better = do_tri & (idx >= 0) & (t < t_best)
        t_best = torch.where(better, t, t_best)
        tri_best = torch.where(better, bvh.order[base + idx.clamp(min=0)],
                               tri_best)
        u_best = torch.where(better, uu, u_best)
        v_best = torch.where(better, vv, v_best)

        # internal node: push the children, nearest popped first
        inner = box_hit & ~is_leaf
        c1 = (2 * node + 1).clamp(max=last_node)
        c2 = (2 * node + 2).clamp(max=last_node)
        h1, e1 = _slab_test(o, inv_d, t_min, t_best, bvh.node_lo[c1],
                            bvh.node_hi[c1])
        h2, e2 = _slab_test(o, inv_d, t_min, t_best, bvh.node_lo[c2],
                            bvh.node_hi[c2])
        swap = e2 < e1  # push the far child first
        first = torch.where(swap, c2, c1)
        second = torch.where(swap, c1, c2)
        h_first = torch.where(swap, h2, h1)
        h_second = torch.where(swap, h1, h2)
        stack, sp = push(stack, sp, inner & h_first & h_second, first)
        stack, sp = push(stack, sp, inner & (h_first | h_second),
                         torch.where(h_second, second, first))

    t = torch.where(tri_best >= 0, t_best, INF)
    return Hit(t=t, tri=tri_best, u=u_best, v=v_best)
