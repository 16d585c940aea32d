"""Two-level triangle clusters with closest-hit and any-hit traversal.

Counterpart of ``nart_tpu/pallas_accel.py`` (and of ``nart_tpu/accel.py``'s
``resolve_accel_kind``/``build_accel`` policy).  The cluster build is the
same numpy code, so both packages produce identical arrays: triangles are
ordered (Morton order below 32k triangles, recursive median split from
32k up) into clusters of ``csize`` (128 / 64), stored as 13 coordinate
planes (v0 v1 v2 corners, unnormalised normal n, v0.n), grouped into
superclusters of ``sc_size`` consecutive clusters, with a per-direction-
octant member visit order.

Each query dispatches on the device of its tensors:
  * CUDA tensors launch the hand-written Hopper kernels in
    csrc/cluster_hit.cu (``nart_closest_hit`` replaces ``_kernel``,
    ``nart_any_hit`` replaces ``_kernel_any``, ``nart_closest_hit_stats``
    replaces tools/kernel_stats.py's ``_kernel_stats``: the closest-hit
    walk with visit counters; ``nart_any_hit_stats`` is the same
    instrument on the any-hit walk; both are dispatched by
    kernel_stats.traversal_stats) and count the launch in
    ``cuda_build.launch_counts`` (inside a CUDA graph capture, at every
    replay of the graph: see ``cuda_build.captured_launches``);
  * CPU tensors run the plain versions below: a chunked watertight brute
    force over the planes with the same tie rule (lowest row wins within a
    cluster; a strictly closer hit replaces the running best).
There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

The TPU design's ray blocks, XLA block prefilter (``build_block_lists``)
and 128-lane gates have no counterpart: every ray keeps its own walk, and
the 32 rays of a warp test each cluster together (the warp loads a cluster
once, and all its lanes share out the triangles of each ray that wants it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from . import cuda_build
from .geometry import Hit, RayShear, _select_nearest, ray_shear, watertight
from .scene import _to_device

INF = np.float32(np.inf)
CLUSTER = 128  # triangles per cluster below LARGE_MESH
CLUSTER_LARGE = 64  # triangles per cluster from LARGE_MESH up
SUPER_TARGET = 128  # supercluster count target below LARGE_MESH
SUPER_TARGET_LARGE = 256
LARGE_MESH = 32768  # triangle count where the large-mesh policy starts
WARP = 32  # rays of consecutive index that share a warp in the kernels

@dataclass
class ClusterAccel:
    """Two-level spatially ordered triangle clusters (tensors)."""

    planes: Any  # (13, n_clusters, csize) f32: v0xyz v1xyz v2xyz nxyz v0n
    order: Any  # (n_clusters * csize,) int32 original tri id (-1 padding)
    aabb: Any  # (6, n_clusters) f32: lo xyz, hi xyz
    sc_aabb: Any  # (6, n_sc) f32: supercluster boxes
    morder: Any  # (8, n_clusters) int32 per-octant member visit order
    cl_lo: Any  # (n_clusters, 3)
    cl_hi: Any  # (n_clusters, 3)
    n_clusters: int
    n_tris: int
    n_sc: int
    sc_size: int
    csize: int

    def to(self, device):
        return _to_device(self, device)


def _expand_bits(v):
    """Spread 10 bits over 30 (every third position)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(x, y, z):
    """30-bit Morton code from [0,1)^3 coordinates (uint32 numpy)."""

    def q(a):
        return np.clip((a * 1024.0), 0, 1023).astype(np.uint32)

    return (_expand_bits(q(x)) << 2) | (_expand_bits(q(y)) << 1) \
        | _expand_bits(q(z))


def _median_split_order(centroid: np.ndarray, csize: int) -> np.ndarray:
    """Recursive largest-axis median split; returns a triangle order whose
    consecutive runs of csize triangles are disjoint half-spaces."""
    n = centroid.shape[0]
    order = np.empty(n, np.int32)
    pos = 0
    stack = [np.arange(n, dtype=np.int32)]
    while stack:
        idx = stack.pop()
        if len(idx) <= csize:
            order[pos:pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = centroid[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # split at a cluster-size multiple: every leaf but the last is full
        half = ((len(idx) // 2 + csize - 1) // csize) * csize
        part = np.argpartition(c[:, ax], min(half, len(idx) - 1))
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    return order


def build_clusters(tri_v, super_target=None, csize=None,
                   method=None) -> ClusterAccel:
    """Cluster build (pallas_accel.build_clusters).  Size policy: below
    LARGE_MESH triangles, 128-triangle clusters in Morton order with a
    supercluster target of 128; from LARGE_MESH up, 64-triangle clusters by
    median split with a target of 256.  Explicit arguments override."""
    tri_v = np.asarray(tri_v, np.float32)
    t = len(tri_v)
    large = t >= LARGE_MESH
    if super_target is None:
        super_target = SUPER_TARGET_LARGE if large else SUPER_TARGET
    if csize is None:
        csize = CLUSTER_LARGE if large else CLUSTER
    if method is None:
        method = "median" if large else "morton"
    lo = tri_v.min(axis=1)
    hi = tri_v.max(axis=1)
    centroid = 0.5 * (lo + hi)
    scene_lo = lo.min(axis=0)
    extent = np.maximum(hi.max(axis=0) - scene_lo, 1e-12)
    if method == "median":
        order = _median_split_order(centroid, csize)
    elif method == "morton":
        codes = morton3(*((centroid - scene_lo) / extent).T)
        order = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        raise ValueError(f"unknown cluster method {method!r}")

    n_cl = max(1, -(-t // csize))
    sc_size = max(1, -(-n_cl // super_target))
    n_cl = -(-n_cl // sc_size) * sc_size  # pad to a whole supercluster grid
    n_sc = n_cl // sc_size
    t_pad = n_cl * csize
    order_p = np.full(t_pad, -1, np.int32)
    order_p[:t] = order
    tv = np.zeros((t_pad, 3, 3), np.float32)
    tv[:t] = tri_v[order]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    v0n = np.sum(tv[:, 0] * n, axis=-1)
    planes = np.stack(
        [
            tv[:, 0, 0], tv[:, 0, 1], tv[:, 0, 2],
            tv[:, 1, 0], tv[:, 1, 1], tv[:, 1, 2],
            tv[:, 2, 0], tv[:, 2, 1], tv[:, 2, 2],
            n[:, 0], n[:, 1], n[:, 2],
            v0n,
        ]
    ).reshape(13, n_cl, csize)

    lo_p = np.full((t_pad, 3), INF, np.float32)
    hi_p = np.full((t_pad, 3), -INF, np.float32)
    lo_p[:t] = lo[order]
    hi_p[:t] = hi[order]
    cl_lo = lo_p.reshape(n_cl, csize, 3).min(axis=1)
    cl_hi = hi_p.reshape(n_cl, csize, 3).max(axis=1)
    # empty (all-padding) clusters keep (+inf, -inf) bounds: every slab
    # test rejects them, and their zeroed planes cannot hit
    sc_lo = cl_lo.reshape(n_sc, sc_size, 3).min(axis=1)
    sc_hi = cl_hi.reshape(n_sc, sc_size, 3).max(axis=1)
    # per-octant member visit order: ascending projection of the cluster
    # centroid on the octant diagonal (±1, ±1, ±1); empty clusters last
    morder = np.zeros((8, n_sc, sc_size), np.int32)
    base = np.arange(n_cl, dtype=np.int32).reshape(n_sc, sc_size)
    with np.errstate(invalid="ignore"):
        cl_cent = 0.5 * (cl_lo + cl_hi)
        for o in range(8):
            sgn = np.array(
                [1.0 if o & 4 else -1.0,
                 1.0 if o & 2 else -1.0,
                 1.0 if o & 1 else -1.0], np.float32)
            proj = cl_cent @ sgn
            proj = np.where(np.isfinite(proj), proj, np.float32(np.inf))
            rank = np.argsort(proj.reshape(n_sc, sc_size), axis=1,
                              kind="stable")
            morder[o] = np.take_along_axis(base, rank, axis=1)
    return accel_from_numpy(dict(
        planes=planes, order=order_p,
        aabb=np.concatenate([cl_lo.T, cl_hi.T], axis=0),
        sc_aabb=np.concatenate([sc_lo.T, sc_hi.T], axis=0),
        morder=morder.reshape(8, n_cl), cl_lo=cl_lo, cl_hi=cl_hi,
        n_clusters=n_cl, n_tris=t, n_sc=n_sc, sc_size=sc_size, csize=csize,
    ))


def accel_from_numpy(d: dict) -> ClusterAccel:
    """ClusterAccel from a dict of numpy arrays with its field names (for
    example the arrays of a JAX-package ClusterAccel); extra keys are
    ignored."""
    # C-order copies: the kernels take contiguous rows, and the source may
    # be a read-only view (a JAX array's)
    def f32(k):
        return torch.from_numpy(np.array(d[k], np.float32, order="C"))

    def i32(k):
        return torch.from_numpy(np.array(d[k], np.int32, order="C"))

    return ClusterAccel(
        planes=f32("planes"), order=i32("order"), aabb=f32("aabb"),
        sc_aabb=f32("sc_aabb"), morder=i32("morder"), cl_lo=f32("cl_lo"),
        cl_hi=f32("cl_hi"), n_clusters=int(d["n_clusters"]),
        n_tris=int(d["n_tris"]), n_sc=int(d["n_sc"]),
        sc_size=int(d["sc_size"]), csize=int(d["csize"]),
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

_CHUNK_ELEMS = 1 << 22  # (rays x triangles) elements per chunk


def _plane_chunks(accel, n_rays):
    flat = accel.planes.reshape(13, -1)
    step = max(1, _CHUNK_ELEMS // max(n_rays, 1))
    for base in range(0, flat.shape[1], step):
        pl = flat[:, base : base + step]
        yield base, pl[0:3].T, pl[3:6].T, pl[6:9].T, pl[9:12].T, pl[12]


def closest_hit_plain(o, d, t_min, t_max, accel: ClusterAccel) -> Hit:
    """Nearest watertight hit with t_min < t < t_max over every cluster row
    (the reference of nart_closest_hit).  Returns original triangle ids."""
    n = o.shape[0]
    shear = ray_shear(d)
    t_best = t_max.clone()
    row = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    u_best = torch.zeros(n, device=o.device)
    v_best = torch.zeros(n, device=o.device)
    for base, v0, v1, v2, nrm, v0n in _plane_chunks(accel, n):
        hit, t, e0, e1, esum = watertight(o, d, shear, v0, v1, v2, nrm, v0n)
        hit = hit & (t > t_min[:, None]) & (t < t_best[:, None])
        t_sel, idx, u, v = _select_nearest(hit, t, e0, e1, esum)
        better = t_sel < t_best
        t_best = torch.where(better, t_sel, t_best)
        row = torch.where(better, base + idx, row)
        u_best = torch.where(better, u, u_best)
        v_best = torch.where(better, v, v_best)
    tri = torch.where(row >= 0, accel.order[row.clamp(min=0)].to(torch.int64),
                      row)
    t = torch.where(tri >= 0, t_best, torch.full_like(t_best, INF))
    return Hit(t=t, tri=tri, u=u_best, v=v_best)


def any_hit_plain(o, d, t_min, t_max, accel: ClusterAccel):
    """Any watertight hit with t_min < t < t_max (the reference of
    nart_any_hit); lanes with t_max <= 0 are never occluded."""
    n = o.shape[0]
    shear = ray_shear(d)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    for _, v0, v1, v2, nrm, v0n in _plane_chunks(accel, n):
        hit, t, _, _, _ = watertight(o, d, shear, v0, v1, v2, nrm, v0n)
        hit = hit & (t > t_min[:, None]) & (t < t_max[:, None])
        occ = occ | hit.any(dim=1)
    return occ & (t_max > 0.0)


class TraversalStats(NamedTuple):
    """What the closest-hit walk did for each ray (all (N,))."""

    t: torch.Tensor  # f32 nearest hit distance (inf on a miss), K1's t
    visited: torch.Tensor  # int32 superclusters whose slab test passed
    slabs: torch.Tensor  # int32 member steps taken (a slab test each)
    tested: torch.Tensor  # int32 clusters whose triangles were tested
    # int32, summed over the ray's tested clusters: the rays of its warp (32
    # consecutive rays) that tested the same cluster at the same member
    # step, itself included -- the group that shares one load of the
    # cluster in the kernels.  Over `tested` it is the mean group size.
    together: torch.Tensor
    sc_tests: torch.Tensor  # int32 supercluster slab tests made: n_sc


class AnyHitStats(NamedTuple):
    """What the any-hit walk did for each ray: TraversalStats' counters up
    to the ray's first cluster with a hit (all zero where t_max <= 0);
    sc_tests counts the superclusters met before the ray was occluded."""

    occluded: torch.Tensor  # bool, K2's result
    visited: torch.Tensor
    slabs: torch.Tensor
    tested: torch.Tensor
    together: torch.Tensor
    sc_tests: torch.Tensor


def _slab(box, c, o, inv, t_lo, t_hi):
    """cluster_hit.cu's slab(): rays against box column c of a (6, n) lo/hi
    table, window (t_lo, t_hi)."""
    a0 = (box[0:3, c] - o) * inv
    a1 = (box[3:6, c] - o) * inv
    near = torch.minimum(a0, a1).max(dim=-1).values
    far = torch.maximum(a0, a1).min(dim=-1).values
    return torch.maximum(near, t_lo) <= torch.minimum(far, t_hi)


def _walk_plain(o, d, t_min, t_max, accel: ClusterAccel, any_hit: bool):
    """The kernels' walk, vectorised over rays: superclusters in index order
    behind a slab test against (t_min, t_best), members in the ray's octant
    order (morder) behind their own slab test, then the cluster's
    triangles.  Closest-hit: t_best runs per ray.  Any-hit: a ray with
    t_max <= 0 never starts and a ray leaves at its first cluster with a
    hit.  Returns (t_best, found, visited, slabs, tested, together,
    sc_tests)."""
    n = o.shape[0]
    dev = o.device
    shear = ray_shear(d)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    octant = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
              + (d[:, 2] > 0).long())
    groups = [torch.nonzero(octant == k)[:, 0] for k in range(8)]
    morder = accel.morder.cpu().numpy()
    t_best = t_max.clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    if any_hit:
        alive = t_max > 0.0
    else:
        alive = torch.ones(n, dtype=torch.bool, device=dev)
    visited, slabs, tested, together, sc_tests = (
        torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(5))
    warp = WARP
    n_warps = -(-n // warp)
    for sc in range(accel.n_sc):
        sc_tests += alive
        live_sc = alive & _slab(accel.sc_aabb, sc, o, inv, t_min, t_best)
        visited += live_sc
        for j in range(accel.sc_size):
            in_sc = live_sc & alive
            slabs += in_sc
            # which member of this supercluster each ray tests at step j
            want = torch.zeros((n_warps * warp, accel.sc_size),
                               dtype=torch.bool, device=dev)
            for k, rays in enumerate(groups):
                if rays.numel() == 0:
                    continue
                c = int(morder[k, sc * accel.sc_size + j])
                og, dg = o[rays], d[rays]
                sg = RayShear(*(x[rays] for x in shear))
                tb = t_best[rays]
                live = in_sc[rays] & _slab(accel.aabb, c, og, inv[rays],
                                           t_min[rays], tb)
                pl = accel.planes[:, c, :]
                hit, t, _, _, _ = watertight(og, dg, sg, pl[0:3].T, pl[3:6].T,
                                             pl[6:9].T, pl[9:12].T, pl[12])
                hit = (hit & live[:, None] & (t > t_min[rays, None])
                       & (t < tb[:, None]))
                hit_any = hit.any(dim=1)
                found[rays] |= hit_any
                if any_hit:
                    alive[rays] &= ~hit_any
                else:
                    t_sel = torch.where(hit, t, INF).min(dim=1).values
                    t_best[rays] = torch.minimum(tb, t_sel)
                want[rays, c - sc * accel.sc_size] = live
            tested += want[:n].sum(1, dtype=torch.int32)
            by_warp = want.reshape(n_warps, warp, -1)
            lanes = by_warp.sum(1, keepdim=True, dtype=torch.int32)
            together += (by_warp * lanes).reshape(n_warps * warp, -1)[:n].sum(
                1, dtype=torch.int32)
    return t_best, found, visited, slabs, tested, together, sc_tests


def closest_hit_stats_plain(o, d, t_min, t_max,
                            accel: ClusterAccel) -> TraversalStats:
    """The walk of nart_closest_hit_stats (see _walk_plain).  The five
    counters equal the kernel's exactly and t equals closest_hit_plain's."""
    t_best, found, *counters = _walk_plain(o, d, t_min, t_max, accel, False)
    t = torch.where(found, t_best, torch.full_like(t_best, INF))
    return TraversalStats(t, *counters)


def any_hit_stats_plain(o, d, t_min, t_max, accel: ClusterAccel) -> AnyHitStats:
    """The walk of nart_any_hit_stats (see _walk_plain).  The five counters
    equal the kernel's exactly and `occluded` equals any_hit_plain's."""
    _, found, *counters = _walk_plain(o, d, t_min, t_max, accel, True)
    return AnyHitStats(found, *counters)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_lib():
    lib = cuda_build.load("cluster_hit")
    if lib.nart_closest_hit.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nart_closest_hit.argtypes = [p, p, p, p, i, p, p, p, p, p,
                                         i, i, i, i, p, p, p, p, p]
        lib.nart_closest_hit.restype = ctypes.c_int
        lib.nart_any_hit.argtypes = [p, p, p, p, i, p, p, p, p,
                                     i, i, i, i, p, p]
        lib.nart_any_hit.restype = ctypes.c_int
        for fn in (lib.nart_closest_hit_stats, lib.nart_any_hit_stats):
            fn.argtypes = [p, p, p, p, i, p, p, p, p,
                           i, i, i, i, p, p, p, p, p, p, p]
            fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {x.dtype})")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(x.shape)})")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(o, d, t_min, t_max, accel):
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,))):
        _check(name, x, torch.float32, shape)
    nc, cs = accel.n_clusters, accel.csize
    _check("planes", accel.planes, torch.float32, (13, nc, cs))
    _check("aabb", accel.aabb, torch.float32, (6, nc))
    _check("sc_aabb", accel.sc_aabb, torch.float32, (6, accel.n_sc))
    _check("morder", accel.morder, torch.int32, (8, nc))
    _check("order", accel.order, torch.int32, (nc * cs,))
    for x in (d, accel.planes):
        if x.device != o.device:
            raise ValueError("rays and accel must be on one device")
    return n


def closest_hit_cuda(o, d, t_min, t_max, accel: ClusterAccel) -> Hit:
    """Launch nart_closest_hit on CUDA tensors (a warp per 32 rays)."""
    n = _check_args(o, d, t_min, t_max, accel)
    lib = _kernel_lib()
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int64, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    rc = lib.nart_closest_hit(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        accel.planes.data_ptr(), accel.aabb.data_ptr(),
        accel.sc_aabb.data_ptr(), accel.morder.data_ptr(),
        accel.order.data_ptr(), accel.n_clusters, accel.n_sc, accel.sc_size,
        accel.csize, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"nart_closest_hit launch failed: CUDA error {rc}")
    cuda_build.count_launch("closest_hit")
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit_cuda(o, d, t_min, t_max, accel: ClusterAccel):
    """Launch nart_any_hit on CUDA tensors; returns (N,) bool."""
    n = _check_args(o, d, t_min, t_max, accel)
    lib = _kernel_lib()
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    rc = lib.nart_any_hit(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        accel.planes.data_ptr(), accel.aabb.data_ptr(),
        accel.sc_aabb.data_ptr(), accel.morder.data_ptr(), accel.n_clusters,
        accel.n_sc, accel.sc_size, accel.csize, occ.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"nart_any_hit launch failed: CUDA error {rc}")
    cuda_build.count_launch("any_hit")
    return occ


def _stats_cuda(name, hit_dtype, o, d, t_min, t_max, accel):
    """Launch counter entry nart_<name>; returns its hit output (t or
    occlusion) and the five counters."""
    n = _check_args(o, d, t_min, t_max, accel)
    lib = _kernel_lib()
    hit = torch.empty(n, dtype=hit_dtype, device=o.device)
    counters = [torch.empty(n, dtype=torch.int32, device=o.device)
                for _ in range(5)]
    rc = getattr(lib, "nart_" + name)(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        accel.planes.data_ptr(), accel.aabb.data_ptr(),
        accel.sc_aabb.data_ptr(), accel.morder.data_ptr(), accel.n_clusters,
        accel.n_sc, accel.sc_size, accel.csize, hit.data_ptr(),
        *(c.data_ptr() for c in counters),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"nart_{name} launch failed: CUDA error {rc}")
    cuda_build.count_launch(name)
    return hit, counters


def closest_hit_stats_cuda(o, d, t_min, t_max,
                           accel: ClusterAccel) -> TraversalStats:
    """Launch nart_closest_hit_stats on CUDA tensors."""
    t, counters = _stats_cuda("closest_hit_stats", torch.float32, o, d, t_min,
                              t_max, accel)
    return TraversalStats(t, *counters)


def any_hit_stats_cuda(o, d, t_min, t_max, accel: ClusterAccel) -> AnyHitStats:
    """Launch nart_any_hit_stats on CUDA tensors."""
    occ, counters = _stats_cuda("any_hit_stats", torch.bool, o, d, t_min,
                                t_max, accel)
    return AnyHitStats(occ, *counters)


def intersect_clusters(o, d, t_min, t_max, accel: ClusterAccel) -> Hit:
    """Nearest hit over the clustered scene (original triangle ids)."""
    if o.device.type == "cuda":
        return closest_hit_cuda(o, d, t_min, t_max, accel)
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, t_min, t_max, accel)
    raise ValueError(f"no closest-hit path for device {o.device}")


def intersect_clusters_any(o, d, t_min, t_max, accel: ClusterAccel):
    """Occlusion query: any hit with t in (t_min, t_max)?  Equal to
    ``intersect_clusters(...).tri >= 0`` on lanes with t_max > 0."""
    if o.device.type == "cuda":
        return any_hit_cuda(o, d, t_min, t_max, accel)
    if o.device.type == "cpu":
        return any_hit_plain(o, d, t_min, t_max, accel)
    raise ValueError(f"no any-hit path for device {o.device}")


# ---------------------------------------------------------------------------
# Accel-kind policy (accel.py)
# ---------------------------------------------------------------------------

ACCEL_KINDS = ("auto", "brute", "bvh", "cluster")


def resolve_accel_kind(kind: str) -> str:
    """'auto' -> 'cluster' (the kernels on CUDA, their plain versions on
    the CPU), and so does 'pallas', the JAX package's name for the cluster
    kernels (in a session JSON, RenderParams or the CLI alike); 'brute' is
    the plain geometry.intersect_brute scan, 'bvh' the plain lockstep LBVH
    walk (bvh.py)."""
    if kind in ("auto", "pallas"):
        return "cluster"
    if kind not in ACCEL_KINDS:
        raise ValueError(f"accel must be one of {ACCEL_KINDS} or 'pallas' "
                         f"(got {kind!r})")
    return kind


def build_accel(tri_v, kind: str):
    """The acceleration structure of a resolved kind (None for brute)."""
    kind = resolve_accel_kind(kind)
    if kind == "cluster":
        return build_clusters(np.asarray(tri_v))
    if kind == "bvh":
        from .bvh import build_bvh

        return build_bvh(np.asarray(tri_v))
    return None
