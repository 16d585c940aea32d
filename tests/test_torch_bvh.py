"""The LBVH accel of nart_tpu_torch (bvh.py, the "bvh" kind) vs nart_tpu,
on the CPU.

The build is the JAX package's numpy build: every array equals what
``nart_tpu.accel.build_bvh`` returns.  The lockstep walk takes the port's
watertight arithmetic, so its Hit equals ``geometry.intersect_brute``'s
exactly; against the JAX walk the triangle ids are equal, t within rtol
1e-5 / atol 1e-6 and u/v within rtol 1e-4 / atol 1e-5 (XLA reassociates
the dot products and may contract the edge functions of the gathered
triangles; the barycentrics divide by the edge sum, which grazing hits
make small).
A "bvh" render is held to the "cluster" render of the same session by
tests/test_golden.py's _compare criteria (the traversals differ only on
shared-edge ties).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import accel as jaccel
from nart_tpu import testing as jtesting
from nart_tpu_torch import bvh as tbvh
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import geometry as tgeo
from nart_tpu_torch import render as trender
from nart_tpu_torch import testing as ttesting
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_render import _compare


def _soup(n_tris, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_tris, 3, 3)) * 0.3
            + rng.normal(size=(n_tris, 1, 3)) * 2.0).astype(np.float32)


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # a fifth of the rays with a short window; a few axis-aligned ones
    d[:8] = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    t_max = np.where(rng.random(n) < 0.2, 0.5, np.inf).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("tris,leaf", [
    (lambda: _soup(300), 8),
    (lambda: _soup(5), 8),
    (lambda: np.asarray(jtesting.simple_scene(("lambert",)).tri_v), 4),
], ids=["soup300", "soup5", "simple"])
def test_build_matches_jax(tris, leaf):
    t = tris()
    jb = jaccel.build_bvh(t, leaf_size=leaf)
    tb = tbvh.build_bvh(t, leaf_size=leaf)
    for k in ("node_lo", "node_hi", "order", "tri_v"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert (tb.n_leaves, tb.leaf_size, tb.depth) == (
        jb.n_leaves, jb.leaf_size, jb.depth)


def test_walk_matches_jax_and_brute():
    tri = _soup(300)
    o, d, t_max = _rays(2000)
    n = o.shape[0]
    hit = tbvh.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d),
                             torch.zeros(n), torch.from_numpy(t_max),
                             tbvh.build_bvh(tri))
    brute = tgeo.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.zeros(n), torch.from_numpy(t_max),
                                 torch.from_numpy(tri))
    assert 50 < int((hit.tri >= 0).sum()) < n
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(hit, k), getattr(brute, k)), k
    hj = jaccel.intersect_bvh(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n),
                              jnp.asarray(t_max), jaccel.build_bvh(tri))
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(hj.tri))
    for k, rtol, atol in (("t", 1e-5, 1e-6), ("u", 1e-4, 1e-5),
                          ("v", 1e-4, 1e-5)):
        np.testing.assert_allclose(getattr(hit, k).numpy(),
                                   np.asarray(getattr(hj, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_bvh_film_matches_cluster_film():
    """simple_scene (plastic and lambert, roughened) at 16x16, 2 spp: the
    "bvh" image against the "cluster" image by _compare's tight and golden
    criteria; the walk answers the occlusion queries with the closest
    hit's validity (no K1/K2 launch on any device)."""
    sc = ttesting.simple_scene(("plastic", "lambert"), roughness=0.4)
    base = trender.RenderParams(image_width=16, image_height=16, spp=2,
                                bounces=5, roughening_factor=0.3)
    img = {}
    for kind in ("bvh", "cluster"):
        sess = trender.RenderSession(
            sc, dataclasses.replace(base, accel=kind), "cpu")
        img[kind] = sess.image().numpy()
        assert np.isfinite(img[kind]).all()
    assert isinstance(trender.RenderSession(
        sc, dataclasses.replace(base, accel="bvh"), "cpu").accel, tbvh.BVH)
    _compare(img["bvh"], img["cluster"], mean_tol=1e-3, block_tol=0.01,
             block_frac=0.95)
    _compare(img["bvh"], img["cluster"], mean_tol=0.03, block_tol=0.12,
             block_frac=0.95)


def test_bvh_kind_policy():
    assert tca.resolve_accel_kind("bvh") == "bvh"
    acc = tca.build_accel(_soup(40), "bvh")
    assert isinstance(acc, tbvh.BVH) and acc.order.dtype == torch.int64
    moved = acc.to("cpu")
    assert moved.n_leaves == acc.n_leaves and moved.depth == acc.depth


def test_plain_walk_counts_its_work():
    """intersect_bvh_plain's counters (the work the bound of the walk's
    kernel charges): the same Hit with and without them, at least one node
    popped a ray, and the nodes that passed split into inner nodes and
    leaves; intersect_bvh on CPU tensors is the plain walk."""
    tri = _soup(300)
    o, d, t_max = (torch.from_numpy(x) for x in _rays(500))
    tree = tbvh.build_bvh(tri)
    counts = {}
    hit = tbvh.intersect_bvh_plain(o, d, torch.zeros(500), t_max, tree,
                                   counts=counts)
    plain = tbvh.intersect_bvh(o, d, torch.zeros(500), t_max, tree)
    assert all(torch.equal(a, b) for a, b in zip(hit, plain))
    assert counts["nodes"] >= 500
    assert counts["nodes"] > counts["inner"] + counts["leaves"]
    assert counts["inner"] > 0 and counts["leaves"] > 0


def test_kernel_wrapper_refuses_before_any_launch():
    """A tree deeper than the kernel's stack (bvh.MAX_DEPTH) is refused
    before anything else; CPU tensors never reach the kernel; another
    device type has no walk."""
    tree = tbvh.build_bvh(_soup(40))
    o, d, t_max = (torch.from_numpy(x) for x in _rays(64))
    t_min = torch.zeros(64)
    with pytest.raises(ValueError, match="depth"):
        tbvh.bvh_hit_cuda(o, d, t_min, t_max,
                          dataclasses.replace(tree, depth=tbvh.MAX_DEPTH + 1))
    with pytest.raises(ValueError, match="CUDA"):
        tbvh.bvh_any_cuda(o, d, t_min, t_max, tree)
    with pytest.raises(ValueError):
        tbvh.occluded_bvh(o.to("meta"), d.to("meta"), t_min.to("meta"),
                          t_max.to("meta"), tree)


# ---------------------------------------------------------------------------
# B1's packed layout, and scalar models of its walk (csrc/bvh_walk.cu)
# ---------------------------------------------------------------------------

F = np.float32
INF32 = F(np.inf)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("tris,leaf", [
    (lambda: _soup(300), 8),
    (lambda: _soup(5), 8),
    (lambda: np.asarray(jtesting.simple_scene(("lambert",)).tri_v), 4),
], ids=["soup300", "soup5", "simple"])
def test_packed_layout(tris, leaf):
    """node_pairs and tri_rec unpack to node_lo, node_hi and tri_v bit for
    bit; tri_rec's normal is (v1 - v0) x (v2 - v0) rounded one float32
    operation at a time in the kernel's order (torch's eager CPU ops, each
    product rounded, then their difference); padding rows are zeros."""
    tree = tbvh.build_bvh(tris(), leaf_size=leaf)
    lo, hi = tree.node_lo.numpy(), tree.node_hi.numpy()
    pairs, rec = tree.node_pairs.numpy(), tree.tri_rec.numpy()
    inner = np.arange(tree.n_leaves - 1)
    assert pairs.shape == (tree.n_leaves - 1, 12) and pairs.dtype == F
    for k, (src, child) in enumerate([(lo, 1), (hi, 1), (lo, 2), (hi, 2)]):
        np.testing.assert_array_equal(_bits(pairs[:, 3 * k:3 * k + 3]),
                                      _bits(src[2 * inner + child]))
    tv = tree.tri_v
    np.testing.assert_array_equal(_bits(rec[:, :9]),
                                  _bits(tv.numpy().reshape(-1, 9)))
    a, b = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)
    np.testing.assert_array_equal(_bits(rec[:, 9:]), _bits(n.numpy()))
    pad = tree.order.numpy() < 0
    assert not rec[pad].any()
    moved = tree.to("cpu")
    assert moved.node_pairs.shape == pairs.shape
    assert moved.tri_rec.shape == rec.shape


def _nmin(a, b):
    return a if (a < b or a != a) else b


def _nmax(a, b):
    return a if (a > b or a != a) else b


class _Ray:
    """A ray's constants, as make_ray computes them (float32 scalars)."""

    def __init__(self, o, d, t_min):
        self.o, self.d, self.t_min = [F(x) for x in o], [F(x) for x in d], F(
            t_min)
        with np.errstate(all="ignore"):
            self.inv = [F(1.0) / (x if x != 0 else F(1e-30)) for x in self.d]
            ax, ay, az = (abs(x) for x in self.d)
            mj = (0 if ax > az else 2) if ax > ay else (1 if ay > az else 2)
            self.perm = [(mj + 1) % 3, (mj + 2) % 3, mj]
            self.op = [self.o[k] for k in self.perm]
            sz = F(1.0) / self.d[mj]
            self.sx = -self.d[self.perm[0]] * sz
            self.sy = -self.d[self.perm[1]] * sz


def _slab(lo, hi, r, t_hi):
    near = far = F(0)
    for k in range(3):
        t0 = (F(lo[k]) - r.o[k]) * r.inv[k]
        t1 = (F(hi[k]) - r.o[k]) * r.inv[k]
        a, b = _nmin(t0, t1), _nmax(t0, t1)
        near = a if k == 0 else _nmax(near, a)
        far = b if k == 0 else _nmin(far, b)
    e = _nmax(near, r.t_min)
    return e <= _nmin(far, t_hi), e


def _edge(ax, ay, bx, by):
    p1, p2 = ax * by, ay * bx
    e = p1 - p2
    return F(0) if abs(e) <= (abs(p1) + abs(p2)) * F(2.0 ** -22) else e


def _tri(v, n, r, t_hi):
    """The watertight test of v (9 floats) with plane normal n: (t, e0,
    e1, esum) on a hit, else None."""
    v0n = v[0] * n[0] + v[1] * n[1]
    v0n = v0n + v[2] * n[2]
    on = r.o[0] * n[0] + r.o[1] * n[1]
    on = on + r.o[2] * n[2]
    dn = r.d[0] * n[0] + r.d[1] * n[1]
    dn = dn + r.d[2] * n[2]
    t = (v0n - on) / dn
    if not (t > r.t_min and t < t_hi):
        return None
    px, py = [], []
    for c in range(3):
        pa = v[3 * c + r.perm[0]] - r.op[0]
        pb = v[3 * c + r.perm[1]] - r.op[1]
        pc = v[3 * c + r.perm[2]] - r.op[2]
        px.append(pa + pc * r.sx)
        py.append(pb + pc * r.sy)
    e0 = _edge(px[1], py[1], px[2], py[2])
    e1 = _edge(px[2], py[2], px[0], py[0])
    e2 = _edge(px[0], py[0], px[1], py[1])
    neg = e0 < 0 or e1 < 0 or e2 < 0
    pos = e0 > 0 or e1 > 0 or e2 > 0
    if (neg and pos) or (abs(e0) + abs(e1)) + abs(e2) == 0:
        return None
    return t, e0, e1, (e0 + e1) + e2


def _cross(v):
    a = [v[3 + k] - v[k] for k in range(3)]
    b = [v[6 + k] - v[k] for k in range(3)]
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _leaf(tree_np, node, r, t_best, normal, any_hit):
    """A leaf's triangles against (t_min, t_best): any_hit, True or None;
    else (t, row, e0, e1, esum) of the nearest, or None."""
    k = tree_np["leaf_size"]
    base = (node - (tree_np["n_leaves"] - 1)) * k
    best = None
    for j in range(base, base + k):
        v = [F(x) for x in tree_np["tri_v"][j].reshape(9)]
        h = _tri(v, normal(j, v), r, t_best)
        if h is not None and any_hit:
            return True
        if h is not None and (best is None or h[0] < best[0]):
            best = (h[0], j) + h[1:]
    return best


def _walk_reference(tree_np, r, t_max, any_hit=False):
    """The first design's kernel, step for step: pop, the node's slab test,
    a leaf's triangles with the normal computed per ray, or both children
    tested and pushed far first.  Returns (leaves tested, (t, row, e0, e1,
    esum) or None; for any_hit, a bool)."""
    lo, hi = tree_np["node_lo"], tree_np["node_hi"]
    leaf0 = tree_np["n_leaves"] - 1
    t_best, best, leaves = F(t_max), None, []
    stack = [0] if t_best > r.t_min else []
    while stack:
        node = stack.pop()
        ok, _ = _slab(lo[node], hi[node], r, t_best)
        if not ok:
            continue
        if node >= leaf0:
            leaves.append(node)
            h = _leaf(tree_np, node, r, t_best, lambda j, v: _cross(v),
                      any_hit)
            if any_hit and h:
                return leaves, True
            if h is not None and h[0] < t_best:
                t_best, best = h[0], h
            continue
        c1, c2 = 2 * node + 1, 2 * node + 2
        h1, e1 = _slab(lo[c1], hi[c1], r, t_best)
        h2, e2 = _slab(lo[c2], hi[c2], r, t_best)
        swap = e2 < e1
        first, second = (c2, c1) if swap else (c1, c2)
        hf, hs = (h2, h1) if swap else (h1, h2)
        if hf and hs:
            stack.append(first)
        if hf or hs:
            stack.append(second if hs else first)
    return leaves, (False if any_hit else best)


def _walk_redesign(tree_np, r, t_max, any_hit=False):
    """The redesigned kernel, step for step: (node, t_enter) entries, a
    pop's test t_enter <= t_best alone, the near child walked on at once
    (only the far one pushed), the root's full test, the boxes read from
    node_pairs and each triangle's normal from tri_rec, inner nodes taken
    until a leaf is met, then its triangles.  Returns what _walk_reference
    returns."""
    pairs, rec = tree_np["node_pairs"], tree_np["tri_rec"]
    leaf0 = tree_np["n_leaves"] - 1
    t_best, best, leaves = F(t_max), None, []

    def normal(j, v):
        return [F(x) for x in rec[j, 9:]]

    have, node, e = False, 0, F(0)
    if t_best > r.t_min:
        have, e = _slab(tree_np["node_lo"][0], tree_np["node_hi"][0], r,
                        t_best)
    stack = []
    while True:
        while True:  # inner nodes, until a leaf
            if not have:
                if not stack:
                    return leaves, (False if any_hit else best)
                node, e = stack.pop()
                if not e <= t_best:
                    continue
            if node >= leaf0:
                break
            p = pairs[node]
            h1, e1 = _slab(p[0:3], p[3:6], r, t_best)
            h2, e2 = _slab(p[6:9], p[9:12], r, t_best)
            swap = e2 < e1
            c1, c2 = 2 * node + 1, 2 * node + 2
            first, second = (c2, c1) if swap else (c1, c2)
            ef, es = (e2, e1) if swap else (e1, e2)
            hf, hs = (h2, h1) if swap else (h1, h2)
            if hf and hs:
                stack.append((first, ef))
            have = hf or hs
            if have:
                node, e = (second, es) if hs else (first, ef)
        have = False
        leaves.append(node)
        h = _leaf(tree_np, node, r, t_best, normal, any_hit)
        if any_hit and h:
            return leaves, True
        if h is not None and h[0] < t_best:
            t_best, best = h[0], h


def _tree_np(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in vars(tree).items()}


def _models_agree(tree, o, d, t_max):
    """Both models on every ray: the same leaves tested and the same
    (t, row, e0, e1, esum) bits, the same any-hit bool; returns the
    redesign's Hit (u, v divided out as the kernel does at the end)."""
    tn = _tree_np(tree)
    n = len(o)
    out = {"t": np.full(n, np.inf, F), "tri": np.full(n, -1, np.int64),
           "u": np.zeros(n, F), "v": np.zeros(n, F)}
    with np.errstate(all="ignore"):
        for i in range(n):
            r = _Ray(o[i], d[i], 0.0)
            leaves_ref, h_ref = _walk_reference(tn, r, t_max[i])
            leaves_new, h_new = _walk_redesign(tn, r, t_max[i])
            assert leaves_new == leaves_ref, i
            assert (h_ref is None) == (h_new is None), i
            if h_ref is not None:
                assert _bits(h_new[:1] + h_new[2:]).tolist() == _bits(
                    h_ref[:1] + h_ref[2:]).tolist()
                assert h_new[1] == h_ref[1], i
                t, row, e0, e1, esum = h_new
                inv = F(1.0) / esum
                out["t"][i], out["tri"][i] = t, tn["order"][row]
                out["u"][i], out["v"][i] = e0 * inv, e1 * inv
            leaves_ref, occ_ref = _walk_reference(tn, r, t_max[i],
                                                  any_hit=True)
            leaves_new, occ_new = _walk_redesign(tn, r, t_max[i],
                                                 any_hit=True)
            assert leaves_new == leaves_ref, i
            assert occ_ref == occ_new == (h_ref is not None), i
    return out


def _against_plain(out, tree, o, d, t_max):
    """The models' Hit against intersect_bvh_plain: the same triangles, t
    within the cross product's rounding (the plain walk's
    torch.linalg.cross rounds each component once, fused), u and v within
    the file's tolerance."""
    n = len(o)
    hp = tbvh.intersect_bvh_plain(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.zeros(n), torch.from_numpy(t_max),
                                  tree)
    np.testing.assert_array_equal(out["tri"], hp.tri.numpy())
    for k, rtol, atol in (("t", 1e-5, 1e-6), ("u", 1e-4, 1e-5),
                          ("v", 1e-4, 1e-5)):
        np.testing.assert_allclose(out[k], getattr(hp, k).numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("tris,leaf,n", [
    (lambda: _soup(300), 8, 300),
    (lambda: _soup(5), 8, 200),
    (lambda: np.asarray(jtesting.simple_scene(("lambert",)).tri_v), 4, 200),
], ids=["soup300", "soup5", "simple"])
def test_walk_models_agree_on_soups(tris, leaf, n):
    """The redesign's step order against the first design's on the file's
    soups and rays (a fifth with a short window, a few axis-aligned, then
    t_max = 0 for all): the same leaves tested and the same bits on every
    ray."""
    tree = tbvh.build_bvh(tris(), leaf_size=leaf)
    o, d, t_max = _rays(n, seed=leaf + n)
    out = _models_agree(tree, o, d, t_max)
    assert (out["tri"] >= 0).any() or n < 300
    _against_plain(out, tree, o, d, t_max)
    none = _models_agree(tree, o[:40], d[:40], np.zeros(40, F))
    assert (none["tri"] < 0).all()


@pytest.mark.parametrize("copies", [1, 5, 40], ids=lambda c: f"x{c}")
def test_walk_models_agree_on_ties(copies):
    """Two triangles with a common edge, each stored `copies` times (in one
    leaf or across leaves; tests/test_torch_kernels.py's test_bvh_kernel_
    ties), rays through the edge and either face: exact ties within and
    across leaves, the same leaves and bits on every ray."""
    quad = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[1, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    tree = tbvh.build_bvh(np.repeat(quad, copies, axis=0))
    rng = np.random.default_rng(copies)
    n = 128
    s = rng.random(n).astype(F)
    on_edge = np.stack([1 - s, s, np.zeros(n, F)], 1)
    anywhere = np.concatenate([rng.random((n, 2)), np.zeros((n, 1))], 1)
    target = np.where((np.arange(n) % 2 == 0)[:, None], on_edge,
                      anywhere).astype(F)
    o = (target + rng.normal(size=(n, 3)) * [0.5, 0.5, 0.0]
         + [0, 0, 3]).astype(F)
    d = (target - o).astype(F)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = _models_agree(tree, o, d, np.full(n, np.inf, F))
    assert (out["tri"] >= 0).sum() > n // 2
    _against_plain(out, tree, o, d, np.full(n, np.inf, F))


def test_walk_models_agree_on_axis_aligned_rays():
    """Directions along the axes (the slab test's 1e-30 guard) and with
    one zero component, aimed back across the soup."""
    rng = np.random.default_rng(11)
    tri = _soup(300)
    tree = tbvh.build_bvh(tri)
    n = 120
    d = np.eye(3, dtype=F)[np.arange(n) % 3] * np.where(
        np.arange(n) % 2, 1.0, -1.0)[:, None].astype(F)
    tilt = rng.normal(size=(n, 3)).astype(F)
    tilt[np.arange(n), (np.arange(n) + 1) % 3] = 0.0
    d[n // 2:] = tilt[n // 2:] / np.linalg.norm(tilt[n // 2:], axis=-1,
                                                keepdims=True)
    target = tri[rng.integers(0, len(tri), n)].mean(1)
    o = (target - d * 20.0).astype(F)
    out = _models_agree(tree, o, d, np.full(n, np.inf, F))
    assert (out["tri"] >= 0).mean() > 0.5
    # t ~ 20 here: the cross product's rounding scales with it
    hp = tbvh.intersect_bvh_plain(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.zeros(n), torch.full((n,), np.inf),
                                  tree)
    np.testing.assert_array_equal(out["tri"], hp.tri.numpy())
    np.testing.assert_allclose(out["t"], hp.t.numpy(), rtol=1e-4)


def test_padding_records_never_hit():
    """A padding row (order -1) is all zeros: its plane normal is zero, so
    t is NaN for every ray, even one through the origin, and the triangle
    test never passes."""
    tree = tbvh.build_bvh(_soup(5))
    tn = _tree_np(tree)
    pad = np.nonzero(tn["order"] < 0)[0]
    assert len(pad) == 3
    o, d, _ = _rays(50, seed=3)
    o[:10] = -d[:10] * 2.0  # through the origin, where the padding lies
    with np.errstate(all="ignore"):
        for i in range(50):
            r = _Ray(o[i], d[i], 0.0)
            for j in pad:
                v = [F(x) for x in tn["tri_rec"][j, :9]]
                assert _tri(v, [F(x) for x in tn["tri_rec"][j, 9:]], r,
                            INF32) is None
