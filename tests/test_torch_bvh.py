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
