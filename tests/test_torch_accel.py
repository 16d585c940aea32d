"""nart_tpu_torch cluster build + plain closest/any-hit vs nart_tpu.

The build must give identical arrays.  The plain closest-hit and any-hit
versions (what CPU tensors run, and what the CUDA kernels are held against)
are checked against nart_tpu.pallas_accel.intersect_clusters in interpret
mode and against geometry.intersect_brute, on the tests/test_pallas.py
cases with that file's tolerances (t rtol 1e-4 / atol 1e-5, u/v rtol 1e-3
/ atol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import pallas_accel as jpa
from nart_tpu.geometry import intersect_brute as j_brute
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import kernel_stats
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

ARRAYS = ("planes", "order", "aabb", "sc_aabb", "morder", "cl_lo", "cl_hi")
META = ("n_clusters", "n_tris", "n_sc", "sc_size", "csize")


def _random_tris(n, rng, spread=3.0, size=0.5):
    tri = rng.normal(size=(n, 3, 3)).astype(np.float32) * size
    tri += rng.normal(size=(n, 1, 3)).astype(np.float32) * spread
    return tri


def _random_rays(n, rng, spread=4.0):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_same_build(t, j):
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    for k in META:
        assert getattr(t, k) == getattr(j, k), k


@pytest.mark.parametrize("n_tris,kw", [
    (5, {}), (200, {}), (700, {}), (700, {"super_target": 2}),
])
def test_build_clusters_equal(n_tris, kw):
    tri = _random_tris(n_tris, np.random.default_rng(n_tris))
    _assert_same_build(tca.build_clusters(tri, **kw),
                       jpa.build_clusters(tri, **kw))


def test_build_clusters_median_equal(monkeypatch):
    monkeypatch.setenv("NART_CLUSTER_METHOD", "median")
    tri = _random_tris(700, np.random.default_rng(11))
    _assert_same_build(tca.build_clusters(tri, method="median"),
                       jpa.build_clusters(tri))


def test_build_clusters_large_policy_equal():
    """From 32k triangles: 64-triangle clusters, median split, target 256."""
    tri = _random_tris(33000, np.random.default_rng(5), spread=20.0)
    t = tca.build_clusters(tri)
    assert (t.csize, t.sc_size) == (64, 3)
    _assert_same_build(t, jpa.build_clusters(tri))


@pytest.mark.parametrize("source", ["build", "jax_arrays"])
def test_accel_tensors_are_contiguous(source):
    """The CUDA wrappers refuse non-contiguous tensors, so both ways of
    making a ClusterAccel give C-contiguous ones (aabb is a concatenation
    of transposes, F-ordered in numpy)."""
    tri = _random_tris(300, np.random.default_rng(3))
    if source == "build":
        acc = tca.build_clusters(tri)
    else:
        acc_j = jpa.build_clusters(tri)
        acc = tca.accel_from_numpy(
            {k: np.asarray(getattr(acc_j, k)) for k in ARRAYS + META})
    for k in ARRAYS:
        assert getattr(acc, k).is_contiguous(), k


def _both(o, d, t_min, t_max, tri, block, **kw):
    acc_j = jpa.build_clusters(tri, **kw)
    acc_t = tca.accel_from_numpy(
        {k: np.asarray(getattr(acc_j, k)) for k in ARRAYS + META})
    args_t = [torch.from_numpy(x) for x in (o, d, t_min, t_max)]
    args_j = [jnp.asarray(x) for x in (o, d, t_min, t_max)]
    hp = jpa.intersect_clusters(*args_j, acc_j, block=block, interpret=True)
    ht = tca.intersect_clusters(*args_t, acc_t)
    occ = tca.intersect_clusters_any(*args_t, acc_t)
    hb = j_brute(*args_j, jnp.asarray(tri))
    return hp, ht, occ, hb


def _assert_hits_match(ht, hj, uv=True):
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    hit = np.asarray(hj.tri) >= 0
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-4, atol=1e-5)
    if uv:
        for k in ("u", "v"):
            np.testing.assert_allclose(getattr(ht, k).numpy()[hit],
                                       np.asarray(getattr(hj, k))[hit],
                                       rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n_tris", [5, 200, 700])
def test_plain_matches_pallas_and_brute(n_tris):
    rng = np.random.default_rng(n_tris)
    tri = _random_tris(n_tris, rng)
    n = 640
    o, d = _random_rays(n, rng)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    hp, ht, occ, hb = _both(o, d, t_min, t_max, tri, 256)
    _assert_hits_match(ht, hp)
    _assert_hits_match(ht, hb)
    np.testing.assert_array_equal(occ.numpy(), ht.tri.numpy() >= 0)


def test_plain_finite_tmax_and_parked_lanes():
    """Finite per-ray t_max (shadow rays) and t_max = 0 lanes (culled):
    any-hit == closest-hit validity == the Pallas kernel's."""
    rng = np.random.default_rng(701)
    tri = _random_tris(700, rng)
    n = 512
    o, d = _random_rays(n, rng)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(rng.random(n) < 0.25, 0.0,
                     rng.exponential(5.0, n)).astype(np.float32)
    hp, ht, occ, hb = _both(o, d, t_min, t_max, tri, 128)
    _assert_hits_match(ht, hp)
    occ_j = jpa.intersect_clusters_any(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min), jnp.asarray(t_max),
        jpa.build_clusters(tri), block=128, interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(occ.numpy(), ht.tri.numpy() >= 0)
    assert not occ.numpy()[t_max == 0.0].any()


@pytest.mark.parametrize("super_target", [1, 2])
def test_plain_two_level_matches(super_target):
    rng = np.random.default_rng(42 + super_target)
    tri = _random_tris(700, rng)
    n = 512
    o, d = _random_rays(n, rng)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    hp, ht, occ, hb = _both(o, d, t_min, t_max, tri, 128,
                            super_target=super_target)
    _assert_hits_match(ht, hp, uv=False)
    _assert_hits_match(ht, hb, uv=False)


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors never reach the kernel library: counts stay 0, and a
    tensor on another device type is refused."""
    rng = np.random.default_rng(3)
    acc = tca.build_clusters(_random_tris(50, rng))
    o, d = (torch.from_numpy(x) for x in _random_rays(64, rng))
    tmin, tmax = torch.zeros(64), torch.full((64,), np.inf)
    tca.reset_launch_counts()
    tca.intersect_clusters(o, d, tmin, tmax, acc)
    tca.intersect_clusters_any(o, d, tmin, tmax, acc)
    kernel_stats.traversal_stats(o, d, tmin, tmax, acc)
    kernel_stats.traversal_stats(o, d, tmin, tmax, acc, any_hit=True)
    assert tca.launch_counts == {"closest_hit": 0, "any_hit": 0,
                                 "closest_hit_stats": 0, "any_hit_stats": 0}
    with pytest.raises(ValueError):
        tca.intersect_clusters(o.to("meta"), d.to("meta"), tmin.to("meta"),
                               tmax.to("meta"), acc)


def test_accel_kind_policy():
    assert tca.resolve_accel_kind("auto") == "cluster"
    assert tca.resolve_accel_kind("brute") == "brute"
    assert tca.resolve_accel_kind("bvh") == "bvh"
    assert tca.ACCEL_KINDS == ("auto", "brute", "bvh", "cluster")
    # "pallas" is the JAX package's name of the cluster kernels
    assert tca.resolve_accel_kind("pallas") == "cluster"
    with pytest.raises(ValueError):
        tca.resolve_accel_kind("kdtree")
