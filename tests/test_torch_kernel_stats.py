"""nart_tpu_torch traversal counters (closest_hit_stats_plain,
any_hit_stats_plain, kernel_stats.py) on the CPU.

The plain versions are held against a scalar numpy walk written from
csrc/cluster_hit.cu (one ray at a time, float32, the kernel's loop order):
counters exact; `together` against the sizes of the groups of a 32-ray warp
that meet on one cluster at one member step.  The any-hit walk's occlusion
must equal any_hit_plain's and it tests no more clusters than the
closest-hit walk.  The closest-hit t must equal closest_hit_plain's bit for
bit and agree
within rtol 1e-5 with nart_tpu.pallas_accel.intersect_clusters in interpret
mode (tools/kernel_stats.py itself runs at import on the TPU and cannot be
imported; XLA:CPU fuses the plane equation's multiply-adds, which moved one
ray of these by 4.6e-6, and tests/test_torch_accel.py holds the same pair
to 1e-4).  At most 256 rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import pallas_accel as jpa
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import kernel_stats
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

F = np.float32
NOISE = F(2.0 ** -22)


def _tris(n, rng, spread=3.0, size=0.5):
    tri = rng.normal(size=(n, 3, 3)).astype(F) * F(size)
    return tri + rng.normal(size=(n, 1, 3)).astype(F) * F(spread)


def _rays(n, rng, parked=0.25):
    o = rng.normal(size=(n, 3)).astype(F) * F(4.0)
    d = rng.normal(size=(n, 3)).astype(F)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < parked, 0.0,
                     np.where(rng.random(n) < 0.5, np.inf,
                              rng.exponential(5.0, n))).astype(F)
    return o, d, np.full(n, 1e-4, F), t_max


def _slab(box, c, o, inv, t_lo, t_hi):
    a0 = (box[0:3, c] - o) * inv
    a1 = (box[3:6, c] - o) * inv
    near = np.max(np.minimum(a0, a1))
    far = np.min(np.maximum(a0, a1))
    return max(near, t_lo) <= min(far, t_hi)


def _edge(ax, ay, bx, by):
    p1, p2 = ax * by, ay * bx
    e = p1 - p2
    return np.where(np.abs(e) <= (np.abs(p1) + np.abs(p2)) * NOISE, F(0), e)


def _cluster_min_t(planes, c, o, d, t_min, t_hi):
    """Nearest watertight hit of one ray in cluster c with t in
    (t_min, t_hi), or None (tri_test of cluster_hit.cu over the csize
    rows at once)."""
    pl = planes[:, c, :]
    ad = np.abs(d)
    mj = ((0 if ad[0] > ad[2] else 2) if ad[0] > ad[1]
          else (1 if ad[1] > ad[2] else 2))
    m0, m1 = (mj + 1) % 3, (mj + 2) % 3
    sz = F(1.0) / d[mj]
    sx, sy = -d[m0] * sz, -d[m1] * sz
    with np.errstate(divide="ignore", invalid="ignore"):
        d_dot_n = d[0] * pl[9] + d[1] * pl[10] + d[2] * pl[11]
        o_dot_n = o[0] * pl[9] + o[1] * pl[10] + o[2] * pl[11]
        t = (pl[12] - o_dot_n) / d_dot_n
    px, py = [], []
    for k in range(3):
        v = pl[3 * k: 3 * k + 3]
        cc = v[mj] - o[mj]
        px.append((v[m0] - o[m0]) + cc * sx)
        py.append((v[m1] - o[m1]) + cc * sy)
    e0 = _edge(px[1], py[1], px[2], py[2])
    e1 = _edge(px[2], py[2], px[0], py[0])
    e2 = _edge(px[0], py[0], px[1], py[1])
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    hit = (~(neg & pos) & (np.abs(e0) + np.abs(e1) + np.abs(e2) != 0)
           & (t > t_min) & (t < t_hi))
    return t[hit].min() if hit.any() else None


def _scalar_walk(o, d, t_min, t_max, acc, warp=32, any_hit=False):
    """walk_kernel<kStats = true> of cluster_hit.cu, ray by ray.  Returns t
    (closest-hit) or the occlusion (any_hit) and the five counters;
    `together` sums, over the clusters a ray tested, the rays of its warp
    that tested the same cluster at the same (supercluster, member) step;
    `sc_tests` counts the supercluster slab tests (none once an any-hit ray
    has left the walk)."""
    planes, aabb, sc_aabb, morder = (
        getattr(acc, k).numpy() for k in ("planes", "aabb", "sc_aabb",
                                          "morder"))
    n = len(o)
    out_t = np.full(n, np.inf, F)
    visited, slabs, tested, sc_tests = (np.zeros(n, np.int32)
                                        for _ in range(4))
    steps = []  # per ray: the (sc, j, cluster) steps whose triangles it tested
    for i in range(n):
        inv = F(1.0) / np.where(d[i] == 0, F(1e-30), d[i])
        octant = 4 * (d[i, 0] > 0) + 2 * (d[i, 1] > 0) + (d[i, 2] > 0)
        t_best, found, mine = t_max[i], False, set()
        alive = not any_hit or t_max[i] > 0
        for sc in range(acc.n_sc):
            if not alive:
                break
            sc_tests[i] += 1
            if not _slab(sc_aabb, sc, o[i], inv, t_min[i], t_best):
                continue
            visited[i] += 1
            for j in range(acc.sc_size):
                if not alive:
                    break
                c = int(morder[octant, sc * acc.sc_size + j])
                slabs[i] += 1
                if not _slab(aabb, c, o[i], inv, t_min[i], t_best):
                    continue
                tested[i] += 1
                mine.add((sc, j, c))
                t = _cluster_min_t(planes, c, o[i], d[i], t_min[i], t_best)
                if t is not None:
                    t_best, found = t, True
                    alive = not any_hit
        if found:
            out_t[i] = t_best
        steps.append(mine)
    together = np.zeros(n, np.int32)
    for i in range(n):
        w0 = i - i % warp
        together[i] = sum(sum(s in steps[k] for k in range(w0, min(w0 + warp, n)))
                          for s in steps[i])
    return (np.isfinite(out_t) if any_hit else out_t, visited, slabs, tested,
            together, sc_tests)


SIZES = pytest.mark.parametrize("n_tris,kw,n_rays", [
    (60, {}, 256),  # one small cluster
    (700, {}, 200),  # six clusters, one per supercluster
    (700, {"super_target": 2}, 256),  # two-level: three members each
    (500, {"csize": 16, "super_target": 8}, 250),  # 32 small clusters
], ids=["small", "flat", "two_level", "many_clusters"])


@SIZES
def test_stats_plain_matches_scalar_walk_and_closest_hit(n_tris, kw, n_rays):
    rng = np.random.default_rng(n_tris + n_rays)
    tri = _tris(n_tris, rng)
    acc = tca.build_clusters(tri, **kw)
    rays = _rays(n_rays, rng)
    args = [torch.from_numpy(x) for x in rays]
    st = kernel_stats.traversal_stats(*args, acc)

    t, visited, slabs, tested, together, sc_tests = _scalar_walk(*rays, acc)
    np.testing.assert_array_equal(st.visited.numpy(), visited)
    np.testing.assert_array_equal(st.slabs.numpy(), slabs)
    np.testing.assert_array_equal(st.tested.numpy(), tested)
    np.testing.assert_array_equal(st.together.numpy(), together)
    np.testing.assert_array_equal(st.sc_tests.numpy(), sc_tests)
    assert (st.sc_tests == acc.n_sc).all()
    np.testing.assert_array_equal(st.t.numpy(), t)
    for x in st[1:]:
        assert x.dtype == torch.int32

    # the walk's t is the closest hit's
    hp = tca.closest_hit_plain(*args, acc)
    assert torch.equal(st.t, hp.t)
    acc_j = jpa.build_clusters(tri, **kw)
    hj = jpa.intersect_clusters(*(jnp.asarray(x) for x in rays), acc_j,
                                block=128, interpret=True)
    np.testing.assert_allclose(st.t.numpy(), np.asarray(hj.t), rtol=1e-5)

    # what the counters must obey
    assert (st.tested <= st.slabs).all()
    assert (st.slabs == st.visited * acc.sc_size).all()
    assert (st.visited <= acc.n_sc).all()
    assert (st.together >= st.tested).all()
    assert (st.together <= st.tested * 32).all()
    parked = args[3] <= 0
    assert parked.any() and (st.visited[parked] == 0).all()
    assert st.tested.sum() > 0


@SIZES
def test_any_hit_stats_plain_matches_scalar_walk_and_any_hit(n_tris, kw,
                                                             n_rays):
    rng = np.random.default_rng(n_tris + n_rays)
    tri = _tris(n_tris, rng)
    acc = tca.build_clusters(tri, **kw)
    rays = _rays(n_rays, rng)
    args = [torch.from_numpy(x) for x in rays]
    st = kernel_stats.traversal_stats(*args, acc, any_hit=True)
    assert isinstance(st, tca.AnyHitStats)

    occ, visited, slabs, tested, together, sc_tests = _scalar_walk(
        *rays, acc, any_hit=True)
    np.testing.assert_array_equal(st.occluded.numpy(), occ)
    np.testing.assert_array_equal(st.visited.numpy(), visited)
    np.testing.assert_array_equal(st.slabs.numpy(), slabs)
    np.testing.assert_array_equal(st.tested.numpy(), tested)
    np.testing.assert_array_equal(st.together.numpy(), together)
    np.testing.assert_array_equal(st.sc_tests.numpy(), sc_tests)
    assert st.occluded.dtype == torch.bool
    for x in st[1:]:
        assert x.dtype == torch.int32

    # the walk's occlusion is the any-hit query's, and the closest-hit's
    assert torch.equal(st.occluded, tca.any_hit_plain(*args, acc))
    closest = kernel_stats.traversal_stats(*args, acc)
    live = args[3] > 0
    assert torch.equal(st.occluded[live], torch.isfinite(closest.t)[live])

    # it ends at the first cluster with a hit: never more work than the
    # closest-hit walk, and the same work on a ray that hits nothing
    for k in ("visited", "slabs", "tested", "sc_tests"):
        assert (getattr(st, k) <= getattr(closest, k)).all(), k
        miss = live & ~st.occluded
        assert torch.equal(getattr(st, k)[miss], getattr(closest, k)[miss]), k
    assert (st.tested[st.occluded] >= 1).all()
    if acc.n_clusters > 1:
        assert (st.tested < closest.tested).any()
    assert (st.slabs <= st.visited * acc.sc_size).all()
    assert (st.visited <= st.sc_tests).all()
    if acc.n_sc > 1:  # an occluded ray skips the superclusters behind its hit
        assert (st.sc_tests[st.occluded] < acc.n_sc).any()
    assert (st.together >= st.tested).all()
    assert (st.together <= st.tested * 32).all()
    parked = ~live
    assert parked.any()
    for x in st:
        assert not x[parked].any()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("n_rays", [32, 75], ids=["one_warp", "ragged"])
def test_together_is_the_warp_group_size(any_hit, n_rays):
    """Rays of one warp that differ only by a tiny jitter walk alike, so
    each meets its whole warp on every cluster it tests; the last warp of a
    ragged count is smaller.  A second bundle in another direction octant
    splits the groups."""
    rng = np.random.default_rng(5)
    acc = tca.build_clusters(_tris(700, rng), super_target=2)
    assert acc.sc_size == 3
    o = np.tile(np.array([[0.1, -6.0, 0.2]], F), (n_rays, 1))
    d = np.tile(np.array([[0.05, 1.0, 0.02]], F), (n_rays, 1))
    d += rng.normal(size=d.shape).astype(F) * F(1e-6)
    t_min, t_max = np.zeros(n_rays, F), np.full(n_rays, np.inf, F)
    args = [torch.from_numpy(x) for x in (o, d, t_min, t_max)]
    st = kernel_stats.traversal_stats(*args, acc, any_hit=any_hit)
    assert st.tested.sum() > 0
    size = np.minimum(32, n_rays - np.arange(n_rays) // 32 * 32)
    same = (st.tested == st.tested[0]).all()
    if same:
        np.testing.assert_array_equal(st.together.numpy(),
                                      st.tested.numpy() * size)
    ref = _scalar_walk(o, d, t_min, t_max, acc, any_hit=any_hit)
    np.testing.assert_array_equal(st.together.numpy(), ref[4])

    # every other ray turned into the opposite octant, whose member order
    # is the reverse: the two bundles meet on a supercluster's middle
    # member at most, so some group is smaller than the warp
    d2 = d.copy()
    d2[1::2] *= F(-1.0)
    o2 = o.copy()
    o2[1::2, 1] = F(6.0)
    args2 = [torch.from_numpy(x) for x in (o2, d2, t_min, t_max)]
    st2 = kernel_stats.traversal_stats(*args2, acc, any_hit=any_hit)
    ref2 = _scalar_walk(o2, d2, t_min, t_max, acc, any_hit=any_hit)
    np.testing.assert_array_equal(st2.together.numpy(), ref2[4])
    np.testing.assert_array_equal(st2.tested.numpy(), ref2[3])
    assert (st2.together.numpy() < st2.tested.numpy() * size).any()


def test_traversal_stats_refuses_other_devices():
    acc = tca.build_clusters(_tris(20, np.random.default_rng(0)))
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal-stats path"):
        kernel_stats.traversal_stats(o, o, o[:, 0], o[:, 0], acc)
    with pytest.raises(ValueError, match="no traversal-stats path"):
        kernel_stats.traversal_stats(o, o, o[:, 0], o[:, 0], acc,
                                     any_hit=True)


def test_main_prints_the_tools_lines(capsys):
    """The entry point on the default scene (macbeth), on the CPU: coherent
    camera rays share their clusters across the warp more than random
    directions do."""
    out = kernel_stats.main(["--device", "cpu", "--rays", "2048"])
    text = capsys.readouterr().out
    assert "n_cl=16 n_sc=16 sc_size=1 csize=128" in text
    assert "[coherent]" in text and "[incoherent]" in text
    assert "[coherent any-hit]" in text and "[incoherent any-hit]" in text
    for label in ("coherent", "incoherent"):
        # the any-hit walk ends early: no more clusters than the closest-hit
        assert (0 < out[label + " any-hit"]["tri_tests"]
                <= out[label]["tri_tests"])
    co, inc = out["coherent"], out["incoherent"]
    assert co["tri_tests"] > 0 and inc["tri_tests"] > 0
    assert co["lanes_per_test"] > inc["lanes_per_test"] >= 1.0
    assert co["tri_tests"] <= co["slab_tests"] == co["visited_sc"]


def test_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_stats.main([])
