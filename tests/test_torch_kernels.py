"""CUDA kernels (nart_tpu_torch/csrc/cluster_hit.cu, csrc/small_lut.cu,
csrc/large_lut.cu, csrc/bvh_walk.cu, csrc/bsdf.cu) vs their plain PyTorch
versions, on the card.

Marked ``gpu``: each test skips (with its reason) when no CUDA device is
present, deciding inside the fixture, never at import.  Run them on a
machine with a card with ``python -m pytest tests/test_torch_kernels.py``.
Criteria (as chip_smoke.py): triangle ids agree on >= 99.99% of rays,
t/u/v to rtol 1e-4 / atol 1e-5 where they agree, any-hit equal to
closest-hit validity exactly; the two counter kernels' five counters equal
to their plain versions' on every ray.  The small cases pin what a warp
that tests a cluster together could get wrong: one ray to a group, one live
lane, a ragged last warp, and ties between rows, lanes and tiles.  The
small-table look-ups: the forward the plain gather's bits, the backward the
float64 per-row sum to rtol 1e-5 / atol 1e-6 and the same bits run to run
and from a CUDA graph's replay; the large-table look-ups the same, on
tables of 65 to 100,000 rows of 1 to 8 values, with runs of one row that
cross many of the backward's 1,024-lane blocks.  The large-table
backward's radix sort leaves torch.sort(stable=True)'s order and its sums
have the bits of the sorted route (torch.sort, then the same segmented
sum); the many-table forward has the bits of one launch a table, the
many-table backward those of the two-launch route (one table a call) in
one kernel node, and their wrappers refuse what the kernels do not
take.  The LBVH walk (B1) against the plain walk by the traversal's
criteria, occlusion the closest hit's validity exactly, and both entries
the bits of the reference kernel (the walk's first design) on every ray:
soups of 1, 40 and 40,000 triangles, axis-aligned rays, ties within and
across leaves (the plain walk's triangle and t on every ray), one window
for every ray, t_max = 0, and a tree deeper than its stack or packed
arrays off their alignment refused before any launch.  The BSDF kernels
(csrc/bsdf.cu) on every lobe kind of testing.BSDF_LOBES: X1 and
X2 the plain version's bits on every lane, also from a CUDA graph's
replay, X1 also its first design's (nart_bsdf_sample_ref), X3 within rtol
1e-5 / atol 1e-6 of the float64 VJP of the plain version (wi held fixed)
on every lane of the float32 branches, beside its first design
(nart_bsdf_f_bwd_ref), and zero on grazing mirror lanes; the
sample+eval launch (X2's redesign) X1's and X2's bits on every lane and
its Function's gradients X3's two rows summed; X1's and X3's
outputs follow their lanes through a permutation bit for bit, as built
and with kernel_variants' regrouping of a block's lanes by lobe; the
Functions of bsdf_ops launch them once a call.
"""

import os

import numpy as np
import pytest
import torch

from nart_tpu_torch import cluster_accel as ca
from nart_tpu_torch import cuda_build
from nart_tpu_torch import select as tsel
from nart_tpu_torch.testing import BSDF_LOBES, bit_share, bsdf_lane_set

pytestmark = pytest.mark.gpu

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")
# the look-up kernels' backward against a float64 sum: float32 sums in
# another order
LUT_RTOL, LUT_ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _soup(n, rng):
    return (rng.normal(size=(n, 3, 3)) * 0.3
            + rng.normal(size=(n, 1, 3)) * 4.0).astype(np.float32)


def _rays(n, rng, dev, parked=0.25):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < parked, 0.0,
                     np.where(rng.random(n) < 0.5, np.inf,
                              rng.exponential(4.0, n))).astype(np.float32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.zeros(n, device=dev), torch.from_numpy(t_max).to(dev))


def _check(rays, acc):
    before = dict(cuda_build.launch_counts)
    hk = ca.intersect_clusters(*rays, acc)
    occ = ca.intersect_clusters_any(*rays, acc)
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts
    assert counts["closest_hit"] == before["closest_hit"] + 1
    assert counts["any_hit"] == before["any_hit"] + 1
    hp = ca.closest_hit_plain(*rays, acc)
    agree = hk.tri == hp.tri
    assert agree.float().mean() >= 0.9999
    both = agree & (hp.tri >= 0)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hk, k)[both], getattr(hp, k)[both],
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(occ, hk.tri >= 0)
    assert not occ[rays[3] <= 0].any()


@pytest.mark.parametrize("n_tris,kw", [
    (5, {}), (700, {}), (700, {"super_target": 2}), (700, {"method": "median"}),
    (40000, {}),
])
def test_kernels_match_plain_on_soups(cuda, n_tris, kw):
    rng = np.random.default_rng(n_tris)
    acc = ca.build_clusters(_soup(n_tris, rng), **kw).to(cuda)
    _check(_rays(8192, rng, cuda), acc)


def _check_stats(rays, acc):
    """Both counter kernels against their plain versions and against the
    production kernels on the same rays."""
    from nart_tpu_torch import kernel_stats

    before = dict(cuda_build.launch_counts)
    sk = kernel_stats.traversal_stats(*rays, acc)
    ak = kernel_stats.traversal_stats(*rays, acc, any_hit=True)
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts
    assert counts["closest_hit_stats"] == before["closest_hit_stats"] + 1
    assert counts["any_hit_stats"] == before["any_hit_stats"] + 1
    sp = ca.closest_hit_stats_plain(*rays, acc)
    ap = ca.any_hit_stats_plain(*rays, acc)
    for k in ("visited", "slabs", "tested", "together", "sc_tests"):
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
        assert torch.equal(getattr(ak, k), getattr(ap, k)), "any-hit " + k
    assert torch.equal(sk.t, ca.intersect_clusters(*rays, acc).t)
    assert torch.equal(sk.t, sp.t)
    assert torch.equal(ak.occluded, ca.intersect_clusters_any(*rays, acc))
    assert torch.equal(ak.occluded, ap.occluded)
    assert (ak.tested <= sk.tested).all()
    assert (sk.sc_tests == acc.n_sc).all()
    return sk, ak


@pytest.mark.parametrize("n_tris,kw", [
    (5, {}), (700, {"super_target": 2}), (40000, {}),
])
def test_stats_kernel_matches_plain(cuda, n_tris, kw):
    """The closest-hit counter kernel: all five counters equal to the plain
    walk's on every ray (the rays together on a cluster are the group that
    tested it, which follows from the walk alone), t equal to the
    closest-hit kernel's."""
    rng = np.random.default_rng(n_tris)
    acc = ca.build_clusters(_soup(n_tris, rng), **kw).to(cuda)
    sk, _ = _check_stats(_rays(4096, rng, cuda), acc)
    assert (sk.together >= sk.tested).all()


@pytest.mark.parametrize("n_tris,kw", [
    (5, {}), (700, {"super_target": 2}), (700, {"csize": 16}), (40000, {}),
])
def test_any_hit_stats_kernel_matches_plain(cuda, n_tris, kw):
    """The any-hit counter kernel: counters and occlusion equal to the plain
    walk's, occlusion equal to the any-hit kernel's, nothing counted where
    t_max <= 0."""
    rng = np.random.default_rng(n_tris + 1)
    acc = ca.build_clusters(_soup(n_tris, rng), **kw).to(cuda)
    rays = _rays(4096, rng, cuda)
    _, ak = _check_stats(rays, acc)
    parked = rays[3] <= 0
    for x in ak:
        assert not x[parked].any()
    assert (ak.tested[ak.occluded] >= 1).all()


def test_any_hit_stats_kernel_matches_plain_on_macbeth(cuda):
    from nart_tpu_torch import scene

    sc = scene.load_scene(os.path.join(FIX, "macbeth.json"))
    acc = ca.build_clusters(sc.tri_v.numpy()).to(cuda)
    o, d, t_min, t_max = _rays(16384, np.random.default_rng(4), cuda)
    _check_stats((o * 0.3, d, t_min, t_max), acc)


def _blobs(n_blobs, per_blob, rng):
    """n_blobs tight groups of triangles along the x axis, 10 apart."""
    tri = rng.normal(size=(n_blobs, per_blob, 3, 3)) * 0.3
    tri[..., 0] += 10.0 * np.arange(n_blobs)[:, None, None]
    return tri.reshape(-1, 3, 3).astype(np.float32)


def _down_rays(n, dev, t_max):
    """Ray i drops along +z onto blob i of _blobs."""
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = 10.0 * np.arange(n)
    o[:, 2] = -5.0
    d = np.tile(np.array([[1e-3, 2e-3, 1.0]], np.float32), (n, 1))
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.zeros(n, device=dev),
            torch.from_numpy(np.asarray(t_max, np.float32)).to(dev))


def test_every_lane_wants_another_cluster(cuda):
    """32 rays of one warp, each onto a blob of its own: every group is one
    ray, and each ray gets its own cluster's hit."""
    rng = np.random.default_rng(6)
    acc = ca.build_clusters(_blobs(32, 16, rng), csize=16,
                            method="median").to(cuda)
    rays = _down_rays(32, cuda, np.full(32, np.inf))
    _check(rays, acc)
    sk, ak = _check_stats(rays, acc)
    assert (sk.tested >= 1).all()
    assert torch.equal(sk.together, sk.tested)
    assert torch.equal(ak.together, ak.tested)
    assert (ca.intersect_clusters(*rays, acc).tri >= 0).sum() >= 16


def test_only_the_last_lane_is_alive(cuda):
    """t_max = 0 on lanes 0..30: the any-hit walk is lane 31's alone."""
    rng = np.random.default_rng(7)
    acc = ca.build_clusters(_soup(700, rng), super_target=2).to(cuda)
    o, d, t_min, _ = _rays(32, rng, cuda)
    t_max = torch.zeros(32, device=cuda)
    t_max[31] = float("inf")
    # aim lane 31 at a triangle so that it has a hit to find
    o[31] = torch.tensor([0.0, 0.0, -30.0], device=cuda)
    d[31] = torch.nn.functional.normalize(
        acc.planes[0:3, 0, 0] * 0.4 + acc.planes[3:6, 0, 0] * 0.3
        + acc.planes[6:9, 0, 0] * 0.3 - o[31], dim=0)
    rays = (o, d, t_min, t_max)
    _check(rays, acc)
    _, ak = _check_stats(rays, acc)
    occ = ca.intersect_clusters_any(*rays, acc)
    assert bool(occ[31]) and not occ[:31].any()
    assert torch.equal(ak.together, ak.tested)  # groups of one
    assert not ak.tested[:31].any() and ak.tested[31] >= 1


@pytest.mark.parametrize("n_rays", [1, 31, 33, 1013])
def test_ray_counts_off_the_warp_size(cuda, n_rays):
    rng = np.random.default_rng(n_rays)
    acc = ca.build_clusters(_soup(700, rng), super_target=2).to(cuda)
    rays = _rays(n_rays, rng, cuda)
    _check(rays, acc)
    _check_stats(rays, acc)


@pytest.mark.parametrize("copies", [1, 40, 100], ids=lambda c: f"x{c}")
def test_ties_go_to_the_lowest_row(cuda, copies):
    """Two triangles with a common edge, each stored `copies` times in one
    cluster, and rays through points of the edge and of either face: equal
    t in other lanes (copies of one triangle in neighbouring rows), in
    other tiles of one lane (rows 32 apart) and on the shared edge.  The
    triangle id must be the plain version's on every ray."""
    quad = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[1, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    tri = np.repeat(quad, copies, axis=0)
    acc = ca.build_clusters(tri).to(cuda)
    assert acc.n_clusters == 2 if copies == 100 else acc.n_clusters == 1
    rng = np.random.default_rng(copies)
    n = 4096
    s = rng.random(n).astype(np.float32)
    on_edge = np.stack([1 - s, s, np.zeros(n, np.float32)], 1)  # (1,0)-(0,1)
    anywhere = np.concatenate([rng.random((n, 2)), np.zeros((n, 1))], 1)
    target = np.where((np.arange(n) % 2 == 0)[:, None], on_edge,
                      anywhere).astype(np.float32)
    o = (target + rng.normal(size=(n, 3)) * [0.5, 0.5, 0.0]
         + [0, 0, 3]).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = (torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda),
            torch.zeros(n, device=cuda),
            torch.full((n,), float("inf"), device=cuda))
    hk = ca.intersect_clusters(*rays, acc)
    hp = ca.closest_hit_plain(*rays, acc)
    assert (hp.tri >= 0).sum() > n // 2
    assert torch.equal(hk.tri, hp.tri)
    assert torch.equal(hk.t, hp.t)
    assert torch.equal(ca.intersect_clusters_any(*rays, acc), hp.tri >= 0)


def test_kernels_match_plain_on_macbeth(cuda):
    from nart_tpu_torch import scene

    sc = scene.load_scene(os.path.join(FIX, "macbeth.json"))
    acc = ca.build_clusters(sc.tri_v.numpy()).to(cuda)
    rng = np.random.default_rng(1)
    o, d, t_min, t_max = _rays(16384, rng, cuda)
    _check((o * 0.3, d, t_min, t_max), acc)


def test_wrappers_refuse_bad_inputs(cuda):
    rng = np.random.default_rng(2)
    acc = ca.build_clusters(_soup(50, rng)).to(cuda)
    o, d, t_min, t_max = _rays(64, rng, cuda)
    with pytest.raises(TypeError):
        ca.closest_hit_cuda(o.double(), d, t_min, t_max, acc)
    with pytest.raises(ValueError):
        ca.any_hit_cuda(o, d.t().contiguous().t(), t_min, t_max, acc)
    with pytest.raises(ValueError):
        ca.closest_hit_cuda(o, d, t_min, t_max, acc.to("cpu"))


def test_macbeth_golden_through_kernels(cuda):
    """test_macbeth_golden's criteria on the port, on the card."""
    from nart_tpu_torch import exr, render, scene

    sc = scene.load_scene(os.path.join(FIX, "macbeth.json"))
    params = render.resolve_params(
        {}, dict(image_width=96, image_height=96, spp=8))
    ours = render.RenderSession(sc, params, cuda).image().cpu().numpy()
    ref = exr.read(os.path.join(os.path.dirname(__file__), "golden",
                                "macbeth_96x96_8spp.exr"))
    r, o = ref[..., :3], ours[..., :3]
    assert abs(o.mean() - r.mean()) / r.mean() < 0.03
    rb = r.reshape(6, 16, 6, 16, 3).mean((1, 3, 4))
    ob = o.reshape(6, 16, 6, 16, 3).mean((1, 3, 4))
    assert (np.abs(ob - rb) / np.maximum(rb, 0.05) < 0.12).mean() >= 0.95


@pytest.mark.parametrize("n,width", [(1, 3), (4, 1), (4, 3), (64, 4),
                                     (100, 3)])
def test_lut_kernels_against_plain(cuda, n, width):
    """nart_lut_gather_many of one table: the plain gather's bits;
    nart_lut_gather_bwd (the two-launch route, counted as
    "lut_gather_bwd_reference"): the float64 per-row sum to rtol 1e-5 /
    atol 1e-6 (positive cotangents; for signed ones, whose sums cancel,
    atol plus rtol times the sum of their magnitudes), integer cotangents'
    sums bit for bit, the same bits on a second launch and from a CUDA
    graph's replay; each launch counted.  n = 100 spans two row tiles; the
    autograd Function takes it to the large-table kernels, the others to
    the many-table backward, and its gradient is the bits of the two-launch
    route or of the large-table kernel."""
    g = np.random.default_rng(n)
    lanes = 65536 + 17  # a ragged last block
    table = torch.from_numpy(
        g.normal(size=(n, width)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(g.integers(0, n, lanes)).to(cuda)
    cot = torch.from_numpy(
        g.normal(size=(lanes, width)).astype(np.float32)).to(cuda)
    before = dict(cuda_build.launch_counts)
    out = tsel.lut_gather_cuda(table, idx)
    d1 = tsel.lut_gather_bwd_cuda(cot, idx, n)
    d2 = tsel.lut_gather_bwd_cuda(cot, idx, n)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["lut_gather"] == before["lut_gather"] + 1
    assert (cuda_build.launch_counts["lut_gather_bwd_reference"]
            == before["lut_gather_bwd_reference"] + 2)
    assert torch.equal(out, table[idx])

    def f64_sum(x):
        return torch.zeros(n, width, dtype=torch.float64,
                           device=cuda).index_add_(0, idx, x.double())

    err = (d1.double() - f64_sum(cot)).abs()
    assert bool((err <= LUT_ATOL + LUT_RTOL * f64_sum(cot.abs())).all())
    cot_pos = cot.abs()
    torch.testing.assert_close(
        tsel.lut_gather_bwd_cuda(cot_pos, idx, n).double(), f64_sum(cot_pos),
        rtol=LUT_RTOL, atol=LUT_ATOL)
    assert torch.equal(d1, d2)
    # integer cotangents: float32 sums exact in any order
    cot_int = torch.from_numpy(g.integers(-8, 9, (lanes, width))).to(cuda)
    want_int = torch.zeros(n, width, dtype=torch.int64,
                           device=cuda).index_add_(0, idx, cot_int)
    assert torch.equal(tsel.lut_gather_bwd_cuda(cot_int.float(), idx, n),
                       want_int.float())

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsel.lut_gather_bwd_cuda(cot, idx, n)  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d3 = tsel.lut_gather_bwd_cuda(cot, idx, n)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(d3, d1)

    leaf = table.clone().requires_grad_()
    (ga,) = torch.autograd.grad(tsel.small_lut(idx, n)(leaf), leaf, cot)
    assert torch.equal(ga, d1 if n <= tsel.AUTO_LUT_ROWS
                       else tsel.lut_gather_large_bwd_cuda(cot, idx, n))


def _large_case(kind, n, lanes, g):
    """Row indices of a large-table case: uniform, all on one row, or long
    runs (half the lanes on one row, a quarter on another, the rest
    uniform), with a few out of range."""
    if kind == "uniform":
        idx = g.integers(0, n, lanes)
    elif kind == "one row":
        idx = np.full(lanes, g.integers(0, n))
    else:
        idx = g.integers(0, n, lanes)
        pick = g.random(lanes)
        idx[pick < 0.5] = n // 2
        idx[(pick >= 0.5) & (pick < 0.75)] = n - 1
    idx[:4] = [-3, n, 0, 10 * n]
    return idx


@pytest.mark.parametrize("kind", ["uniform", "one row", "runs"])
@pytest.mark.parametrize("n,width,lanes", [
    (65, 3, 65536), (8192, 3, 65536), (29791, 8, 32768 + 5),
    (100000, 1, 3000), (343, 5, 1024), (27, 8, 2048)])
def test_large_lut_kernels_against_plain(cuda, n, width, lanes, kind):
    """nart_lut_gather_many on large tables and rows of up to 8 values: the
    plain
    gather's bits (indices clamped); nart_lut_large_bwd: integer
    cotangents' sums the int64 index_add_'s bits, float ones the float64
    per-row sum to atol plus rtol times the sum of their magnitudes, the
    same bits on a second launch and from a CUDA graph's replay (the sort
    captured with it), each launch counted; small_lut's gradient is the
    large-table kernel's (the Function picks it for rows of more than 4
    values at any row count: 27 cells of a 4^3 density)."""
    g = np.random.default_rng(n + lanes)
    idx = torch.from_numpy(_large_case(kind, n, lanes, g)).to(cuda)
    ci = idx.clamp(0, n - 1)
    shape = (n,) if width == 1 else (n, width)
    table = torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(
        g.normal(size=(lanes,) + shape[1:]).astype(np.float32)).to(cuda)
    cot_int = torch.from_numpy(
        g.integers(-8, 9, (lanes,) + shape[1:])).to(cuda)
    before = dict(cuda_build.launch_counts)
    out = tsel.lut_gather_cuda(table, idx)
    d1 = tsel.lut_gather_large_bwd_cuda(cot, idx, n)
    d2 = tsel.lut_gather_large_bwd_cuda(cot, idx, n)
    d_int = tsel.lut_gather_large_bwd_cuda(cot_int.float(), idx, n)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["lut_gather"] == before["lut_gather"] + 1
    assert (cuda_build.launch_counts["lut_gather_large_bwd"]
            == before["lut_gather_large_bwd"] + 3)
    assert torch.equal(out, table[ci])
    want_int = torch.zeros(shape, dtype=torch.int64,
                           device=cuda).index_add_(0, ci, cot_int)
    assert torch.equal(d_int, want_int.float())

    def f64_sum(x):
        return torch.zeros(shape, dtype=torch.float64,
                           device=cuda).index_add_(0, ci, x.double())

    err = (d1.double() - f64_sum(cot)).abs()
    assert bool((err <= LUT_ATOL + LUT_RTOL * f64_sum(cot.abs())).all())
    assert torch.equal(d1, d2)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsel.lut_gather_large_bwd_cuda(cot, idx, n)  # warm, outside
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d3 = tsel.lut_gather_large_bwd_cuda(cot, idx, n)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(d3, d1)

    leaf = table.clone().requires_grad_()
    (ga,) = torch.autograd.grad(tsel.small_lut(idx, n)(leaf), leaf, cot)
    assert torch.equal(ga, d1)


@pytest.mark.parametrize("kind", ["uniform", "one row", "runs"])
@pytest.mark.parametrize("n,width,lanes", [
    (1, 3, 3000), (8192, 3, 65536), (29791, 8, 32768 + 5),
    (9047075, 3, 65536), (65, 3, 1024), (300, 5, 1025), (2**20 + 3, 1,
                                                          200000)])
def test_large_bwd_radix_order_and_sorted_route(cuda, n, width, lanes, kind):
    """nart_lut_large_bwd's radix sort leaves, in its scratch, the clamped
    rows in torch.sort(stable=True)'s order with its permutation (and
    radix_order_plain's); its sums have the bits of the sorted route on
    that permutation (torch.sort, then nart_lut_large_bwd_sorted: the
    same segmented sum and carry)."""
    g = np.random.default_rng(n + lanes + width)
    idx = torch.from_numpy(_large_case(kind, n, lanes, g)).to(cuda)
    cot = torch.from_numpy(
        g.normal(size=(lanes, width)).astype(np.float32)).to(cuda)
    d, keys, order = tsel.lut_gather_large_bwd_order_cuda(cot, idx, n)
    want_keys, perm = torch.sort(idx.clamp(0, n - 1).to(torch.int32),
                                 stable=True)
    d_sorted = tsel.lut_gather_large_bwd_sorted_cuda(cot, want_keys, perm, n)
    plain_keys, plain_order = tsel.radix_order_plain(idx, n)
    torch.cuda.synchronize()
    assert torch.equal(keys, want_keys)
    assert torch.equal(order.long(), perm)
    assert torch.equal(keys, plain_keys) and torch.equal(order, plain_order)
    assert torch.equal(d, d_sorted)


def test_many_table_forward_against_single_launches(cuda):
    """nart_lut_gather_many: 16 tables of 1 to 8 values (some of 4 and 8
    read as float4, one a view 4 bytes off alignment, read as floats) in
    one launch have the bits of one launch a table and of the plain
    gathers, also from a CUDA graph's replay; one launch counted."""
    g = np.random.default_rng(16)
    lanes, n = 65536 + 17, 37
    idx = torch.from_numpy(g.integers(-3, n + 3, lanes)).to(cuda)
    widths = (1, 2, 3, 4, 5, 6, 7, 8, 3, 1, 4, 8, 2, 3, 1, 8)
    tables = [torch.from_numpy(g.normal(size=(n, w) if w > 1 else (n,))
                               .astype(np.float32)).to(cuda) for w in widths]
    tables[11] = torch.from_numpy(g.normal(size=n * 8 + 1).astype(
        np.float32)).to(cuda)[1:].view(n, 8)  # 4 bytes off alignment
    before = cuda_build.launch_counts["lut_gather"]
    outs = tsel.lut_gather_many_cuda(tables, idx)
    assert cuda_build.launch_counts["lut_gather"] == before + 1
    singles = [tsel.lut_gather_cuda(t, idx) for t in tables]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsel.lut_gather_many_cuda(tables, idx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tsel.lut_gather_many_cuda(tables, idx)
    graph.replay()
    torch.cuda.synchronize()
    ci = idx.clamp(0, n - 1)
    for t, o, o1, oc in zip(tables, outs, singles, captured):
        assert torch.equal(o, t[ci])
        assert torch.equal(o, o1) and torch.equal(o, oc)


def test_many_table_wrapper_refuses(cuda):
    """The many-table wrapper refuses more than MAX_TABLES tables, a table
    on another device than idx, a non-contiguous table and rows of more
    than 8 values."""
    idx = torch.zeros(64, dtype=torch.int64, device=cuda)
    t = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="tables"):
        tsel.lut_gather_many_cuda([t] * (tsel.MAX_TABLES + 1), idx)
    with pytest.raises(ValueError, match="is on"):
        tsel.lut_gather_many_cuda([t, t.cpu()], idx)
    with pytest.raises(ValueError, match="contiguous"):
        tsel.lut_gather_many_cuda([t, torch.zeros(3, 4, device=cuda).T], idx)
    with pytest.raises(ValueError, match="rows of 9"):
        tsel.lut_gather_many_cuda([t, torch.zeros(4, 9, device=cuda)], idx)


def _graph_nodes(fn):
    """The nodes of a CUDA graph that captures one call of fn (after a warm
    call on a side stream), by cuGraphGetNodes on the kept graph."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    assert ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None,
        ctypes.byref(count)) == 0
    return count.value


@pytest.mark.parametrize("mix", ["16 tables", "largest", "make_bsdf",
                                 "make_bsdf, 2^20 lanes"])
def test_many_table_backward_against_the_two_launch_route(cuda, mix):
    """nart_lut_gather_bwd_many: every table's sums have the bits of the
    two-launch route (nart_lut_gather_bwd, one table a call), integer
    cotangents' sums the int64 index_add_'s, the same bits on a second
    launch and from a CUDA graph's replay, one launch counted as
    "lut_gather_bwd", one kernel node a call.  16 tables of 1 to 64 rows
    of 1 to 4 values; the largest (16 tables of 64 rows of 4: 128 KB of
    warp slots, above the 48 KB a launch gets without opting in);
    make_bsdf's five (3 rows), also on 2^20 lanes: more 512-lane ranges
    than blocks fit the card at once, so a block sums several."""
    g = np.random.default_rng(len(mix))
    lanes = 2**20 + 17 if "2^20" in mix else 65536 + 17
    shapes = {"16 tables": [(int(r), int(w)) for r, w in zip(
                  g.integers(1, 65, 16), g.integers(1, 5, 16))],
              "largest": [(64, 4)] * 16}.get(
                  mix, [(3, 3), (3, 3), (3, 3), (3, 1), (3, 1)])
    rows = [n for n, _ in shapes]
    idx = torch.from_numpy(g.integers(-3, max(rows) + 3, lanes)).to(cuda)
    cots = [torch.from_numpy(g.normal(size=(lanes, w) if w > 1 else lanes)
                             .astype(np.float32)).to(cuda)
            for _, w in shapes]
    ints = [torch.from_numpy(g.integers(-8, 9, c.shape)).to(cuda)
            for c in cots]
    before = dict(cuda_build.launch_counts)
    d1 = tsel.lut_gather_bwd_many_cuda(cots, idx, rows)
    assert cuda_build.launch_counts["lut_gather_bwd"] == (
        before["lut_gather_bwd"] + 1)
    d2 = tsel.lut_gather_bwd_many_cuda(cots, idx, rows)
    d_int = tsel.lut_gather_bwd_many_cuda([x.float() for x in ints], idx,
                                          rows)
    refs = [tsel.lut_gather_bwd_cuda(c, idx.clamp(0, n - 1), n)
            for c, n in zip(cots, rows)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsel.lut_gather_bwd_many_cuda(cots, idx, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d3 = tsel.lut_gather_bwd_many_cuda(cots, idx, rows)
    graph.replay()
    torch.cuda.synchronize()
    for k, n in enumerate(rows):
        ci = idx.clamp(0, n - 1)
        assert torch.equal(d1[k], refs[k]), (k, n)
        assert torch.equal(d1[k], d2[k]) and torch.equal(d1[k], d3[k])
        want = torch.zeros((n,) + tuple(ints[k].shape[1:]), dtype=torch.int64,
                           device=cuda).index_add_(0, ci, ints[k])
        assert torch.equal(d_int[k], want.float())
    assert _graph_nodes(
        lambda: tsel.lut_gather_bwd_many_cuda(cots, idx, rows)) == 1


def test_many_table_backward_refuses(cuda):
    """The many-table backward's wrapper refuses more than MAX_TABLES
    tables, rows of more than 4 values, tables of more than 64 rows, a
    cotangent on another device than idx or of other lanes."""
    idx = torch.zeros(64, dtype=torch.int64, device=cuda)
    g = torch.zeros(64, 3, device=cuda)
    for grads, rows in (([g] * (tsel.MAX_TABLES + 1), [4] * 17),
                        ([g, torch.zeros(64, 5, device=cuda)], [4, 4]),
                        ([g], [tsel.AUTO_LUT_ROWS + 1]),
                        ([g, g.cpu()], [4, 4]),
                        ([g, g[:32]], [4, 4])):
        with pytest.raises(ValueError):
            tsel.lut_gather_bwd_many_cuda(grads, idx, rows)


# ---------------------------------------------------------------------------
# B1: the LBVH walk (csrc/bvh_walk.cu) against the plain walk
# ---------------------------------------------------------------------------


def _check_bvh(rays, tree):
    """The kernel's closest hit and occlusion against the plain walk's:
    triangle ids on >= 99.99% of rays, t/u/v to rtol 1e-4 / atol 1e-5
    where they agree, occlusion the closest hit's validity exactly; one
    launch each; and both entries the bits of the reference kernel
    (nart_bvh_hit_ref, the walk's first design) on every ray.  Returns
    (kernel Hit, plain Hit)."""
    from nart_tpu_torch import bvh as tbvh

    before = dict(cuda_build.launch_counts)
    hk = tbvh.intersect_bvh(*rays, tree)
    occ = tbvh.occluded_bvh(*rays, tree)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["bvh_hit"] == before["bvh_hit"] + 2
    href = tbvh.bvh_hit_ref_cuda(*rays, tree)
    occ_ref = tbvh.bvh_hit_ref_cuda(*rays, tree, any_hit=True)
    assert (cuda_build.launch_counts["bvh_hit_reference"]
            == before["bvh_hit_reference"] + 2)
    assert all(torch.equal(a, b) for a, b in zip(hk, href))
    assert torch.equal(occ, occ_ref)
    hp = tbvh.intersect_bvh_plain(*rays, tree)
    agree = hk.tri == hp.tri
    assert agree.float().mean() >= 0.9999
    both = agree & (hp.tri >= 0)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hk, k)[both], getattr(hp, k)[both],
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(occ, hk.tri >= 0)
    assert torch.isinf(hk.t[hk.tri < 0]).all()
    return hk, hp


@pytest.mark.parametrize("n_tris", [1, 40, 40000])
def test_bvh_kernel_matches_plain_on_soups(cuda, n_tris):
    """Soups of one leaf's worth and less (1, 40 triangles: padding rows)
    and 40,000 (depth 13); 4,099 rays (not a multiple of 32), a quarter
    parked with t_max = 0."""
    from nart_tpu_torch import bvh as tbvh

    rng = np.random.default_rng(n_tris)
    tree = tbvh.build_bvh(_soup(n_tris, rng)).to(cuda)
    rays = _rays(4099, rng, cuda)
    hk, hp = _check_bvh(rays, tree)
    if n_tris > 1:
        assert (hp.tri >= 0).sum() > 0
    parked = rays[3] == 0.0
    assert not (hk.tri[parked] >= 0).any()


def test_bvh_kernel_axis_aligned_rays(cuda):
    """Directions along the axes (the 1e-30 guard of the slab test) and
    with one zero component, both signs."""
    from nart_tpu_torch import bvh as tbvh

    rng = np.random.default_rng(11)
    tri = _soup(700, rng)
    tree = tbvh.build_bvh(tri).to(cuda)
    n = 1029
    d = np.eye(3, dtype=np.float32)[np.arange(n) % 3] * np.where(
        np.arange(n) % 2, 1.0, -1.0)[:, None].astype(np.float32)
    tilt = rng.normal(size=(n, 3)).astype(np.float32)
    tilt[np.arange(n), (np.arange(n) + 1) % 3] = 0.0
    d[n // 2:] = tilt[n // 2:] / np.linalg.norm(tilt[n // 2:], axis=-1,
                                                keepdims=True)
    # origins beside the soup, aimed back across it
    target = tri[rng.integers(0, len(tri), n)].mean(1)
    o = (target - d * 20.0).astype(np.float32)
    rays = (torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda),
            torch.zeros(n, device=cuda),
            torch.full((n,), float("inf"), device=cuda))
    _, hp = _check_bvh(rays, tree)
    assert (hp.tri >= 0).float().mean() > 0.5


@pytest.mark.parametrize("copies", [1, 5, 40], ids=lambda c: f"x{c}")
def test_bvh_kernel_ties(cuda, copies):
    """Two triangles with a common edge, each stored `copies` times (in one
    leaf or across leaves), and rays through the edge and either face:
    equal t within a leaf (the lowest index wins) and across leaves (the
    first found wins): the plain walk's triangle and t on every ray."""
    from nart_tpu_torch import bvh as tbvh

    quad = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[1, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    tree = tbvh.build_bvh(np.repeat(quad, copies, axis=0)).to(cuda)
    rng = np.random.default_rng(copies)
    n = 4096
    s = rng.random(n).astype(np.float32)
    on_edge = np.stack([1 - s, s, np.zeros(n, np.float32)], 1)
    anywhere = np.concatenate([rng.random((n, 2)), np.zeros((n, 1))], 1)
    target = np.where((np.arange(n) % 2 == 0)[:, None], on_edge,
                      anywhere).astype(np.float32)
    o = (target + rng.normal(size=(n, 3)) * [0.5, 0.5, 0.0]
         + [0, 0, 3]).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = (torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda),
            torch.zeros(n, device=cuda),
            torch.full((n,), float("inf"), device=cuda))
    hk, hp = _check_bvh(rays, tree)
    assert (hp.tri >= 0).sum() > n // 2
    assert torch.equal(hk.tri, hp.tri) and torch.equal(hk.t, hp.t)


def test_bvh_kernel_scalar_windows(cuda):
    """t_min and t_max given as one value for every ray, as (N,) tensors
    would give them; t_max = 0 for all: no hit, no occlusion."""
    from nart_tpu_torch import bvh as tbvh

    rng = np.random.default_rng(12)
    tree = tbvh.build_bvh(_soup(300, rng)).to(cuda)
    o, d, _, _ = _rays(777, rng, cuda)
    zero = torch.zeros((), device=cuda)
    for t_max in (float("inf"), 6.0, 0.0):
        full = torch.full((777,), t_max, device=cuda)
        hk = tbvh.intersect_bvh(o, d, zero, torch.tensor(t_max, device=cuda),
                                tree)
        hv = tbvh.intersect_bvh(o, d, torch.zeros(777, device=cuda), full,
                                tree)
        assert all(torch.equal(a, b) for a, b in zip(hk, hv))
        href = tbvh.bvh_hit_ref_cuda(o, d, zero,
                                     torch.tensor(t_max, device=cuda), tree)
        assert all(torch.equal(a, b) for a, b in zip(hk, href))
        _check_bvh((o, d, zero, full), tree)
        if t_max == 0.0:
            assert not (hk.tri >= 0).any()
            assert not tbvh.occluded_bvh(o, d, zero, full, tree).any()


def test_bvh_kernel_refuses(cuda):
    """A tree deeper than the kernel's stack is refused before any launch
    (the stack's depth is the library's), and so are inputs the kernel
    does not take, packed arrays off their 16-byte alignment among
    them."""
    from dataclasses import replace

    from nart_tpu_torch import bvh as tbvh

    rng = np.random.default_rng(13)
    tree = tbvh.build_bvh(_soup(50, rng)).to(cuda)
    o, d, t_min, t_max = _rays(64, rng, cuda)
    assert tbvh._kernel_lib().nart_bvh_max_depth() == tbvh.MAX_DEPTH
    before = dict(cuda_build.launch_counts)
    with pytest.raises(ValueError, match="depth"):
        tbvh.intersect_bvh(o, d, t_min, t_max,
                           replace(tree, depth=tbvh.MAX_DEPTH + 1))
    with pytest.raises(TypeError):
        tbvh.bvh_hit_cuda(o.double(), d, t_min, t_max, tree)
    with pytest.raises(ValueError):
        tbvh.bvh_any_cuda(o, d, t_min, t_max, tree.to("cpu"))
    # the packed arrays are read as float4: a view off 16 bytes is refused
    for name in ("node_pairs", "tri_rec"):
        x = getattr(tree, name)
        buf = torch.empty(x.numel() + 1, device=cuda)
        off = buf[1:].view(x.shape)
        off.copy_(x)
        with pytest.raises(ValueError, match="aligned"):
            tbvh.intersect_bvh(o, d, t_min, t_max, replace(tree, **{name: off}))
    assert cuda_build.launch_counts == before


# the BSDF kernels (csrc/bsdf.cu): X3's tolerance against the float64 VJP
BSDF_RTOL, BSDF_ATOL = 1e-5, 1e-6


def _bsdf_set(kind, n, seed, dev):
    """bsdf_lane_set's lanes: (desc, the other inputs)."""
    x = bsdf_lane_set(kind, n, seed, dev)
    return x.pop("desc"), x


def _f64(x):
    from nart_tpu_torch import bxdf

    if isinstance(x, bxdf.BsdfDesc):
        return bxdf.BsdfDesc(*[_f64(t) for t in x])
    return x.double() if x.dtype == torch.float32 else x


def _same_bits(got, want):
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _x3_close(got, f_fwd, ref, f_ref):
    """X3 against the float64 VJP on the lanes whose float64 forward takes
    the float32 forward's branches and whose float64 VJP is finite (nearly
    all); returns those lanes' count."""
    n = f_fwd.shape[0]
    f32 = f_fwd.double()
    use = (torch.isclose(f_ref, f32, rtol=1e-3, atol=1e-5)
           & ((f_ref == 0.0) == (f32 == 0.0))).all(-1)
    for r in ref:
        use &= torch.isfinite(r).reshape(n, -1).all(-1)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.double().reshape(n, -1)[use],
                                   b.reshape(n, -1)[use], rtol=BSDF_RTOL,
                                   atol=BSDF_ATOL)
    return int(use.sum())


@pytest.mark.parametrize("kind", sorted(BSDF_LOBES))
def test_bsdf_kernels_match_plain(cuda, kind):
    """X1 and X2 give the plain version's bits on every lane (one launch
    each); X3 in both modes is within rtol 1e-5 / atol 1e-6 of the float64
    VJP of the plain version with wi held fixed."""
    from nart_tpu_torch import bsdf_ops

    n = 8192
    desc, x = _bsdf_set(kind, n, len(kind), cuda)
    args = (x["u1"], x["u2"], x["use_prime"], x["eta_outer"],
            x["prev_flags"])
    before = dict(cuda_build.launch_counts)
    got = bsdf_ops.sample_cuda(desc, x["wo"], *args)
    ev = bsdf_ops.eval_cuda(desc, x["wo"], x["wi"], x["use_prime"],
                            x["eta_outer"])
    torch.cuda.synchronize()
    _same_bits(got[:6], bsdf_ops.sample_plain(desc, x["wo"], *args))
    _same_bits(ev, bsdf_ops.eval_plain(desc, x["wo"], x["wi"],
                                       x["use_prime"], x["eta_outer"]))
    x3s = bsdf_ops.f_bwd_cuda("sample", desc, x["wo"], got[1],
                              x["use_prime"], x["eta_outer"], x["g_f"],
                              x["g_alpha_i"], x["g_eta_sampled"], u2=x["u2"],
                              prev_flags=x["prev_flags"], bits=got[6])
    x3e = bsdf_ops.f_bwd_cuda("eval", desc, x["wo"], x["wi"],
                              x["use_prime"], x["eta_outer"], x["g_f"])
    grew = {k: cuda_build.launch_counts[k] - before[k]
            for k in ("bsdf_sample", "bsdf_sample_eval", "bsdf_eval",
                      "bsdf_f_bwd")}
    assert grew == {"bsdf_sample": 1, "bsdf_sample_eval": 0, "bsdf_eval": 1,
                    "bsdf_f_bwd": 2}
    at = (_f64(desc), _f64(x["wo"]), _f64(got[1]), _f64(x["u1"]),
          _f64(x["u2"]), x["use_prime"], _f64(x["eta_outer"]),
          x["prev_flags"], got[3])
    ref = bsdf_ops.sample_at_bwd_plain(*at, *[_f64(x[k]) for k in (
        "g_f", "g_alpha_i", "g_eta_sampled")])
    assert _x3_close(x3s, got[0], ref,
                     bsdf_ops.sample_at_plain(*at)[0]) >= 0.99 * n
    at = (_f64(desc), _f64(x["wo"]), _f64(x["wi"]), x["use_prime"],
          _f64(x["eta_outer"]))
    ref = bsdf_ops.eval_bwd_plain(*at, _f64(x["g_f"]))
    assert _x3_close(x3e, ev[0], ref,
                     bsdf_ops.eval_plain(*at)[0]) >= 0.99 * n


def test_bsdf_functions_launch_the_kernels(cuda):
    """The Functions on CUDA tensors: X1 and X2 forward, X3 backward (one
    launch each a call), the gradients X3's, wi, pdf and flags without a
    gradient, and a wi that requires grad refused; X1 from a CUDA graph's
    replay gives the eager launch's bits."""
    from nart_tpu_torch import bsdf_ops

    desc, x = _bsdf_set("plastic", 4096, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in
              bsdf_ops._diff(desc, x["wo"], x["eta_outer"])]
    d, wo, eo = bsdf_ops._with_diff(desc, leaves)
    before = dict(cuda_build.launch_counts)
    f, wi, pdf, flags, alpha_i, eta_s = bsdf_ops.sample_f(
        d, wo, x["u1"], x["u2"], x["use_prime"], eo, x["prev_flags"])
    assert not (wi.requires_grad or pdf.requires_grad or flags.requires_grad)
    got = torch.autograd.grad((f, alpha_i, eta_s), leaves,
                              (x["g_f"], x["g_alpha_i"], x["g_eta_sampled"]))
    bits = bsdf_ops.sample_cuda(desc, x["wo"], x["u1"], x["u2"],
                                x["use_prime"], x["eta_outer"],
                                x["prev_flags"])[6]
    want = bsdf_ops.f_bwd_cuda("sample", desc, x["wo"], wi, x["use_prime"],
                               x["eta_outer"], x["g_f"], x["g_alpha_i"], x["g_eta_sampled"],
                               u2=x["u2"], prev_flags=x["prev_flags"],
                               bits=bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    f2, pdf2 = bsdf_ops.eval_f_pdf(d, wo, wi, x["use_prime"], eo)
    torch.autograd.grad(f2.sum(), leaves)
    grew = {k: cuda_build.launch_counts[k] - before[k]
            for k in ("bsdf_sample", "bsdf_sample_eval", "bsdf_eval",
                      "bsdf_f_bwd")}
    assert grew == {"bsdf_sample": 2, "bsdf_sample_eval": 0, "bsdf_eval": 1,
                    "bsdf_f_bwd": 3}
    with pytest.raises(ValueError, match="wi must not require grad"):
        bsdf_ops.eval_f_pdf(d, wo, wi.clone().requires_grad_(),
                            x["use_prime"], eo)
    args = (desc, x["wo"], x["u1"], x["u2"], x["use_prime"],
            x["eta_outer"], x["prev_flags"])
    eager = bsdf_ops.sample_cuda(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bsdf_ops.sample_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bsdf_ops.sample_cuda(*args)
    graph.replay()
    torch.cuda.synchronize()
    _same_bits(out, eager)


@pytest.mark.parametrize("kind", sorted(BSDF_LOBES))
def test_bsdf_sample_eval_against_x1_and_x2(cuda, kind):
    """The sample+eval launch (X2's redesign, nart_bsdf_sample_eval) gives
    X1's seven outputs and X2's first design's two at wi_b bit for bit on
    every lane, and the plain versions' (sample_eval_plain), one launch a
    call, also from a CUDA graph's replay.  Through sample_eval_f its
    gradients are X3's "sample" and "eval" rows summed, one
    bsdf_sample_eval and two bsdf_f_bwd launches, none of X1 or X2; a
    wi_b that requires grad is refused."""
    from nart_tpu_torch import bsdf_ops

    n = 8192
    desc, x = _bsdf_set(kind, n, 31 + len(kind), cuda)
    up, eo = x["use_prime"], x["eta_outer"]
    args = (desc, x["wo"], x["u1"], x["u2"], up, eo, x["prev_flags"])
    before = dict(cuda_build.launch_counts)
    got = bsdf_ops.sample_eval_cuda(*args, x["wi"])
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["bsdf_sample_eval"] == (
        before["bsdf_sample_eval"] + 1)
    _same_bits(got, (*bsdf_ops.sample_cuda(*args),
                     *bsdf_ops.eval_cuda(desc, x["wo"], x["wi"], up, eo)))
    _same_bits(got[:6] + got[7:],
               bsdf_ops.sample_eval_plain(*args, x["wi"]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bsdf_ops.sample_eval_cuda(*args, x["wi"])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = bsdf_ops.sample_eval_cuda(*args, x["wi"])
    graph.replay()
    torch.cuda.synchronize()
    _same_bits(replayed, got)

    leaves = [t.clone().requires_grad_() for t in
              bsdf_ops._diff(desc, x["wo"], eo)]
    d, wo, eo_l = bsdf_ops._with_diff(desc, leaves)
    g_f_b = x["g_f"].flip(0).contiguous()
    before = dict(cuda_build.launch_counts)
    out = bsdf_ops.sample_eval_f(d, wo, x["u1"], x["u2"], up, eo_l,
                                 x["prev_flags"], x["wi"])
    _same_bits(out, got[:6] + got[7:])
    grads = torch.autograd.grad(
        (out[0], out[4], out[5], out[6]), leaves,
        (x["g_f"], x["g_alpha_i"], x["g_eta_sampled"], g_f_b))
    grew = {k: cuda_build.launch_counts[k] - before[k]
            for k in ("bsdf_sample", "bsdf_sample_eval", "bsdf_eval",
                      "bsdf_f_bwd")}
    assert grew == {"bsdf_sample": 0, "bsdf_sample_eval": 1, "bsdf_eval": 0,
                    "bsdf_f_bwd": 2}
    g_s = bsdf_ops.f_bwd_cuda("sample", desc, x["wo"], got[1], up, eo,
                              x["g_f"], x["g_alpha_i"], x["g_eta_sampled"],
                              u2=x["u2"], prev_flags=x["prev_flags"],
                              bits=got[6])
    g_e = bsdf_ops.f_bwd_cuda("eval", desc, x["wo"], x["wi"], up, eo, g_f_b)
    for a, b, c in zip(grads, g_s, g_e):
        assert torch.equal(a, b + c)
    with pytest.raises(ValueError, match="wi_b must not require grad"):
        bsdf_ops.sample_eval_f(d, wo, x["u1"], x["u2"], up, eo_l,
                               x["prev_flags"],
                               x["wi"].clone().requires_grad_())


def test_bsdf_x3_finite_where_the_plain_vjp_is_not(cuda):
    """Grazing mirror lanes at alpha 1e-4, where the plain VJP, which
    differentiates every lobe kind and selects after, gave NaN before its
    lobes were guarded (bxdf._guard; ROADMAP section 3): now it is finite
    and zero there, and X3, a lane's own lobes only, zeros too."""
    from nart_tpu_torch import bsdf_ops

    n = 256
    desc, x = _bsdf_set("mirror", n, 5, cuda)
    desc = desc._replace(alpha0=torch.full((n,), 1e-4, device=cuda),
                         alpha_prime=torch.full((n,), 1e-4, device=cuda))
    wo, wi = x["wo"].clone(), x["wi"].clone()
    wo[:, 2] = 1e-9
    wi[:, 2] = torch.logspace(-12, -3, n, device=cuda)
    up = torch.ones(n, dtype=torch.bool, device=cuda)
    plain = bsdf_ops.eval_bwd_plain(desc, wo, wi, up, x["eta_outer"],
                                    x["g_f"])
    x3 = bsdf_ops.f_bwd_cuda("eval", desc, wo, wi, up, x["eta_outer"],
                             x["g_f"])
    for a in plain:
        assert bool(torch.isfinite(a).all())
    assert not bool(plain[5].any())
    for a in x3:
        assert torch.equal(a, torch.zeros_like(a))


def _x3_every_lane(got, f_fwd, ref, f_ref):
    """X3 against the float64 VJP, finite on every lane: within rtol 1e-5 /
    atol 1e-6 on every lane whose float64 forward takes the float32
    forward's branches; returns those lanes' count."""
    n = f_fwd.shape[0]
    f32 = f_fwd.double()
    use = (torch.isclose(f_ref, f32, rtol=1e-3, atol=1e-5)
           & ((f_ref == 0.0) == (f32 == 0.0))).all(-1)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(b).all())
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.double().reshape(n, -1)[use],
                                   b.reshape(n, -1)[use], rtol=BSDF_RTOL,
                                   atol=BSDF_ATOL)
    return int(use.sum())


@pytest.mark.parametrize("kind", sorted(BSDF_LOBES))
def test_bsdf_redesign_against_first_design(cuda, kind, record_property):
    """X1 (redesigned: no local memory) has the bits of its first design,
    nart_bsdf_sample_ref, and of the plain version on every lane; X3
    (redesigned: one reciprocal a division, FMA derivatives, no local
    memory) is within rtol 1e-5 / atol 1e-6 of the float64 VJP on
    every lane of the float32 branches, in both modes; the share of its
    values with the first design's bits is recorded.  The references count
    as launches of their own."""
    from nart_tpu_torch import bsdf_ops

    n = 8192
    desc, x = _bsdf_set(kind, n, 17 + len(kind), cuda)
    args = (desc, x["wo"], x["u1"], x["u2"], x["use_prime"], x["eta_outer"],
            x["prev_flags"])
    before = dict(cuda_build.launch_counts)
    got = bsdf_ops.sample_cuda(*args)
    ref = bsdf_ops.sample_ref_cuda(*args)
    _same_bits(got, ref)
    _same_bits(got[:6], bsdf_ops.sample_plain(*args))
    cots = (x["g_f"], x["g_alpha_i"], x["g_eta_sampled"])
    bwd = ("sample", desc, x["wo"], got[1], x["use_prime"], x["eta_outer"],
           *cots)
    kw = dict(u2=x["u2"], prev_flags=x["prev_flags"], bits=got[6])
    x3, x3_ref = (bsdf_ops.f_bwd_cuda(*bwd, **kw),
                  bsdf_ops.f_bwd_ref_cuda(*bwd, **kw))
    at = (_f64(desc), _f64(x["wo"]), _f64(got[1]), _f64(x["u1"]),
          _f64(x["u2"]), x["use_prime"], _f64(x["eta_outer"]),
          x["prev_flags"], got[3])
    f64_vjp = bsdf_ops.sample_at_bwd_plain(*at, *[_f64(c) for c in cots])
    assert _x3_every_lane(x3, got[0], f64_vjp,
                          bsdf_ops.sample_at_plain(*at)[0]) >= 0.99 * n
    e_args = (desc, x["wo"], x["wi"], x["use_prime"], x["eta_outer"],
              x["g_f"])
    e3, e3_ref = (bsdf_ops.f_bwd_cuda("eval", *e_args),
                  bsdf_ops.f_bwd_ref_cuda("eval", *e_args))
    at = (_f64(desc), _f64(x["wo"]), _f64(x["wi"]), x["use_prime"],
          _f64(x["eta_outer"]))
    assert _x3_every_lane(
        e3, bsdf_ops.eval_cuda(*e_args[:5])[0],
        bsdf_ops.eval_bwd_plain(*at, _f64(x["g_f"])),
        bsdf_ops.eval_plain(*at)[0]) >= 0.99 * n
    record_property("x3_first_design_bit_share",
                    (bit_share(x3, x3_ref), bit_share(e3, e3_ref)))
    grew = {k: cuda_build.launch_counts[k] - before[k]
            for k in ("bsdf_sample", "bsdf_sample_reference", "bsdf_f_bwd",
                      "bsdf_f_bwd_reference")}
    assert grew == {"bsdf_sample": 1, "bsdf_sample_reference": 1,
                    "bsdf_f_bwd": 2, "bsdf_f_bwd_reference": 2}


@pytest.mark.parametrize("variant", ["as built", "1-3"])
def test_bsdf_outputs_do_not_depend_on_lane_order(cuda, variant,
                                                  monkeypatch):
    """Lanes of every BSDF_LOBES kind shuffled together (mixed lobes in
    every block), and the same lanes permuted again: X1's and X3's (both
    modes) per-lane outputs are permuted with them, bit for bit, from the
    kernels as built (one thread a lane) and from kernel_variants' "1-3",
    whose blocks regroup their lanes by lobe (step 3, measured and not
    taken: a thread computes its block's lane at its sorted slot), which
    also keeps the built kernels' bits: no lane's result depends on its
    position or its block's other lanes."""
    import ctypes

    from nart_tpu_torch import bsdf_ops, bxdf
    from nart_tpu_torch import kernel_variants as kv

    parts = [_bsdf_set(k, 1000, i, cuda) for i, k in
             enumerate(sorted(BSDF_LOBES))]
    g = torch.Generator().manual_seed(3)
    order = torch.randperm(1000 * len(parts), generator=g).to(cuda)

    def cat(idx):
        desc = bxdf.BsdfDesc(*[torch.cat([p[0][f] for p in parts])[idx]
                               .contiguous() for f in range(8)])
        return desc, {k: torch.cat([p[1][k] for p in parts])[idx]
                      .contiguous() for k in parts[0][1]}

    def run(desc, x):
        s = bsdf_ops.sample_cuda(desc, x["wo"], x["u1"], x["u2"],
                                 x["use_prime"], x["eta_outer"],
                                 x["prev_flags"])
        b = bsdf_ops.f_bwd_cuda(
            "sample", desc, x["wo"], s[1], x["use_prime"], x["eta_outer"],
            x["g_f"], x["g_alpha_i"], x["g_eta_sampled"], u2=x["u2"],
            prev_flags=x["prev_flags"], bits=s[6])
        e = bsdf_ops.f_bwd_cuda("eval", desc, x["wo"], x["wi"],
                                x["use_prime"], x["eta_outer"], x["g_f"])
        return (*s, *b, *e)

    built = run(*cat(order))
    if variant != "as built":
        so, _ = kv._build(f"bsdf {variant}",
                          kv.variant_sources("bsdf")[variant])
        lib = ctypes.CDLL(so)
        monkeypatch.setattr(cuda_build, "load", lambda _name: lib)
    first = run(*cat(order))
    _same_bits(first, built)
    perm = torch.randperm(order.numel(), generator=g).to(cuda)
    again = run(*cat(order[perm]))
    _same_bits(again, [t[perm] for t in first])
