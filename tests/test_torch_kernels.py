"""CUDA kernels (nart_tpu_torch/csrc/cluster_hit.cu) vs their plain
PyTorch versions, on the card.

Marked ``gpu``: each test skips (with its reason) when no CUDA device is
present, deciding inside the fixture, never at import.  Run them on a
machine with a card with ``python -m pytest tests/test_torch_kernels.py``.
Criteria (as chip_smoke.py): triangle ids agree on >= 99.99% of rays,
t/u/v to rtol 1e-4 / atol 1e-5 where they agree, any-hit equal to
closest-hit validity exactly; the counter kernel's counters equal to its
plain version's on every ray.
"""

import os

import numpy as np
import pytest
import torch

from nart_tpu_torch import cluster_accel as ca

pytestmark = pytest.mark.gpu

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")


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
    before = dict(ca.launch_counts)
    hk = ca.intersect_clusters(*rays, acc)
    occ = ca.intersect_clusters_any(*rays, acc)
    torch.cuda.synchronize()
    assert ca.launch_counts["closest_hit"] == before["closest_hit"] + 1
    assert ca.launch_counts["any_hit"] == before["any_hit"] + 1
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


@pytest.mark.parametrize("n_tris,kw", [
    (5, {}), (700, {"super_target": 2}), (40000, {}),
])
def test_stats_kernel_matches_plain(cuda, n_tris, kw):
    """The counter kernel: counters equal to the plain walk's on every ray,
    t equal to the closest-hit kernel's, and the lanes it saw together on
    a cluster no more than a warp that never diverged would reach."""
    from nart_tpu_torch import kernel_stats

    rng = np.random.default_rng(n_tris)
    acc = ca.build_clusters(_soup(n_tris, rng), **kw).to(cuda)
    rays = _rays(4096, rng, cuda)
    before = ca.launch_counts["closest_hit_stats"]
    sk = kernel_stats.traversal_stats(*rays, acc)
    torch.cuda.synchronize()
    assert ca.launch_counts["closest_hit_stats"] == before + 1
    sp = ca.closest_hit_stats_plain(*rays, acc)
    for k in ("visited", "slabs", "tested"):
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
    assert torch.equal(sk.t, ca.intersect_clusters(*rays, acc).t)
    assert torch.equal(sk.t, sp.t)
    assert (sk.together >= sk.tested).all()
    assert (sk.together <= sp.together).all()


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
