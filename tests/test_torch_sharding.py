"""nart_tpu_torch.sharding on the CPU: virtual ranks and two gloo
processes (the JAX package's sharded films and gradients are in
tests/test_torch_sharding_jax.py).

Every item keeps its global RNG stream, so the films of the ranks of any
Layout sum to the one-process film up to the association of the sums
(atol 1e-6 / rtol 1e-6, tests/test_sharding.py's criterion), and the
shards' gradients to the one-process gradient (rtol 1e-5).  Lambert
simple_scene at 10x6 (8x8 for gradients), 3 bounces.

The two-process run spawns this module as its worker:

    python -m tests.test_torch_sharding --worker RANK PORT OUT.npz
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import sharding as tsharding
from nart_tpu_torch import testing as ttesting
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = [(2, 1), (8, 1), (2, 2), (4, 2), (1, 3)]
GW = GH = 8  # gradient image
GSPP = 2
LANES = 16


def _params(mod, spp, **kw):
    return mod.RenderParams(image_width=10, image_height=6, spp=spp,
                            bounces=3, filter_width=1.0, **kw)


def _gparams(mod, **kw):
    """The gradient tests' params: GW x GH, GSPP spp."""
    return dataclasses.replace(_params(mod, GSPP, **kw), image_width=GW,
                               image_height=GH)


def _session(spp, mode="balanced"):
    sc = ttesting.simple_scene(("lambert",))
    return trender.RenderSession(sc, _params(trender, spp, wavefront=mode),
                                 "cpu")


def _summed(sess, layout):
    """The films of every rank of a layout, summed, and the ranks' rays."""
    film = torch.zeros((sess.total_h, sess.total_w, 5))
    rays = 0
    for r in range(layout.world_size):
        f, stats = tsharding.render_shard(sess, layout, r)
        film += f
        rays += stats["rays"]
    return film, rays


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("spp", [2, 3])
@pytest.mark.parametrize("mode", ["balanced", "spp", "regen"])
def test_virtual_ranks_sum_to_one_process_film(mode, spp):
    """Layouts (2,1) (8,1) (2,2) (4,2) (1,3): 6 rows over 8 row ranks
    leaves ranks without rows; 3 spp over 2 slabs and 2 spp over 3 leave
    short and empty slabs.  The ranks' ray counts add up as well."""
    sess = _session(spp, mode)
    single = sess.render()
    assert single[..., 4].sum() > 0
    for shape in LAYOUTS:
        film, rays = _summed(sess, tsharding.Layout(*shape))
        _close(film, single)
        assert rays == sess.stats["rays"], shape


@pytest.mark.parametrize("integrator", ["path", "volume"])
def test_layout_of_one_is_the_session_film(integrator):
    """In "balanced", one rank traces the session's items in the session's
    chunks and splats them in its order: the same bits."""
    if integrator == "path":
        sess = _session(2)
    else:
        sc = ttesting.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5))
        sess = trender.RenderSession(sc, trender.RenderParams(
            image_width=8, image_height=8, spp=2, bounces=8,
            integrator="volume"), "cpu")
    film, _ = tsharding.render_shard(sess, tsharding.Layout(1, 1), 0)
    assert torch.equal(film, sess.render())


@pytest.mark.parametrize("mode", ["spp", "regen"])
def test_layout_of_one_is_the_session_film_per_pixel_modes(mode):
    """"spp"/"regen" shards trace whole rows with the session's own tracer
    (RenderSession.trace_chunk) and splat them with the strip splat: a
    layout of one is the session's film bit for bit, rays included."""
    sess = _session(3, mode)
    film, stats = tsharding.render_shard(sess, tsharding.Layout(1, 1), 0)
    assert torch.equal(film, sess.render())
    assert stats["rays"] == sess.stats["rays"]


def test_layout_and_strips():
    lay = tsharding.Layout(4, 2)
    assert lay.world_size == 8
    assert [lay.coords(r) for r in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0),
                                                     (3, 1)]
    with pytest.raises(ValueError):
        lay.coords(8)
    # 20 rows in strips of 8 (filter bounds 1), round-robin over 2 ranks
    two = tsharding.Layout(2, 1)
    assert tsharding.strips_of(two, 0, 20, 1) == [(0, 8), (16, 4)]
    assert tsharding.strips_of(two, 1, 20, 1) == [(8, 8)]
    # filter bounds 4: strips of 2 * 4 + 2 = 10 rows
    assert tsharding.strips_of(two, 1, 20, 4) == [(10, 10)]
    assert tsharding.strips_of(tsharding.Layout(1, 3), 0, 20, 1) == [(0, 20)]
    assert [tsharding.sample_slab(tsharding.Layout(1, 3), j, 2)
            for j in range(3)] == [(0, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("mode", ["balanced", "spp"])
def test_volume_virtual_ranks(mode):
    """The volume integrator on testing.medium_scene (the static machine in
    "balanced", the lockstep walk in "spp")."""
    sc = ttesting.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5))
    p = trender.RenderParams(image_width=8, image_height=8, spp=2,
                             bounces=8, integrator="volume", wavefront=mode)
    sess = trender.RenderSession(sc, p, "cpu")
    single = sess.render()
    assert single[..., 0].sum() > 0
    for shape in ((2, 1), (2, 2)):
        _close(_summed(sess, tsharding.Layout(*shape))[0], single)


def _grad_inputs():
    """simple_scene, its clusters, the 8x8 image's samples and cot = 1 on
    RGB."""
    ts = ttesting.simple_scene(("lambert",))
    acc = tca.build_clusters(ts.tri_v.numpy())
    samples = trender.image_samples(GW, GH, GW + 2, GSPP, "cpu")
    cot = torch.ones(samples.shape[:2] + (4,))
    cot[..., 3] = 0.0
    return ts, acc, samples, cot


def _leaves(theta):
    """The leaves of a parameter dict of either package, keys sorted."""
    out = []
    for k in sorted(theta):
        for v in (theta[k] if isinstance(theta[k], list) else [theta[k]]):
            if v is not None:
                out.append(v.detach().numpy() if torch.is_tensor(v)
                           else np.asarray(v))
    return out


def _shards_summed(layout, ts, acc, samples, cot):
    tp = _gparams(trender)
    loss, grads = 0.0, None
    for r in range(layout.world_size):
        l, g, _, _ = tsharding.radiance_weighted_loss_and_grad_shard(
            ts, tgrad.get_params(ts), acc, samples, cot, tp, GW, GH, layout,
            r, lanes=LANES, device="cpu")
        loss += float(l)
        g = _leaves(g)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    return loss, grads


def test_sharded_gradients_sum_to_one_process():
    """Layouts (2,1) (2,2) (4,2) (1,3): the shards' losses and gradients sum
    to the one-process call's (rtol 1e-5)."""
    ts, acc, samples, cot = _grad_inputs()
    tp = _gparams(trender)
    loss1, grads1, _, _ = tgrad.radiance_weighted_loss_and_grad(
        ts, tgrad.get_params(ts), acc, samples, cot, tp, GW, GH,
        lanes=LANES, device="cpu")
    assert grads1["rho_d_const"].abs().sum() > 0
    want = _leaves(grads1)
    for shape in ((2, 1), (2, 2), (4, 2), (1, 3)):
        loss, grads = _shards_summed(tsharding.Layout(*shape), ts, acc,
                                     samples, cot)
        np.testing.assert_allclose(loss, float(loss1), rtol=1e-5)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_gradient_leaves_flatten_and_rebuild():
    """grad.flatten_leaves / unflatten_like, the one buffer that the sharded
    gradient all-reduces: the rebuilt dict has theta's layout and values."""
    theta = tgrad.get_params(ttesting.simple_scene(("lambert",)))
    flat = tgrad.flatten_leaves(theta)
    want = _leaves(theta)
    assert flat.dim() == 1 and flat.numel() == sum(w.size for w in want)
    back = tgrad.unflatten_like(flat * 2.0, theta)
    assert sorted(back) == sorted(theta)
    for got, w in zip(_leaves(back), want):
        np.testing.assert_array_equal(got, w * 2.0)


def test_nccl_with_a_cpu_device_raises():
    with pytest.raises(ValueError):
        tsharding.init_distributed("tcp://127.0.0.1:1", 0, 1, backend="nccl",
                                   device="cpu")
    assert tsharding.is_primary()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the two-process gloo worker once; returns rank 0's results."""
    out = str(tmp_path_factory.mktemp("gloo") / "rank0.npz")
    port = str(_free_port())
    env = dict(os.environ,
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_sharding", "--worker",
         str(r), port, out], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    return np.load(out)


def test_two_processes_film_equals_virtual_ranks(two_ranks):
    film, _ = _summed(_session(2), tsharding.Layout(2, 1))
    np.testing.assert_allclose(two_ranks["film"], film.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_two_processes_gradient_equals_virtual_ranks(two_ranks):
    loss, grads = _shards_summed(tsharding.Layout(1, 2), *_grad_inputs())
    np.testing.assert_allclose(float(two_ranks["loss"]), loss, rtol=1e-6)
    flat = np.concatenate([g.reshape(-1) for g in grads])
    np.testing.assert_allclose(two_ranks["grads"], flat, rtol=1e-6,
                               atol=1e-8)


def _worker(rank, port, out):
    """One gloo rank: the sharded film (Layout(2, 1)) and the sharded
    gradient (Layout(1, 2)); rank 0 saves both."""
    torch.set_num_threads(1)
    dev = tsharding.init_distributed(f"tcp://127.0.0.1:{port}", rank, 2,
                                     device="cpu")
    assert str(dev) == "cpu" and torch.distributed.get_backend() == "gloo"
    film, _ = tsharding.render_sharded(_session(2), tsharding.Layout(2, 1))
    ts, acc, samples, cot = _grad_inputs()
    tp = _gparams(trender)
    loss, grads, _, _ = tsharding.radiance_weighted_loss_and_grad_sharded(
        ts, tgrad.get_params(ts), acc, samples, cot, tp, GW, GH,
        tsharding.Layout(1, 2), lanes=LANES, device="cpu")
    if tsharding.is_primary():
        np.savez(out, film=film.numpy(), loss=float(loss),
                 grads=np.concatenate([g.reshape(-1)
                                       for g in _leaves(grads)]))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
