"""nart_tpu_torch path-replay gradients (grad.py, path.trace_balanced_loss)
vs nart_tpu, on the CPU.

Both packages get the same scene (numpy arrays), the same Latin-square
samples and the same per-item RNG streams, so they trace the same paths.
Size: tests/test_grad.py's _setup (8x8, 2 spp, 3 bounces), with 16 work
slots so that the replay runs a dozen rounds with respawns.  The JAX side
traces with its plain brute-force intersector, the port with the plain
versions of its cluster queries.  Tolerances: losses rtol 1e-4 and gradient
leaves rtol 1e-3 / atol 1e-5 (float32 sums taken in another order; sin/cos
differ by an ulp between the libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import grad as jgrad
from nart_tpu import render as jrender
from nart_tpu import rng as jrng
from nart_tpu import sampling as jsamp
from nart_tpu import testing as jtesting
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

W = H = 8
SPP = 2
LANES = 16

def _textured():
    """simple_scene with a 4x4 albedo texture bound to its first mesh.  The
    texels are half floats, as the reference's textures are: the render
    path's half table and the gradient's float32 table then agree."""
    js = jtesting.simple_scene(("lambert",))
    tex = np.random.default_rng(3).uniform(0.2, 0.9, (16, 3)).astype(
        np.float16)
    rho_d_tex = np.array(js.rho_d_tex).copy()
    rho_d_tex[0] = 0
    return dataclasses.replace(
        js, rho_d_tex=rho_d_tex, tex_data=tex.astype(np.float32),
        tex_off=np.zeros(1, np.int32), tex_w=np.full(1, 4, np.int32),
        tex_h=np.full(1, 4, np.int32), tex_slots=("rho_d",))


SCENES = {
    "textured": _textured,
    "lambert": lambda: jtesting.simple_scene(("lambert",)),
    "glossy": lambda: jtesting.simple_scene(("glossy",), roughness=0.4),
    "env": lambda: jtesting.env_scene(("lambert",)),
}


def _params(mod, **kw):
    return mod.RenderParams(image_width=W, image_height=H, spp=SPP,
                            bounces=3, filter_width=1.0, **kw)


def _samples():
    idx = np.arange(W * H)
    st = jrng.seed(jnp.asarray((idx // W) * (W + 2) + idx % W, jnp.uint32))
    s, _ = jsamp.latin_square(st, SPP)
    return np.array(jnp.swapaxes(s, 0, 1))


def _cot():
    cot = np.ones((SPP, W * H, 4), np.float32)
    cot[..., 3] = 0.0
    return cot


def _torch_side(jscene_data):
    ts = tscene.from_numpy(dataclasses.asdict(jscene_data))
    return ts, tca.build_clusters(np.asarray(jscene_data.tri_v))


def _leaves(theta):
    """[(name, numpy array)] of a parameter dict of either package."""
    out = []
    for k in sorted(theta):
        vals = theta[k] if isinstance(theta[k], list) else [theta[k]]
        for i, v in enumerate(vals):
            if v is not None:
                a = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                out.append((f"{k}[{i}]", a))
    return out


def _assert_grads_match(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["lambert", "env"])
def test_params_round_trip(name):
    """get_params / put_params leaf for leaf against nart_tpu.grad, carried
    across with params_from_numpy."""
    js = SCENES[name]()
    ts, _ = _torch_side(js)
    theta_j = jax.tree_util.tree_map(
        np.asarray, jgrad.get_params(jax.tree_util.tree_map(jnp.asarray, js)))
    carried = tgrad.params_from_numpy(theta_j)
    own = tgrad.get_params(ts)
    assert set(carried) == set(own) == set(theta_j)
    assert carried["light_le_tex"][0] is None or name == "env"
    for (k, a), (_, b) in zip(_leaves(carried), _leaves(own)):
        assert a.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # put_params places every leaf (a doubled theta doubles each field)
    doubled = tgrad._map_params(lambda x: x * 2.0, carried)
    back = tgrad.get_params(tgrad.put_params(ts, doubled))
    for (k, a), (_, b) in zip(_leaves(back), _leaves(own)):
        np.testing.assert_array_equal(a, 2.0 * b, err_msg=k)
    assert tgrad.put_params(ts, own).tri_v is ts.tri_v


def test_medium_and_volume_are_refused():
    """A scene with a medium: get_params / put_params / params_from_numpy
    carry the medium's sigma_a, sigma_s, le and density leaf for leaf with
    nart_tpu.grad, and both gradient entry points take the volume
    integrator (the medium's leaves get finite, nonzero gradients)."""
    from tests.test_volume import _env_scene, _medium

    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    js = dataclasses.replace(_env_scene(0.4, 0.8, med_le=(0.5, 0.5, 0.5)),
                             medium=_medium(0.4, 0.8, (0.5, 0.5, 0.5),
                                            density=dens))
    ts, _ = _torch_side(js)
    theta_j = jax.tree_util.tree_map(
        np.asarray, jgrad.get_params(jax.tree_util.tree_map(jnp.asarray, js)))
    carried = tgrad.params_from_numpy(theta_j)
    own = tgrad.get_params(ts)
    assert set(carried) == set(own) == set(theta_j)
    assert set(own["medium"]) == set(theta_j["medium"]) == {
        "sigma_a", "sigma_s", "le", "density"}
    for k in own["medium"]:
        a, b = carried["medium"][k].numpy(), own["medium"][k].numpy()
        assert a.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(a, theta_j["medium"][k], err_msg=k)
    doubled = tgrad._map_params(lambda x: x * 2.0, carried)
    back = tgrad.get_params(tgrad.put_params(ts, doubled))["medium"]
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), 2.0 * own["medium"][k],
                                      err_msg=k)
    assert "medium" not in tgrad.get_params(
        dataclasses.replace(ts, medium=None))

    vol = _params(trender, integrator="volume")
    _, grads = tgrad.loss_and_grad(ts, vol, W, H, SPP, torch.sum,
                                   device="cpu")
    _, grads_w, _, _ = tgrad.radiance_weighted_loss_and_grad(
        ts, own, None, torch.from_numpy(_samples()), torch.from_numpy(_cot()),
        vol, W, H, device="cpu")
    for g in (grads, grads_w):
        for k, v in g["medium"].items():
            assert torch.isfinite(v).all() and v.abs().sum() > 0, k


@pytest.mark.parametrize("name", ["lambert", "glossy", "env", "textured"])
def test_balanced_loss_and_grads_match_jax(name):
    """trace_balanced_loss equals the port's own sum(cot * la) and the JAX
    package's loss; every gradient leaf of radiance_weighted_loss_and_grad
    matches the JAX package's."""
    js = SCENES[name]()
    samples, cot = _samples(), _cot()
    sj = jax.tree_util.tree_map(jnp.asarray, js)
    loss_j, grads_j, rays_j, _ = jgrad.radiance_weighted_loss_and_grad(
        sj, jgrad.get_params(sj), None, jnp.asarray(samples),
        jnp.asarray(cot), _params(jrender, accel="brute"), W, H, lanes=LANES)

    ts, acc = _torch_side(js)
    tp = _params(trender)
    loss_t, grads_t, rays_t, rounds = tgrad.radiance_weighted_loss_and_grad(
        ts, tgrad.get_params(ts), acc, torch.from_numpy(samples),
        torch.from_numpy(cot), tp, W, H, lanes=LANES, n_rounds=7,
        device="cpu")
    la, rays_fwd, rounds_fwd = tpath.trace_balanced(
        ts, acc, torch.from_numpy(samples), tp, W, H, n_lanes=LANES)
    own = float((torch.from_numpy(cot) * la).sum())
    np.testing.assert_allclose(float(loss_t), own, rtol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert rays_t == rays_fwd == float(rays_j)
    # n_rounds = 7 falls short of the count: the entry regrew the store
    assert rounds == rounds_fwd > SPP * W * H // LANES > 7
    _assert_grads_match(grads_t, jax.tree_util.tree_map(np.asarray, grads_j))
    if name == "textured":
        assert grads_t["tex_data"].abs().sum() > 0


def _fd_setup():
    from nart_tpu_torch import testing as ttesting

    sc = ttesting.simple_scene(("lambert",))
    acc = tca.build_clusters(sc.tri_v.numpy())
    samples = torch.from_numpy(_samples())
    cot = torch.from_numpy(_cot())
    return sc, acc, samples, cot, _params(trender)


def test_balanced_gradient_matches_fd():
    """The port alone: the replay's gradient against central finite
    differences of the same deterministic forward estimator (albedo
    influences no sampling decision)."""
    sc, acc, samples, cot, tp = _fd_setup()
    theta = tgrad.get_params(sc)
    _, grads, _, _ = tgrad.radiance_weighted_loss_and_grad(
        sc, theta, acc, samples, cot, tp, W, H, lanes=LANES, device="cpu")
    g_ad = float(grads["rho_d_const"][0, 0])

    def fwd_loss(delta):
        rho = theta["rho_d_const"].clone()
        rho[0, 0] += delta
        scn = tgrad.put_params(sc, dict(theta, rho_d_const=rho))
        la, _, _ = tpath.trace_balanced(scn, acc, samples, tp, W, H,
                                        n_lanes=LANES)
        return float(la[..., :3].double().sum())

    eps = 1e-2
    g_fd = (fwd_loss(eps) - fwd_loss(-eps)) / (2 * eps)
    assert g_fd > 0
    assert abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), 1e-3), (g_ad, g_fd)


def test_backward_pass_makes_no_traversal_query(monkeypatch):
    """The replay answers both queries from the stored outputs: the
    backward pass calls neither intersect_clusters nor
    intersect_clusters_any (on the card: launches no kernel)."""
    sc, acc, samples, cot, tp = _fd_setup()
    calls = {"closest": 0, "any": 0}
    closest, anyhit = tpath.intersect_clusters, tpath.intersect_clusters_any

    def count_closest(*a):
        calls["closest"] += 1
        return closest(*a)

    def count_any(*a):
        calls["any"] += 1
        return anyhit(*a)

    monkeypatch.setattr(tpath, "intersect_clusters", count_closest)
    monkeypatch.setattr(tpath, "intersect_clusters_any", count_any)
    rho = sc.rho_d_const.clone().requires_grad_()
    scn = dataclasses.replace(sc, rho_d_const=rho)
    machines = {}
    loss, _, unfinished, rounds = tpath.trace_balanced_loss(
        scn, acc, samples, cot, tp, W, H, n_lanes=LANES, machines=machines)
    assert unfinished == 0
    # one query of each kind in every round the forwards ran: the
    # measuring forward's and the replay's (k to a check, so the rounds
    # past the end too)
    ran = sum(m.runner.rounds_run for m in machines.values())
    assert ran >= 2 * rounds
    assert calls == {"closest": ran, "any": ran}
    loss.backward()
    assert calls == {"closest": ran, "any": ran}
    assert torch.isfinite(rho.grad).all() and rho.grad.abs().sum() > 0


@pytest.mark.parametrize("materials,kw", [
    (("lambert", "plastic"), {}),
    (("glass", "glass", "lambert"), dict(roughness=0.0, priorities=[2, 1, 0])),
], ids=["plastic", "nested_glass"])
def test_differentiable_leaves_forward_bit_equal(materials, kw):
    """differentiable=True only detaches: the work queue's per-item radiance
    and the lockstep trace's radiance are the same bits either way."""
    from nart_tpu_torch import camera, rng, testing as ttesting

    sc = ttesting.simple_scene(materials, **kw)
    acc = tca.build_clusters(sc.tri_v.numpy())
    tp = dataclasses.replace(_params(trender), bounces=6,
                             roughening_factor=0.3)
    samples = torch.from_numpy(_samples())
    core_p, step_p = tpath._balanced_machine(sc, acc, samples, tp, W, H, 0,
                                             LANES)
    core_d, step_d = tpath._balanced_machine(sc, acc, samples, tp, W, H, 0,
                                             LANES, differentiable=True)
    rounds = 0
    while bool(core_p[0].alive.any()):
        core_p, dying_p, la_p, _ = step_p(core_p)
        core_d, dying_d, la_d, _ = step_d(core_d)
        assert torch.equal(la_p, la_d) and torch.equal(dying_p, dying_d)
        assert torch.equal(core_p[0].beta, core_d[0].beta)
        rounds += 1
    assert rounds > 6 and not bool(core_d[0].alive.any())

    idx = torch.arange(W * H)
    o, d = camera.cast_rays(sc.cam_to_world, sc.fov, W, H, idx % W, idx // W,
                            samples[0])
    st = rng.seed(idx)
    plain = tpath.trace(sc, acc, o, d, st, tp)
    diff = tpath.trace(sc, acc, o, d, st, tp, differentiable=True)
    for a, b in zip(plain[:3], diff[:3]):
        assert torch.equal(a, b)
    assert plain[3] == diff[3] > 0


@pytest.mark.parametrize("materials,kw", [
    (("glass", "plastic"), {}),
    (("glass", "plastic"), dict(roughness=0.15)),
], ids=["glass_plastic", "smooth_glass_plastic"])
def test_replay_equals_plain_autograd(materials, kw):
    """The replay (stored carry, per-round re-run, adjoint of the carry
    pushed backwards) against one autograd graph over all rounds of the
    same machine, on scenes whose eta and roughness reach later rounds
    through the carry (nested-dielectric list, roughening chain).  rtol
    1e-4: the same operations, summed over rounds in another order."""
    from nart_tpu_torch import testing as ttesting

    # the plastic under the glass has another index: its Fresnel term then
    # depends on the glass's eta through the nested-dielectric list
    sc = dataclasses.replace(ttesting.env_scene(materials, **kw),
                             eta_const=torch.tensor([1.5, 1.3]))
    acc = tca.build_clusters(sc.tri_v.numpy())
    tp = dataclasses.replace(_params(trender), bounces=8,
                             roughening_factor=0.5)
    samples, cot = torch.from_numpy(_samples()), torch.from_numpy(_cot())
    loss_r, grads_r, _, _ = tgrad.radiance_weighted_loss_and_grad(
        sc, tgrad.get_params(sc), acc, samples, cot, tp, W, H, lanes=LANES,
        device="cpu")

    theta = tgrad._as_leaves(tgrad.get_params(sc), "cpu")
    core, step = tpath._balanced_machine(
        tgrad.put_params(sc, theta), acc, samples, tp, W, H, 0, LANES,
        differentiable=True)
    cot_flat = cot.reshape(-1, 4)
    loss = torch.zeros(())
    while bool(core[0].alive.any()):
        core, dying, la, item = step(core)
        c = cot_flat[item.clamp(0, cot_flat.shape[0] - 1)]
        loss = loss + ((c * la).sum(-1) * dying).sum()
    grads_p = tgrad._grads_of(loss, theta)
    np.testing.assert_allclose(float(loss_r), float(loss.detach()), rtol=1e-6)
    for (k, g), (_, w) in zip(_leaves(grads_r), _leaves(grads_p)):
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("eta_const", "alpha_const", "tau_const", "light_le_tex"):
        assert sum(np.abs(g).sum() for n, g in _leaves(grads_r)
                   if n.startswith(k)) > 0, k
    # light reaches the camera through every layer: the lowest quad's
    # parameters count too
    assert grads_r["rho_d_const"][-1].abs().sum() > 0
    assert grads_r["alpha_const"][-1].abs() > 0


def test_entry_points_default_to_the_card():
    """With no device named the entry points take the card, and raise where
    there is none: they never fall back to the CPU."""
    import os

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    sc, acc, samples, cot, tp = _fd_setup()
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth",
                           "macbeth.json")
    calls = [
        lambda: trender.RenderSession(sc, tp),
        lambda: next(trender.render_scene_file(fixture)),
        lambda: tgrad.loss_and_grad(sc, tp, W, H, SPP, torch.sum),
        lambda: tgrad.radiance_weighted_loss_and_grad(
            sc, tgrad.get_params(sc), acc, samples, cot, tp, W, H),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert trender.RenderSession(sc, tp, "cpu").device.type == "cpu"
