"""Volume gradients of nart_tpu_torch (grad.py, volume.trace_vol_static_loss,
trace_balanced_loss, trace_diff) vs nart_tpu, on the CPU.

Both packages get the same scene (tests/test_volume.py's media through
dataclasses.asdict -> scene.from_numpy), the same Latin-square samples and
the same RNG streams, so they take the same decisions.  Tolerances: losses
rtol 1e-4, gradient leaves rtol 1e-3 / atol 1e-5 (float32 sums taken in
another order), the medium's Le against a central finite difference rtol
1e-3 (no decision depends on Le), the replay against one autograd graph
over the same rounds rtol 1e-4 / atol 1e-6.  8x8 at 4 spp, 64 work slots:
the machines run several rounds with respawns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import grad as jgrad
from nart_tpu import render as jrender
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import rng as trng
from nart_tpu_torch import scene as tscene
from nart_tpu_torch.integrators import volume as tvol
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_volume import H, SPP, W, _samples
from tests.test_volume import _env_scene, _medium

LANES = 64
LE = (0.5, 0.5, 0.5)


def _grid():
    """Density strictly under the majorant: the null events carry
    gradient too."""
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    return dataclasses.replace(_env_scene(0.4, 0.8, med_le=LE),
                               medium=_medium(0.4, 0.8, LE, density=dens))


SCENES = {"uniform": lambda: _env_scene(0.4, 0.8, med_le=LE), "grid": _grid}


def _params(mod, **kw):
    return mod.RenderParams(image_width=W, image_height=H, spp=SPP,
                            bounces=16, integrator="volume",
                            filter_width=1.0, **kw)


def _cot():
    cot = np.random.default_rng(11).random((SPP, W * H, 4), dtype=np.float32)
    cot[..., 3] = 0.5
    return cot


def _flat(theta):
    """[(name, numpy array)] of a parameter dict of either package, the
    medium's dict included."""
    out = []
    for k in sorted(theta):
        v = theta[k]
        if isinstance(v, dict):
            out += [(f"{k}.{s}", v[s]) for s in sorted(v)]
        elif isinstance(v, list):
            out += [(f"{k}[{i}]", x) for i, x in enumerate(v) if x is not None]
        else:
            out.append((k, v))
    return [(k, v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in out]


def _assert_grads_match(got, want, rtol=1e-3, atol=1e-5):
    got, want = _flat(got), _flat(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def _port(js):
    return tscene.from_numpy(dataclasses.asdict(js))


@pytest.mark.parametrize("name", list(SCENES))
def test_balanced_loss_and_grads_match_jax(name):
    """The replay's loss equals the forward's sum(cot * la) and the JAX
    package's loss; every leaf of radiance_weighted_loss_and_grad matches
    the JAX package's."""
    js = SCENES[name]()
    samples, cot = _samples(), _cot()
    sj = jax.tree_util.tree_map(jnp.asarray, js)
    loss_j, grads_j, rays_j, _ = jgrad.radiance_weighted_loss_and_grad(
        sj, jgrad.get_params(sj), None, jnp.asarray(samples),
        jnp.asarray(cot), _params(jrender), W, H, lanes=LANES)
    ts = _port(js)
    tp = _params(trender)
    loss_t, grads_t, rays_t, rounds = tgrad.radiance_weighted_loss_and_grad(
        ts, tgrad.get_params(ts), None, torch.from_numpy(samples),
        torch.from_numpy(cot), tp, W, H, lanes=LANES, n_rounds=3,
        device="cpu")
    la, rays_f, rounds_f = tvol.trace_vol_static(
        ts, None, torch.from_numpy(samples), tp, W, H, n_lanes=LANES)
    own = float((torch.from_numpy(cot) * la).double().sum())
    np.testing.assert_allclose(float(loss_t), own, rtol=1e-4)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert rays_t == rays_f == float(rays_j)
    # n_rounds = 3 falls short of the count: the entry regrew the store
    assert rounds == rounds_f > SPP * W * H // LANES > 3
    _assert_grads_match(grads_t, jax.tree_util.tree_map(np.asarray, grads_j))
    for k in ("sigma_a", "sigma_s", "le", "density"):
        assert float(grads_t["medium"][k].abs().sum()) > 0, k


def _plain_autograd(machine, ts, samples, cot, tp):
    """One autograd graph over every round of a machine."""
    theta = tgrad._as_leaves(tgrad.get_params(ts), "cpu")
    core, step_round, _ = machine(tgrad.put_params(ts, theta), samples, tp,
                                  W, 0, LANES)
    cot_flat = cot.reshape(-1, 4)
    loss = torch.zeros(())
    while bool(core[0].alive.any()):
        core, died, l_done, item, _ = step_round(core)
        c = cot_flat[item.clamp(0, cot_flat.shape[0] - 1)]
        loss = loss + (((c[:, :3] * l_done).sum(-1) + c[:, 3]) * died).sum()
    return loss.detach(), tgrad._grads_of(loss, theta)


def test_replay_equals_plain_autograd():
    """Both replays (static assignment, work queue) against one autograd
    graph over all rounds of the same machine; the two machines take the
    same decisions, so all four agree."""
    ts = _port(_grid())
    samples, cot = torch.from_numpy(_samples()), torch.from_numpy(_cot())
    tp = _params(trender)
    ref_loss, ref = _plain_autograd(tvol._static_machine, ts, samples, cot,
                                    tp)
    theta = tgrad._as_leaves(tgrad.get_params(ts), "cpu")
    scn = tgrad.put_params(ts, theta)
    for name, fn in (("static", tvol.trace_vol_static_loss),
                     ("queue", tvol.trace_balanced_loss)):
        loss, _, unfinished, rounds = fn(scn, None, samples, cot, tp, W, H,
                                         n_lanes=LANES)
        assert unfinished == 0 and rounds > 1
        np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                                   rtol=1e-6)
        _assert_grads_match(tgrad._grads_of(loss, theta), ref, rtol=1e-4,
                            atol=1e-6)
    q_loss, q_ref = _plain_autograd(tvol._queue_machine, ts, samples, cot,
                                    tp)
    np.testing.assert_allclose(float(q_loss), float(ref_loss), rtol=1e-6)
    _assert_grads_match(q_ref, ref, rtol=1e-4, atol=1e-6)


def _lockstep_loss(sc, theta, tp, n=2048):
    o = torch.tensor([[0.0, 0.0, 3.0]]).expand(n, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    med = dataclasses.replace(sc.medium, **theta)
    l, _, _, _, unfinished = tvol.trace_diff(
        dataclasses.replace(sc, medium=med), None, o, d,
        trng.seed(torch.arange(n)), tp)
    assert unfinished == 0
    return l.sum() / n


def test_lockstep_gradients_fd_and_signs():
    """tests/test_volume.py's gradient checks on the port: pure emission,
    d/d sigma_a > 0 and the Le gradient equal to a central finite
    difference; pure transmittance through a grid under its majorant,
    d/d sigma_a < 0."""
    tp = trender.RenderParams(bounces=64, integrator="volume")
    sc = _port(_env_scene(0.8, 0.0, med_le=(2.0, 2.0, 2.0), env=0.0))
    theta = {k: getattr(sc.medium, k).clone().requires_grad_()
             for k in ("sigma_a", "le", "density")}
    g = dict(zip(theta, torch.autograd.grad(_lockstep_loss(sc, theta, tp),
                                            list(theta.values()))))
    assert float(g["sigma_a"]) > 0
    assert torch.isfinite(g["density"]).all() and g["density"].abs().sum() > 0
    eps = 1e-2
    with torch.no_grad():
        le = theta["le"].detach()
        up = float(_lockstep_loss(sc, dict(theta, le=le + eps), tp))
        dn = float(_lockstep_loss(sc, dict(theta, le=le - eps), tp))
    np.testing.assert_allclose(float(g["le"].sum()), (up - dn) / (2 * eps),
                               rtol=1e-3)

    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    sc2 = _port(dataclasses.replace(_env_scene(0.5, 0.0, env=1.0),
                                    medium=_medium(0.5, 0.0, density=dens)))
    sa = sc2.medium.sigma_a.clone().requires_grad_()
    (g2,) = torch.autograd.grad(_lockstep_loss(sc2, {"sigma_a": sa}, tp), sa)
    assert float(g2) < 0


@pytest.mark.parametrize("route", ["lockstep", "balanced"])
def test_loss_and_grad_matches_jax(route):
    """grad.loss_and_grad(integrator="volume") against nart_tpu's, on both
    routes: the lockstep trace_diff (per-pixel streams) and the default
    balanced replay (the image linearised into a cotangent)."""
    js = _grid()
    weights = np.random.default_rng(7).random((H, W, 3), dtype=np.float32)
    jp = dataclasses.replace(_params(jrender), spp=2)
    loss_j, grads_j = jgrad.loss_and_grad(
        js, jp, W, H, 2, lambda img: jnp.sum(img * weights),
        volume_grad=route)
    wt = torch.from_numpy(weights)
    loss_t, grads_t = tgrad.loss_and_grad(
        _port(js), dataclasses.replace(_params(trender), spp=2), W, H, 2,
        lambda img: (img * wt).sum(), device="cpu", volume_grad=route)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    _assert_grads_match(grads_t, jax.tree_util.tree_map(np.asarray, grads_j))
    assert float(grads_t["medium"]["density"].abs().sum()) > 0


def test_inverse_volume_emission_recovers_target():
    """tests/test_inverse.py's medium-emission recovery on the port: Adam
    (torch.optim.Adam, lr 0.3) on the balanced replay's gradient, from Le
    0.6 to the target's 2.0 in 80 steps, 12x12 at 4 spp; the loss drops at
    least 10x and Le lands within 5%.  The sample set is fixed, so the run
    is deterministic."""
    from nart_tpu_torch import testing

    w = h = 12
    spp, steps = 4, 80
    # an absorbing, emitting medium and a black environment
    scene = testing.medium_scene(0.8, 0.0, (2.0, 2.0, 2.0), env=0.0)
    params = trender.RenderParams(image_width=w, image_height=h, spp=spp,
                                  bounces=16, integrator="volume",
                                  filter_width=1.0)
    n = w * h
    samples = trender.image_samples(w, h, w + 2, spp, "cpu")

    def image(theta):
        la, _, _ = tvol.trace_vol_static(tgrad.put_params(scene, theta),
                                         None, samples, params, w, h)
        return la[..., :3].mean(0)

    theta_star = tgrad.get_params(scene)
    target = image(theta_star)
    le = torch.full((3,), 0.6)
    opt = torch.optim.Adam([le], lr=0.3)
    losses = []
    for _ in range(steps):
        theta = dict(theta_star, medium=dict(theta_star["medium"],
                                             le=le.detach()))
        diff = image(theta) - target
        losses.append(float((diff * diff).mean()))
        cot_img = 2.0 * diff / diff.numel()
        cot = torch.cat([(cot_img / spp).expand(spp, n, 3),
                         torch.zeros(spp, n, 1)], -1)
        _, grads, _, _ = tgrad.radiance_weighted_loss_and_grad(
            scene, theta, None, samples, cot, params, w, h, device="cpu")
        le.grad = grads["medium"]["le"]
        opt.step()
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    np.testing.assert_allclose(le.numpy(), 2.0, rtol=0.05)
