"""nart_tpu_torch slice (trace_balanced, film, render) vs nart_tpu.

Both packages trace the same Latin-square samples with the same per-item
RNG streams, so the balanced wavefront's per-item radiance agrees lane for
lane: allclose (rtol 1e-4, atol 1e-5) on >= 99.5% of the items, and the
mean within 1e-4 relative (rare Russian-roulette threshold flips explain
the rest).  The JAX side traces with its plain brute-force intersector
(accel="brute"), the port with its cluster accel's plain versions.  The
macbeth image at 32x32, 2 spp is compared with test_golden's _compare
statistics.  The 96x96, 8 spp macbeth golden takes over 90 s on the CPU,
so it runs on the GPU only (tests/test_torch_kernels.py, chip_smoke.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import film as jfilm
from nart_tpu import render as jrender
from nart_tpu import rng as jrng
from nart_tpu import sampling as jsamp
from nart_tpu import scene as jscene
from nart_tpu import testing as jtesting
from nart_tpu.integrators import path as jpath
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import exr as texr
from nart_tpu_torch import film as tfilm
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")
MACBETH = os.path.join(FIX, "macbeth.json")


def _samples(w, h, spp, total_w):
    n = w * h
    idx = np.arange(n)
    st = jrng.seed(jnp.asarray((idx // w) * total_w + idx % w, jnp.uint32))
    s, _ = jsamp.latin_square(st, spp)
    return np.array(jnp.swapaxes(s, 0, 1))


def _trace_both(jscene_data, w, h, spp, bounces=6, rf=0.3, **mis):
    samples = _samples(w, h, spp, w + 2)
    jp = jrender.RenderParams(image_width=w, image_height=h, spp=spp,
                              bounces=bounces, roughening_factor=rf,
                              accel="brute", **mis)
    sj = jax.tree_util.tree_map(jnp.asarray, jscene_data)
    la_j, rays_j, rounds_j = jpath.trace_balanced(sj, None,
                                                  jnp.asarray(samples), jp,
                                                  w, h)
    tp = trender.RenderParams(image_width=w, image_height=h, spp=spp,
                              bounces=bounces, roughening_factor=rf, **mis)
    ts = tscene.from_numpy(dataclasses.asdict(jscene_data))
    acc = tca.build_clusters(np.asarray(jscene_data.tri_v))
    la_t, rays_t, rounds_t = tpath.trace_balanced(
        ts, acc, torch.from_numpy(samples), tp, w, h)
    return (np.asarray(la_j), float(rays_j), int(rounds_j),
            la_t.numpy(), rays_t, rounds_t)


@pytest.mark.parametrize("make,mis", [
    (lambda: jtesting.simple_scene(("lambert", "plastic")), {}),
    (lambda: jtesting.env_scene(("lambert", "plastic")), {}),
    (lambda: jtesting.simple_scene(("glass", "glass", "lambert"),
                                   roughness=0.0, priorities=[2, 1, 0]), {}),
], ids=["simple", "env", "nested_glass"])
def test_trace_balanced_per_item_matches(make, mis):
    la_j, rays_j, rounds_j, la_t, rays_t, rounds_t = _trace_both(
        make(), 16, 16, 2, **mis)
    close = np.isclose(la_t, la_j, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, close.mean()
    m_j, m_t = la_j[..., :3].mean(), la_t[..., :3].mean()
    assert abs(m_t - m_j) <= 1e-4 * max(abs(m_j), 1e-6), (m_j, m_t)
    assert rays_t == rays_j and rounds_t == rounds_j


def test_sample_eval_route_matches_two_calls(monkeypatch):
    """A path round's strategy A sample and strategy B eval go through one
    bsdf_ops.sample_eval_f call (one launch on the card): macbeth (the
    fixture) at 16x9 @ 1 spp, a per-round render and a per-round fwd+bwd,
    against the same with sample_eval_f patched to call sample_f and
    eval_f_pdf one after the other: the film, the stats, the loss and
    every leaf gradient bit for bit."""
    from nart_tpu_torch import bench, bsdf_ops
    from nart_tpu_torch import grad as tgrad

    sc = tscene.load_scene(MACBETH, asset_root=FIX)
    params = trender.RenderParams(image_width=16, image_height=9, spp=1)
    samples = trender.image_samples(16, 9, 16 + 2 * int(np.ceil(
        params.filter_width)), 1, "cpu")
    acc = tca.build_clusters(sc.tri_v.numpy())

    def run():
        sess = trender.RenderSession(sc, params, "cpu", per_round=True)
        film = sess.image()
        loss, grads, rays, rounds = tgrad.radiance_weighted_loss_and_grad(
            sc, tgrad.get_params(sc), acc, samples,
            bench.rgb_cot(1, 16 * 9, "cpu"), params, 16, 9, device="cpu",
            per_round=True)
        return film, dict(sess.stats), loss, grads, rays, rounds

    fused = run()
    monkeypatch.setattr(bsdf_ops, "sample_eval_f", bsdf_ops.sample_then_eval(
        bsdf_ops.sample_f, bsdf_ops.eval_f_pdf))
    two = run()
    assert torch.equal(fused[0].view(torch.int32), two[0].view(torch.int32))
    assert fused[1] == two[1] and fused[4:] == two[4:]
    assert float(fused[2]) == float(two[2])
    a, b = (tgrad.flatten_leaves(r[3]) for r in (fused, two))
    assert a.numel() > 0 and torch.equal(a.view(torch.int32),
                                         b.view(torch.int32))
    assert float(fused[2]) > 0.0 and bool(torch.isfinite(fused[0]).all())


def test_mis_strategies_converge():
    """BSDF-only and light-only sampling (the MIS toggles) estimate the same
    integral as both strategies (test_integrator's Veach check, on the
    port alone)."""
    from nart_tpu_torch import testing

    sc = testing.simple_scene(("plastic",), roughness=0.6, intensity=8.0)
    base = trender.RenderParams(image_width=6, image_height=6, spp=48,
                                bounces=2)
    means = {}
    for name, kw in (("bsdf", dict(mis_light=False)),
                     ("light", dict(mis_bsdf=False)), ("both", {})):
        p = dataclasses.replace(base, **kw)
        means[name] = float(
            trender.RenderSession(sc, p, "cpu").image()[..., :3].mean())
    assert abs(means["bsdf"] - means["light"]) / means["both"] < 0.12, means
    assert abs(means["both"] - means["light"]) / means["both"] < 0.12, means


def test_sorted_queries_and_brute_accel_agree():
    """The in-call coherence sort (on above 64 clusters; forced here) only
    permutes rays and scatters results back: per-item radiance is
    identical.  The brute accel differs only on shared-edge ties."""
    sc = jtesting.simple_scene(("plastic", "lambert"), roughness=0.4)
    ts = tscene.from_numpy(dataclasses.asdict(sc))
    acc = tca.build_clusters(np.asarray(sc.tri_v))
    samples = torch.from_numpy(_samples(16, 16, 2, 18))
    base = trender.RenderParams(image_width=16, image_height=16, spp=2,
                                bounces=5, roughening_factor=0.3)

    def trace(**kw):
        p = dataclasses.replace(base, **kw)
        return tpath.trace_balanced(ts, acc, samples, p, 16, 16)[0].numpy()

    plain = trace(sort_rays=False)
    np.testing.assert_array_equal(trace(sort_rays=True), plain)
    brute = trace(accel="brute")
    close = np.isclose(brute, plain, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, close.mean()


def _compare(ours, ref, mean_tol, block_tol, block_frac):
    """tests/test_golden.py's _compare on two arrays."""
    r, o = ref[..., :3], ours[..., :3]
    mean_rel = abs(o.mean() - r.mean()) / max(r.mean(), 1e-6)
    assert mean_rel < mean_tol, f"image mean off by {mean_rel:.4f}"
    h, w = r.shape[:2]
    rb = r[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    ob = o[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    rm, om = rb.mean((1, 3, 4)), ob.mean((1, 3, 4))
    rel = np.abs(om - rm) / np.maximum(rm, 0.05)
    assert (rel < block_tol).mean() >= block_frac, rel.max()


def test_macbeth_image_matches_jax():
    """macbeth at 32x32, 2 spp (texture, env map with 2D CDF, glossy and
    plastic): the port's image against nart_tpu's on the same streams."""
    overrides = dict(image_width=32, image_height=32, spp=2)
    js = jscene.load_scene(MACBETH, asset_root=FIX)
    jp = jrender.resolve_params({}, dict(overrides, accel="brute"))
    img_j = np.asarray(jrender.RenderSession(js, jp).image())
    ts = tscene.load_scene(MACBETH)
    sess = trender.RenderSession(ts, trender.resolve_params({}, overrides),
                                 "cpu")
    img_t = sess.image().numpy()
    assert np.isfinite(img_t).all()
    _compare(img_t, img_j, mean_tol=1e-3, block_tol=0.01, block_frac=0.95)
    _compare(img_t, img_j, mean_tol=0.03, block_tol=0.12, block_frac=0.95)


@pytest.mark.parametrize("fw", [1.0, 2.0])
def test_splat_grid_and_finalize_match(fw):
    g = np.random.default_rng(int(fw))
    rw, rh, spp = 24, 16, 3
    fb = int(np.ceil(fw))
    tw, th = 20 + 2 * fb, 12 + 2 * fb
    jit = g.random((spp, rw * rh, 2), dtype=np.float32)
    la = g.random((spp, rw * rh, 4), dtype=np.float32)
    table_j = jnp.asarray(jfilm.filter_table())
    fj = jfilm.splat_grid(jnp.zeros((th, tw, 5)), jnp.asarray(jit),
                          jnp.asarray(la), fw, table_j, rw, rh, fb)
    ft = tfilm.splat_grid(torch.zeros((th, tw, 5)), torch.from_numpy(jit),
                          torch.from_numpy(la), fw, tfilm.filter_table(),
                          rw, rh, fb)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        tfilm.finalize(ft, 20, 12, fb).numpy(),
        np.asarray(jfilm.finalize(fj, 20, 12, fb)), rtol=1e-6, atol=1e-7)


def test_params_and_sessions_match():
    overrides = {"spp": 16, "image_width": 100}
    tj = jrender.load_sessions(MACBETH, overrides)
    tt = trender.load_sessions(MACBETH, overrides)
    assert len(tj) == len(tt) == 1
    for f in dataclasses.fields(tt[0]):
        if f.name != "accel":  # JAX kinds differ: auto/bvh/brute/pallas
            assert getattr(tt[0], f.name) == getattr(tj[0], f.name), f.name
    p = trender.resolve_params({"rougheningFactor": 3.0}, {})
    assert p.roughening_factor == 1.0 and p.accel == "auto"


def test_session_writes_exr_and_rejects_unported_modes(tmp_path):
    """A session writes its EXR; with the volume integrator "regen" runs
    the "spp" loop (there is no per-pixel regeneration machine for
    volumes, as in the JAX package): the same film bits."""
    from nart_tpu_torch import testing
    from tests.test_volume import _env_scene

    sc = testing.simple_scene(("lambert",))
    p = trender.RenderParams(image_width=8, image_height=8, spp=1, bounces=2)
    sess = trender.RenderSession(sc, p, "cpu")
    out = sess.write_exr(str(tmp_path / "img"))
    img = texr.read(out)
    assert img.shape == (8, 8, 4) and np.isfinite(img).all()
    assert sess.stats["rays"] > 0 and sess.stats["rounds"] > 0
    vol = tscene.from_numpy(dataclasses.asdict(
        _env_scene(sigma_a=0.4, sigma_s=0.8, med_le=(0.5, 0.5, 0.5))))
    films = {}
    for mode in ("regen", "spp"):
        q = dataclasses.replace(p, wavefront=mode, integrator="volume",
                                spp=3, bounces=16)
        films[mode] = trender.RenderSession(vol, q, "cpu").render()
    assert torch.equal(films["regen"], films["spp"])
    assert float(films["spp"][..., 3].sum()) > 0
    with pytest.raises(ValueError):
        trender.RenderSession(sc, dataclasses.replace(p, wavefront="queue"),
                              "cpu")
