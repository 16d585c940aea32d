"""nart_tpu_torch's volume integrator vs nart_tpu's, on the CPU.

Both packages get the same scene (tests/test_volume.py's _env_scene media
through dataclasses.asdict -> scene.from_numpy) and the same RNG states,
so the walks draw the same numbers.  log, sin and cos differ by an ulp
between the libraries, and a flight step or an event choice that lands
within that ulp of its threshold takes another branch from there on: the
radiance must agree to atol 1e-5 on >= 99.9% of lanes (>= 99% on the
non-uniform grid, whose density varies along every step) and the RNG
state must be equal on the lanes that agree.  Within the port the
schedulers are held bit for bit: the static assignment against the work
queue, any lane count, any number of fused flight steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import render as jrender
from nart_tpu import rng as jrng
from nart_tpu import sampling as jsamp
from nart_tpu.integrators import volume as jvol
from nart_tpu_torch import render as trender
from nart_tpu_torch import rng as trng
from nart_tpu_torch import scene as tscene
from nart_tpu_torch.integrators import volume as tvol
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_volume import _env_scene, _medium

N = 4096


def _nonuniform():
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    return dataclasses.replace(_env_scene(sigma_a=0.5, sigma_s=0.0),
                               medium=_medium(0.5, 0.0, density=dens))


def _no_medium():
    return dataclasses.replace(_env_scene(0.5, 0.0), medium=None)


# (scene, bounces, least share of lanes that agree, the mean the port must
# reach: exp(-sigma_a * 2) transmittance, T + (1 - T) Le, the furnace's 1)
CASES = {
    "absorb": (lambda: _env_scene(0.5, 0.0), 64, 0.999, np.exp(-1.0)),
    "emission": (lambda: _env_scene(0.8, 0.0, med_le=(2.0, 2.0, 2.0)), 64,
                 0.999, np.exp(-1.6) + (1 - np.exp(-1.6)) * 2.0),
    "furnace": (lambda: _env_scene(0.0, 1.5), 512, 0.999, 1.0),
    "no_medium": (_no_medium, 64, 1.0, 1.0),
    "nonuniform": (_nonuniform, 64, 0.99, None),
}


def _rays(n=N):
    o = np.tile(np.float32([[0.0, 0.0, 3.0]]), (n, 1))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    return o, d


def _port(js):
    return tscene.from_numpy(dataclasses.asdict(js))


def _lockstep_both(js, bounces):
    o, d = _rays()
    seeds = np.arange(N, dtype=np.uint32)
    jp = jrender.RenderParams(bounces=bounces, integrator="volume")
    lj, aj, sj, rj = jvol.trace(js, None, jnp.asarray(o), jnp.asarray(d),
                                jrng.seed(jnp.asarray(seeds)), jp)
    tp = trender.RenderParams(bounces=bounces, integrator="volume")
    lt, at, st, rt = tvol.trace(_port(js), None, torch.from_numpy(o),
                                torch.from_numpy(d),
                                trng.seed(torch.from_numpy(seeds)), tp)
    return ((np.asarray(lj), np.asarray(aj), np.asarray(sj).astype(np.int64),
             float(rj)), (lt.numpy(), at.numpy(), st.numpy(), rt))


@pytest.mark.parametrize("name", list(CASES))
def test_lockstep_trace_matches_jax(name):
    """volume.trace lane for lane against nart_tpu's, and the analytic
    means of tests/test_volume.py on the port's own result."""
    make, bounces, share, want = CASES[name]
    (lj, aj, sj, rj), (lt, at, st, rt) = _lockstep_both(make(), bounces)
    agree = np.isclose(lt, lj, rtol=0, atol=1e-5).all(-1)
    assert agree.mean() >= share, agree.mean()
    np.testing.assert_array_equal(st[agree], sj[agree])
    assert (at == 1.0).all() and (aj == 1.0).all()
    if name != "no_medium":
        assert abs(rt - rj) <= (1 - agree.mean()) * 64 * N, (rt, rj)
    if name == "furnace":  # every walk exits with throughput 1
        np.testing.assert_allclose(lt[:, 0], 1.0, atol=1e-4)
    elif name == "no_medium":
        np.testing.assert_allclose(lt[:, 0], 1.0, atol=1e-6)
    elif want is not None:
        got = lt[:, 0].mean()
        assert abs(got - want) / want < 0.05, (got, want)


def test_trace_diff_equals_trace():
    """trace_diff is trace with a step bound: the same bits where no walk
    was cut short; a bound too small reports the walks it cut."""
    js = _env_scene(0.4, 0.8, med_le=(0.5, 0.5, 0.5))
    sc = _port(js)
    tp = trender.RenderParams(bounces=16, integrator="volume")
    o, d = (torch.from_numpy(a) for a in _rays(1024))
    st = trng.seed(torch.arange(1024))
    l, a, s, r = tvol.trace(sc, None, o, d, st, tp)
    l2, a2, s2, r2, unfinished = tvol.trace_diff(sc, None, o, d, st, tp)
    assert unfinished == 0 and r2 == r
    for x, y in ((l, l2), (a, a2), (s, s2)):
        assert torch.equal(x, y)
    *_, cut = tvol.trace_diff(sc, None, o, d, st, tp, n_steps=3)
    assert cut > 0


W = H = 8
SPP = 4


def _samples():
    idx = np.arange(W * H)
    st = jrng.seed(jnp.asarray((idx // W) * (W + 2) + idx % W, jnp.uint32))
    s, _ = jsamp.latin_square(st, SPP)
    return np.array(jnp.swapaxes(s, 0, 1))


def _scatter_scene():
    """test_volume_balanced_matches_lockstep_mean's medium: absorption,
    scattering and emission; the camera looks into it."""
    return _env_scene(sigma_a=0.4, sigma_s=0.8, med_le=(0.5, 0.5, 0.5))


def _machine_params(mod, **kw):
    return mod.RenderParams(image_width=W, image_height=H, spp=SPP,
                            bounces=16, integrator="volume", **kw)


def test_static_matches_jax_per_item():
    """trace_vol_static per item against nart_tpu's on the same samples."""
    js = _scatter_scene()
    samples = _samples()
    sj = jax.tree_util.tree_map(jnp.asarray, js)
    la_j, rays_j, _ = jvol.trace_vol_static(
        sj, None, jnp.asarray(samples), _machine_params(jrender), W, H)
    la_t, rays_t, rounds = tvol.trace_vol_static(
        _port(js), None, torch.from_numpy(samples), _machine_params(trender),
        W, H)
    la_j, la_t = np.asarray(la_j), la_t.numpy()
    agree = np.isclose(la_t, la_j, rtol=0, atol=1e-5).all(-1)
    assert agree.mean() >= 0.999, agree.mean()
    assert (la_t[..., 3] == 1.0).all()
    assert la_t[..., :3].mean() > 0.1 and rounds > 1
    assert rays_t > W * H * SPP  # scatter redirects start segments too
    assert abs(rays_t - float(rays_j)) <= 64 * (~agree).sum()


def test_static_equals_queue_any_lanes_any_fusion(monkeypatch):
    """The static assignment and the work queue give every item the same
    bits, for any lane count and any number of fused flight steps."""
    sc = _port(_scatter_scene())
    samples = torch.from_numpy(_samples())
    tp = _machine_params(trender)
    la_s, rays_s, _ = tvol.trace_vol_static(sc, None, samples, tp, W, H)
    la_q, rays_q, _ = tvol.trace_balanced(sc, None, samples, tp, W, H)
    assert torch.equal(la_s, la_q) and rays_s == rays_q
    la_l, _, rounds_l = tvol.trace_vol_static(sc, None, samples, tp, W, H,
                                              n_lanes=128)
    assert torch.equal(la_l, la_s) and rounds_l > 1
    la_b, _, _ = tvol.trace_balanced(sc, None, samples, tp, W, H,
                                     n_lanes=32)
    assert torch.equal(la_b, la_s)
    monkeypatch.setattr(tvol, "FUSE_STEPS", 1)
    la_1, rays_1, _ = tvol.trace_vol_static(sc, None, samples, tp, W, H,
                                            n_lanes=64)
    assert torch.equal(la_1, la_s) and rays_1 == rays_s


def test_medium_scene_is_env_scene():
    """nart_tpu_torch.testing.medium_scene (chip_smoke.py's volume scene)
    is tests/test_volume.py's _env_scene, field for field."""
    from nart_tpu_torch import testing

    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    got = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
    want = _port(dataclasses.replace(
        _env_scene(0.4, 0.8, med_le=(0.5, 0.5, 0.5)),
        medium=_medium(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)))
    for a, b in ((got.medium, want.medium), (got.lights[0], want.lights[0]),
                 (got, want)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if torch.is_tensor(x):
                assert torch.equal(x, y), f.name
            elif not dataclasses.is_dataclass(x) and f.name != "lights":
                assert x == y, f.name


def test_static_without_medium():
    """No medium: every item escapes to the light pass."""
    js = _no_medium()
    samples = torch.from_numpy(_samples())
    la, rays, rounds = tvol.trace_vol_static(
        _port(js), None, samples, _machine_params(trender), W, H)
    assert rounds == 0 and rays == W * H * SPP
    np.testing.assert_allclose(la.numpy(), 1.0, atol=1e-6)


def test_torch_volume_golden(tmp_path):
    """volume_blob at its own 96x96, 32 spp through RenderSession against
    the reference renderer's golden, with test_volume_golden's criteria
    (mean rel < 0.02, >= 95% of 16x16 blocks within 0.05).  The scene file
    names blob.vol by an absolute path, and a missing volume only warns, so
    the test renders a copy that points at this checkout's and asserts that
    the medium was loaded."""
    import json
    import os

    from nart_tpu_torch import exr
    from tests.test_torch_render import _compare

    golden = os.path.join(os.path.dirname(__file__), "golden")
    with open(os.path.join(golden, "volume_blob.json")) as f:
        doc = json.load(f)
    doc["camera"]["medium"]["filePath"] = os.path.join(golden, "blob.vol")
    path = str(tmp_path / "volume_blob.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    (params, sess), = trender.render_scene_file(path, device="cpu")
    assert sess.scene.medium is not None
    assert (params.integrator, params.spp) == ("volume", 32)
    ours = sess.image().numpy()
    ref = exr.read(os.path.join(golden, "volume_blob_96x96_32spp.exr"))
    assert ours.shape == ref.shape == (96, 96, 4)
    _compare(ours, ref, mean_tol=0.02, block_tol=0.05, block_frac=0.95)
