"""The volume's flight steps (nart_tpu_torch.vol_ops) on the CPU: against
the plain step, against nart_tpu's _make_vol_step, and its backward's
plain twin (V2's algorithm) against autograd and jax.vjp.

Inputs: testing.vol_lane_set's 256 lanes from a numpy seed in an 8^3 grid
whose corner block sits at the majorant, drawn so that a step meets every
branch: absorb, scatter, null, a missed box, a left segment, a left
medium, the bounce limit, the null event at p_null = 0 exactly, dead
lanes.  flight_steps on CPU tensors is k calls of the plain step, bit for
bit.  Against the JAX package (k calls of its step): the events, the
draws and beta the same bits on every lane; t, o, d and l_out within rtol
1e-5 / atol 1e-6 (log, sin and cos and the 8-term density sum differ by
an ulp between the libraries, as tests/test_torch_volume.py and
test_torch_media.py state).  The twin's VJP: against autograd of the plain
steps in float64 to 1e-10; in float32 (its float64 reverse pass) within
rtol 1e-5 / atol 1e-6 of the float64 one on every lane, and of jax.vjp
of the JAX steps (leaves summed over the lanes); its rows through
reduce_rows give autograd's cells, sigma_a, sigma_s and le gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import render as jrender
from nart_tpu.integrators import volume as jvol
from nart_tpu.scene import MediumData as JMedium
from nart_tpu_torch import media, testing, vol_ops
from nart_tpu_torch import render as trender
from nart_tpu_torch.integrators import volume as tvol
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

N, SEED = 256, 3
STEPS = [1, 2, 4]
RTOL, ATOL = 1e-5, 1e-6
GRADS = ("g_beta", "g_l", "rows", "idx", "p_sa", "p_ss", "p_le")


@pytest.fixture(scope="module")
def lanes():
    return testing.vol_lane_set(N, SEED)


def _args(s):
    return s["cells"], s["medium"], s["sigma_maj"], s["bounces"]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _f64(s):
    """The lane set with beta, l_out, the cells and the medium's sigma_a,
    sigma_s and le in float64."""
    vs = dataclasses.replace(s["vs"], beta=s["vs"].beta.double(),
                             l_out=s["vs"].l_out.double())
    med = dataclasses.replace(s["medium"], sigma_a=s["medium"].sigma_a
                              .double(), sigma_s=s["medium"].sigma_s.double(),
                              le=s["medium"].le.double())
    return vs, s["cells"].double(), med


def test_lane_set_meets_every_branch(lanes):
    """Over 4 steps the set takes every branch of a step, and its corner
    lanes take the null event at p_null = 0 exactly."""
    vs, seen = lanes["vs"], dict.fromkeys(
        ("absorb", "scatter", "null", "missed", "left_segment",
         "left_medium", "over", "null_at_0"), 0)
    corner = lanes["kind"] == testing.VOL_KINDS.index("null_at_majorant")
    for _ in range(4):
        rec = {}
        out, died, esc = vol_ops.step_plain(vs, *_args(lanes), rec=rec)
        for e in ("absorb", "scatter", "null"):
            seen[e] += int(rec[e].sum())
        pn = 1.0 - rec["p_absorb"] - rec["p_scatter"]
        seen["null_at_0"] += int((rec["null"] & (pn == 0.0) & corner).sum())
        seen["over"] += int((rec["scatter"] & ~out.alive
                             & (vs.bounce > lanes["bounces"])).sum())
        setup = vs.alive & vs.new_ray
        seen["missed"] += int((setup & esc & ~out.new_ray).sum())
        inside = ((rec["p"] >= lanes["medium"].bounds_min)
                  & (rec["p"] <= lanes["medium"].bounds_max)).all(-1)
        seen["left_medium"] += int((esc & ~setup & ~inside).sum())
        seen["left_segment"] += int((esc & inside).sum())
        vs = out
    assert all(v > 0 for v in seen.values()), seen
    assert int((~lanes["vs"].alive).sum()) > 0


@pytest.mark.parametrize("k", STEPS)
def test_flight_steps_is_k_plain_steps(lanes, k):
    """flight_steps on CPU tensors: k calls of the plain step, died and
    esc OR-ed, the segment starts summed, bit for bit; and the integrator's
    steps (volume._make_vol_step) take that route."""
    vs = lanes["vs"]
    out, died, esc, seg = vol_ops.flight_steps(vs, k, *_args(lanes))
    want, want_died, want_esc, want_seg = vs, 0, 0, 0
    for _ in range(k):
        want_seg += int((want.alive & want.new_ray).sum())
        want, d, e = vol_ops.step_plain(want, *_args(lanes))
        want_died, want_esc = d | want_died, e | want_esc
    for f in vol_ops.FIELDS:
        assert torch.equal(_bits(getattr(out, f)), _bits(getattr(want, f))), f
    assert torch.equal(died, want_died) and torch.equal(esc, want_esc)
    assert int(seg) == want_seg


def _jax_medium(s):
    m = s["medium"]
    _, dens = testing.vol_medium("cpu", SEED)
    return JMedium(bounds_min=m.bounds_min.numpy(),
                   bounds_max=m.bounds_max.numpy(),
                   sigma_a=np.float32(m.sigma_a), sigma_s=np.float32(
                       m.sigma_s), le=m.le.numpy(), density=dens,
                   sigma_maj=m.sigma_maj)


def _jax_state(vs, beta=None, l_out=None):
    def j(t):
        return jnp.asarray(t.numpy())
    return (j(vs.alive), j(vs.new_ray), jnp.asarray(vs.bounce.numpy()
                                                    .astype(np.int32)),
            j(vs.u_mode), j(vs.t_cur), j(vs.t_exit), j(vs.o), j(vs.d),
            jnp.asarray(vs.state.numpy().astype(np.uint32)),
            j(vs.beta) if beta is None else beta,
            j(vs.l_out) if l_out is None else l_out)


def _jax_steps(jm, s, k, state):
    n = state[0].shape[0]
    jp = jrender.RenderParams(bounces=s["bounces"], integrator="volume")
    step, _ = jvol._make_vol_step(None, jm, jp, n, defer_light=True)
    died = esc = jnp.zeros(n, bool)
    for _ in range(k):
        state, d, e = step(state)
        died, esc = died | d, esc | e
    return state, died, esc


@pytest.mark.parametrize("k", STEPS)
def test_flight_steps_match_jax(lanes, k):
    """flight_steps against the JAX package's step composed k times: the
    same events and draws (alive, new_ray, bounce, u_mode, the RNG state,
    beta, died, esc the same bits on every lane), the floats that pass
    through log, sin, cos or the density's sum within rtol 1e-5 / atol
    1e-6."""
    vs = lanes["vs"]
    out, died, esc, _ = vol_ops.flight_steps(vs, k, *_args(lanes))
    got, jdied, jesc = _jax_steps(_jax_medium(lanes), lanes, k,
                                  _jax_state(vs))
    for f, j in zip(vol_ops.FIELDS, got):
        t, j = getattr(out, f).numpy(), np.asarray(j)
        if f in ("t_cur", "t_exit", "o", "d", "l_out"):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=f)
        elif t.dtype == np.float32:
            assert (t.view(np.int32) == j.view(np.int32)).all(), f
        else:
            assert (t.astype(np.int64) == j.astype(np.int64)).all(), f
    assert (died.numpy() == np.asarray(jdied)).all()
    assert (esc.numpy() == np.asarray(jesc)).all()


@pytest.mark.parametrize("k", STEPS)
def test_vjp_plain_float64_is_autograd(lanes, k):
    """In float64 the twin is autograd of the plain steps to 1e-10, lane by
    lane: the incoming cotangents, every step's row at its cell, the
    partials."""
    vs, cells, med = _f64(lanes)
    args = (cells, med, lanes["sigma_maj"], lanes["bounces"],
            lanes["g_beta"].double(), lanes["g_l"].double())
    got = vol_ops.flight_steps_vjp_plain(vs, k, *args)
    *want, agree = vol_ops.flight_steps_vjp_reference(vs, k, *args)
    assert bool(agree.all())
    for name, a, b in zip(GRADS, got, want):
        assert a.dtype == b.dtype, name
        if name == "idx":
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10, err_msg=name)


@pytest.mark.parametrize("k", STEPS)
def test_vjp_plain_float32_within_float64(lanes, k):
    """The twin on float32 inputs (V2's arithmetic: a float32 forward, a
    float64 reverse pass) within rtol 1e-5 / atol 1e-6 of the float64 VJP
    on every lane (each lane's float64 forward takes the float32 events),
    finite everywhere."""
    vs = lanes["vs"]
    got = vol_ops.flight_steps_vjp_plain(vs, k, *_args(lanes),
                                         lanes["g_beta"], lanes["g_l"])
    *want, agree = vol_ops.flight_steps_vjp_reference(
        vs, k, *_args(lanes), lanes["g_beta"], lanes["g_l"])
    assert bool(agree.all())
    for name, a, b in zip(GRADS, got, want):
        if name == "idx":
            assert torch.equal(a, b)
            continue
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_float32_reverse_pass_is_off_near_the_majorant(lanes):
    """Why V2's reverse pass is float64: on the null events near the
    majorant (p_null 1e-3, whose float32 value carries an error of ~1e-4
    of itself into 1 / p_null) the plain float32 VJP's rows and sigma
    partials leave rtol 1e-5 / atol 1e-6 of the float64 VJP, and only
    there; the twin's stay within it."""
    near = lanes["kind"] == testing.VOL_KINDS.index("near_majorant")
    args = (*_args(lanes), lanes["g_beta"], lanes["g_l"])
    twin = vol_ops.flight_steps_vjp_plain(lanes["vs"], 1, *args)
    *r64, agree = vol_ops.flight_steps_vjp_reference(lanes["vs"], 1, *args)
    *r32, _ = vol_ops.flight_steps_vjp_reference(lanes["vs"], 1, *args,
                                                 dtype=torch.float32)
    assert bool(agree.all())
    off = torch.zeros(N, dtype=torch.bool)
    for j, name in enumerate(GRADS):
        if name == "idx":
            continue
        lim = ATOL + RTOL * r64[j].abs()
        assert not bool(((twin[j].double() - r64[j]).abs() > lim).any())
        bad = (r32[j].double() - r64[j]).abs() > lim
        off |= bad.reshape(-1, N, bad.shape[-1]).any(0).any(-1) if (
            name == "rows") else bad.reshape(N, -1).any(-1)
    assert int(off.sum()) > 0 and bool((off <= near).all())


def _leaf_grads_torch(s, k, dtype):
    """Autograd of the plain steps' (beta, l_out) with the cotangents, as
    the leaves (beta, l_out, density, sigma_a, sigma_s, le) in dtype."""
    m = s["medium"]
    leaves = [x.detach().to(dtype).requires_grad_() for x in (
        s["vs"].beta, s["vs"].l_out, m.density, m.sigma_a, m.sigma_s, m.le)]
    med = dataclasses.replace(m, density=leaves[2], sigma_a=leaves[3],
                              sigma_s=leaves[4], le=leaves[5])
    vs = dataclasses.replace(s["vs"], beta=leaves[0], l_out=leaves[1])
    out, _, _, _ = vol_ops.flight_steps_plain(
        vs, k, media.pack_density_cells(leaves[2]), med, s["sigma_maj"],
        s["bounces"])
    return torch.autograd.grad([out.beta, out.l_out], leaves,
                               [s["g_beta"].to(dtype), s["g_l"].to(dtype)])


def _twin_leaves(s, k):
    """The twin's per-lane outputs reduced to (beta, l_out, density,
    sigma_a, sigma_s, le) gradients: reduce_rows, then the cells' gradient
    through pack_density_cells."""
    m = s["medium"]
    g_b, g_l, rows, idx, p_sa, p_ss, p_le = vol_ops.flight_steps_vjp_plain(
        s["vs"], k, *_args(s), s["g_beta"], s["g_l"])
    g_cells, g_sa, g_ss, g_le = vol_ops.reduce_rows(
        rows, idx, p_sa, p_ss, p_le, s["cells"].shape[0], m.sigma_a,
        m.sigma_s, m.le)
    dens = m.density.detach().requires_grad_()
    (g_dens,) = torch.autograd.grad(media.pack_density_cells(dens), dens,
                                    g_cells)
    return g_b, g_l, g_dens, g_sa, g_ss, g_le


def _without_near(s):
    """The lane set without its lanes near the majorant, where a float32
    VJP (autograd's or jax.vjp's) is off the float64 one (see
    test_float32_reverse_pass_is_off_near_the_majorant)."""
    keep = s["kind"] != testing.VOL_KINDS.index("near_majorant")
    return dict(s, vs=vol_ops.VolState(*[getattr(s["vs"], f)[keep]
                                         for f in vol_ops.FIELDS]),
                g_beta=s["g_beta"][keep], g_l=s["g_l"][keep],
                kind=s["kind"][keep])


@pytest.mark.parametrize("k", STEPS)
def test_reduce_rows_gives_autograd_leaves(lanes, k):
    """The twin's rows and partials through reduce_rows (one large-table
    backward, torch sums): autograd's gradients of the density (through
    the cells), sigma_a, sigma_s and le, and of the incoming beta and
    l_out, within rtol 1e-5 / atol 1e-6 of float64 autograd on every
    lane; float32 autograd's (the CPU route's) too on the lanes away from
    the majorant."""
    for s, dtype in ((lanes, torch.float64),
                     (_without_near(lanes), torch.float32)):
        got = _twin_leaves(s, k)
        want = _leaf_grads_torch(s, k, dtype)
        for name, a, b in zip(("beta", "l_out", "density", "sigma_a",
                               "sigma_s", "le"), got, want):
            assert a.shape == b.shape and a.dtype == torch.float32, name
            np.testing.assert_allclose(a.double().numpy(),
                                       b.double().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} {dtype}")


@pytest.mark.parametrize("k", STEPS)
def test_vjp_plain_matches_jax_vjp(lanes, k):
    """The twin's gradients (reduced as the Function reduces them) against
    jax.vjp of the JAX package's step composed k times, with respect to
    the incoming beta and l_out, the density, sigma_a, sigma_s and le:
    rtol 1e-5 / atol 1e-6, on the lanes away from the majorant (jax.vjp
    runs in float32)."""
    lanes = _without_near(lanes)
    jm = _jax_medium(lanes)
    vs = lanes["vs"]

    def f(beta, l_out, density, sigma_a, sigma_s, le):
        med = dataclasses.replace(jm, density=density, sigma_a=sigma_a,
                                  sigma_s=sigma_s, le=le)
        out, _, _ = _jax_steps(med, lanes, k, _jax_state(vs, beta, l_out))
        return out[9], out[10]

    primals = (jnp.asarray(vs.beta.numpy()), jnp.asarray(vs.l_out.numpy()),
               jnp.asarray(jm.density), jnp.float32(jm.sigma_a),
               jnp.float32(jm.sigma_s), jnp.asarray(jm.le))
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(lanes["g_beta"].numpy()),
                jnp.asarray(lanes["g_l"].numpy())))
    got = _twin_leaves(lanes, k)
    for name, a, b in zip(("beta", "l_out", "density", "sigma_a", "sigma_s",
                           "le"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_zero_gradient_at_p_null_zero(lanes):
    """At the majorant the null event's probability is 0 (the corner lanes
    choose null with p_null == 0 exactly in their first step): its ratio
    is 1 with a zero gradient, so with only beta's cotangent that step's
    row of every such lane is 0 (and for k = 1 every partial), all
    finite, and beta's cotangent passes the step unchanged; float32
    autograd of the plain steps agrees."""
    corner = lanes["kind"] == testing.VOL_KINDS.index("null_at_majorant")
    sub = {k: v for k, v in lanes.items()}
    sub["vs"] = vol_ops.VolState(*[getattr(lanes["vs"], f)[corner]
                                   for f in vol_ops.FIELDS])
    n = int(corner.sum())
    assert n > 0
    g_b = lanes["g_beta"][corner]
    zero = torch.zeros((n, 3))
    rec = {}
    vol_ops.step_plain(sub["vs"], *_args(lanes), rec=rec)
    assert bool(rec["null"].all())
    assert bool((1.0 - rec["p_absorb"] - rec["p_scatter"] == 0.0).all())
    for k in STEPS:
        g = vol_ops.flight_steps_vjp_plain(sub["vs"], k, *_args(lanes), g_b,
                                           zero)
        *want, _ = vol_ops.flight_steps_vjp_reference(
            sub["vs"], k, *_args(lanes), g_b, zero, dtype=torch.float32)
        for name, x, y in zip(GRADS, g, want):
            if name != "idx":
                assert bool(torch.isfinite(x).all()), name
                assert bool(torch.isfinite(y).all()), name
        assert not bool(g[2][0].any()) and not bool(want[2][0].any())
        if k == 1:
            assert torch.equal(g[0], g_b)
            for x in (g[4], g[5], g[6], want[4], want[5], want[6]):
                assert not bool(x.any())


def test_the_rounds_call_flight_steps(monkeypatch):
    """The machines' rounds call flight_steps once with k = FUSE_STEPS
    (read when called), the lockstep walk once a step with k = 1."""
    calls = []
    real = vol_ops.flight_steps

    def spy(vs, k, *args):
        calls.append(k)
        return real(vs, k, *args)

    monkeypatch.setattr(vol_ops, "flight_steps", spy)
    sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5))
    params = trender.RenderParams(image_width=4, image_height=4, spp=1,
                                  bounces=4, integrator="volume",
                                  filter_width=1.0)
    samples = trender.image_samples(4, 4, 6, 1, "cpu")
    tvol.trace_vol_static(sc, None, samples, params, 4, 4)
    assert calls and set(calls) == {tvol.FUSE_STEPS}
    monkeypatch.setattr(tvol, "FUSE_STEPS", 3)
    calls.clear()
    tvol.trace_balanced(sc, None, samples, params, 4, 4)
    assert calls and set(calls) == {3}
    calls.clear()
    o = torch.tensor([[0.0, 0.0, 3.0]]).expand(16, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(16, 3).contiguous()
    tvol.trace(sc, None, o, d, torch.arange(1, 17), params)
    assert calls and set(calls) == {1}


def test_flight_steps_add_into_an_accumulator(lanes):
    """flight_steps' seg: the segment starts added in place into the
    caller's () int64 accumulator (the machines' ray count), which is the
    tensor returned, the same count as a call without one; the
    integrator's steps take it the same way."""
    vs = lanes["vs"]
    _, _, _, fresh = vol_ops.flight_steps(vs, 4, *_args(lanes))
    acc = torch.tensor(7, dtype=torch.int64)
    out = vol_ops.flight_steps(vs, 4, *_args(lanes), acc)
    assert out[3] is acc and int(acc) == 7 + int(fresh)
    plain = vol_ops.flight_steps_plain(vs, 4, *_args(lanes), seg=acc)
    assert plain[3] is acc and int(acc) == 7 + 2 * int(fresh)
    for f in vol_ops.FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(plain[0], f)), f
    assert torch.equal(out[1], plain[1]) and torch.equal(out[2], plain[2])


def test_cuda_wrappers_refuse():
    """The kernels' wrappers refuse CPU tensors and a step count one launch
    does not take, before any build or launch; flight_steps refuses a
    direction that requires grad on the card only (CPU tensors take the
    plain steps, whose autograd differentiates everything)."""
    s = testing.vol_lane_set(8, 1)
    args = [getattr(s["vs"], f) for f in vol_ops.FIELDS] + [
        s["cells"], s["medium"].sigma_a, s["medium"].sigma_s, s["medium"].le,
        s["medium"].bounds_min, s["medium"].bounds_max, s["sigma_maj"]]
    shape = tuple(s["medium"].density.shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vol_ops.steps_cuda(1, 2, shape, *args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vol_ops.steps_bwd_cuda(4, 2, shape, *args, s["g_beta"], s["g_l"])
    with pytest.raises(ValueError, match="1 to 8"):
        vol_ops.steps_cuda(vol_ops.MAX_STEPS + 1, 2, shape, *args)
    for fn in (vol_ops.steps_ref_cuda, vol_ops.steps_bwd_ref_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(1, 2, shape, *args, s["g_beta"], s["g_l"])
    with pytest.raises(ValueError, match="seg must be a"):
        vol_ops.steps_cuda(1, 2, shape, *args, seg=torch.zeros(()))
    d = s["vs"].d.clone().requires_grad_()
    out = vol_ops.flight_steps(dataclasses.replace(s["vs"], d=d), 1,
                               *_args(s))
    assert out[0].d.requires_grad
