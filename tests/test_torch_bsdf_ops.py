"""nart_tpu_torch.bsdf_ops (the path round's BSDF calls: BSDF::Sample_f,
and BSDF::f with BSDF::Pdf) vs nart_tpu.bxdf on the CPU.

The same numpy inputs (test_torch_shading's LOBES: all five lobe codes,
plastic's two-lobe mixes, mirror) through the JAX functions and the port's
sample_f, eval_f_pdf and sample_eval_f (the two in one call, a path
round's strategy A and B), which on CPU tensors call the plain versions
(bxdf.py), differentiated by autograd.  Tolerance, test_torch_shading's _close: continuous
outputs and gradients to rtol 1e-5 / atol 1e-6 on >= 99.5% of the lanes
and to rtol 1e-3 / atol 1e-5 on all (near-grazing microfacet terms amplify
the libraries' last-bit differences), discrete outputs (flags) exactly.
The gradients of rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo and
eta_outer (and, through the sample, of alpha_i and eta_sampled) against
jax.vjp with the same random cotangents (the sample's in float64 at the
port's sample, wi and flags held fixed as the call sites hold them,
through the JAX package's lobe functions), on the lanes where JAX's is
finite: on index-matched lanes (eta_outer == eta) of the lobe kinds that
carry a dielectric or a specular lobe, the JAX package's VJP of
bsdf_sample_f is NaN in eta, wo and eta_outer (its unselected dielectric
branches), the port's finite.  wi, pdf and flags carry no
gradient, and eval_f_pdf refuses a wi that requires grad (sample_eval_f
a wi_b that does, or that is not wo's device and shape).  sample_eval_f
is sample_f then eval_f_pdf bit for bit, outputs and leaf gradients, and
matches the JAX functions to the same tolerance.  One path round of
macbeth calls sample_eval_f once and sample_f once (the scatter), and
bxdf's bsdf_sample_f, bsdf_f and bsdf_pdf run only inside them.  The reference for X3 in "sample" mode (bsdf_ops.sample_at_plain:
f, alpha_i and eta_sampled at a given sample) has bsdf_sample_f's bits.
The plain VJP's repaired fault (NaN from lobes a lane does not have,
which the JAX package's VJP keeps) is pinned here; the kernels (csrc/bsdf.cu) against the plain versions on the card
are in tests/test_torch_kernels.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import bxdf as jb
from nart_tpu_torch import bsdf_ops, cuda_build
from nart_tpu_torch import bxdf as tb
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_shading import (LOBES, _both_desc, _close,
                                      _desc_inputs, _dirs)

N = 512
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")


def _inputs(kind, n=N, seed=None):
    """numpy inputs of one LOBES kind: (desc dict, the rest)."""
    g = np.random.default_rng(len(kind) if seed is None else seed)
    d = _desc_inputs(kind, n, g)
    two_sided = kind.startswith("glass")
    x = dict(
        wo=_dirs(n, g, upper=None if two_sided else True),
        wi=_dirs(n, g, upper=None if two_sided else True),
        use_prime=g.random(n) < 0.5,
        eta_outer=np.where(g.random(n) < 0.2, d["eta"], 1.0).astype(
            np.float32),
        u1=g.random(n, dtype=np.float32),
        u2=g.random((n, 2), dtype=np.float32),
        prev_flags=g.integers(0, 16, n).astype(np.int32),
        g_f=g.normal(size=(n, 3)).astype(np.float32),
        g_alpha_i=g.normal(size=n).astype(np.float32),
        g_eta=g.normal(size=n).astype(np.float32),
    )
    return d, x


def _t(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if x.dtype == np.int32 else t


def _jax_diff(dj, wo, eta_outer):
    return (dj.rho_d, dj.rho_s, dj.tau, dj.eta, dj.alpha0, dj.alpha_prime,
            wo, eta_outer)


def _jax_vjp(fn, dj, wo, eta_outer, cots):
    """jax.vjp of fn(desc, wo, eta_outer) -> outputs, the cotangents of
    the outputs at cots' keys; gradients in bsdf_ops.DIFF's order."""
    def f(rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo, eta_outer):
        d = dj._replace(rho_d=rho_d, rho_s=rho_s, tau=tau, eta=eta,
                        alpha0=alpha0, alpha_prime=alpha_prime)
        outs = fn(d, wo, eta_outer)
        return tuple(outs[k] for k in cots)
    _, vjp = jax.vjp(f, *_jax_diff(dj, wo, eta_outer))
    return vjp(tuple(jnp.asarray(c) for c in cots.values()))


def _close_vjp(t, j, name):
    """_close on the lanes where the JAX VJP is finite; the port's is
    finite on every lane.  Returns the lanes where JAX's is not."""
    t, j = t.numpy(), np.asarray(j)
    bad = ~np.isfinite(j).reshape(j.shape[0], -1).all(-1)
    assert np.isfinite(t).all(), name
    _close(t[~bad], j[~bad], name)
    return bad


def _leaves(dt, x):
    """The port's differentiable inputs as leaves that require grad."""
    leaves = [t.clone().requires_grad_() for t in
              bsdf_ops._diff(dt, _t(x["wo"]), _t(x["eta_outer"]))]
    desc, wo, eta_outer = bsdf_ops._with_diff(dt, leaves)
    return leaves, desc, wo, eta_outer


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_functions_forward_match_jax(kind):
    """sample_f and eval_f_pdf against bxdf.bsdf_sample_f, bsdf_f and
    bsdf_pdf of the JAX package."""
    d, x = _inputs(kind)
    dj, dt = _both_desc(d)
    out_t = bsdf_ops.sample_f(dt, _t(x["wo"]), _t(x["u1"]), _t(x["u2"]),
                              _t(x["use_prime"]), _t(x["eta_outer"]),
                              _t(x["prev_flags"]))
    out_j = jb.bsdf_sample_f(dj, *[jnp.asarray(x[k]) for k in (
        "wo", "u1", "u2", "use_prime", "eta_outer", "prev_flags")])
    for name, a, b in zip(("f", "wi", "pdf", "flags", "alpha_i", "eta"),
                          out_t, out_j):
        _close(a, b, name)
    f_t, pdf_t = bsdf_ops.eval_f_pdf(dt, _t(x["wo"]), _t(x["wi"]),
                                     _t(x["use_prime"]), _t(x["eta_outer"]))
    J = [jnp.asarray(x[k]) for k in ("wo", "wi", "use_prime", "eta_outer")]
    _close(f_t, jb.bsdf_f(dj, *J), "f")
    _close(pdf_t, jb.bsdf_pdf(dj, *J), "pdf")


def _jax_sample_at(dj, wo, wi, u1, u2, use_prime, eta_outer, prev_flags,
                   flags):
    """bsdf_ops.sample_at_plain in the JAX package's terms: bsdf_sample_f's
    f, alpha_i and eta_sampled at a given sample (wi, flags), from
    nart_tpu.bxdf's own lobe functions."""
    n_f = dj.n_lobes.astype(jnp.float32)
    idx = jnp.clip((u1 * n_f).astype(jnp.int32), 0, 1)
    code = jnp.where(idx == 0, dj.lobe[..., 0], dj.lobe[..., 1])
    other = jnp.where(idx == 1, dj.lobe[..., 0], dj.lobe[..., 1])
    picked = [code == k for k in (jb.L_LAMBERT, jb.L_TS, jb.L_DIELECTRIC,
                                  jb.L_SPECULAR)]
    f = jb._lobe_f(dj, code, wo, wi, use_prime, eta_outer)
    matched = (eta_outer == dj.eta) & picked[2]
    f = jnp.where(matched[..., None], dj.tau, f)
    f = jnp.where(picked[3][..., None],
                  jb.specular_sample(dj, wo, eta_outer)[0], f)
    specdiel = ~(picked[0] | picked[1] | picked[2] | picked[3])
    f = jnp.where(specdiel[..., None], jb.specdiel_sample(
        dj, wo, u2, eta_outer, prev_flags)[0], f)
    mix = (((flags & jb.SPECULAR) == 0) & (dj.n_lobes >= 2)
           & ~jb.lobe_static_specular(other))
    add = mix & (jb._lobe_pdf(dj, other, wo, wi, use_prime, eta_outer) > 0.0)
    f = f + jnp.where(add[..., None],
                      jb._lobe_f(dj, other, wo, wi, use_prime, eta_outer),
                      0.0)
    alpha_i = jnp.where(picked[1] | picked[2], jb._ts_alpha(dj, use_prime),
                        jnp.where(picked[0], 1.0, 0.0))
    return f, alpha_i, jb.lobe_eta(dj, code)


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_sample_gradients_match_jax_vjp(kind):
    """The gradients through sample_f (cotangents on f, alpha_i and
    eta_sampled) against jax.vjp of the JAX package's lobe functions at
    the port's sample (wi and flags held fixed, as every call site holds
    them), both in float64: at a sampled direction a microfacet f's
    derivatives amplify the two libraries' float32 last bits (1 - z^2 at
    z near 1) past the tolerance on 1-4% of the lanes."""
    d, x = _inputs(kind)
    d, x = ({k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in y.items()} for y in (d, x))
    dj, dt = _both_desc(d)
    leaves, desc, wo, eta_outer = _leaves(dt, x)
    f, wi, _, flags, alpha_i, eta_s = bsdf_ops.sample_f(
        desc, wo, _t(x["u1"]), _t(x["u2"]), _t(x["use_prime"]), eta_outer,
        _t(x["prev_flags"]))
    got = torch.autograd.grad((f, alpha_i, eta_s), leaves,
                              (_t(x["g_f"]), _t(x["g_alpha_i"]),
                               _t(x["g_eta"])), allow_unused=True)
    with jax.enable_x64(True):
        dj = jb.BsdfDesc(**{k: jnp.asarray(v) for k, v in d.items()})
        rest = [jnp.asarray(x[k]) for k in ("u1", "u2", "use_prime",
                                            "prev_flags")]
        wi_j, flags_j = jnp.asarray(wi.numpy()), jnp.asarray(flags.numpy())
        at = _jax_sample_at(dj, jnp.asarray(x["wo"]), wi_j, rest[0],
                            rest[1], rest[2], jnp.asarray(x["eta_outer"]),
                            rest[3], flags_j)
        want = _jax_vjp(
            lambda dd, wo_, eo: _jax_sample_at(dd, wo_, wi_j, rest[0],
                                               rest[1], rest[2], eo,
                                               rest[3], flags_j),
            dj, jnp.asarray(x["wo"]), jnp.asarray(x["eta_outer"]),
            {0: x["g_f"], 1: x["g_alpha_i"], 2: x["g_eta"]})
    for name, a, b in zip(("f", "alpha_i", "eta"), (f, alpha_i, eta_s), at):
        _close(a.detach(), b, name)
    matched = x["eta_outer"] == d["eta"]
    for name, a, b in zip(bsdf_ops.DIFF, got, want):
        a = torch.zeros_like(leaves[0]) if a is None else a
        assert not (_close_vjp(a, b, name) & ~matched).any(), name


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_eval_gradients_match_jax_vjp(kind):
    """The gradients through eval_f_pdf (a cotangent on f) against jax.vjp
    of the JAX bsdf_f, wi held fixed."""
    d, x = _inputs(kind)
    dj, dt = _both_desc(d)
    leaves, desc, wo, eta_outer = _leaves(dt, x)
    f, pdf = bsdf_ops.eval_f_pdf(desc, wo, _t(x["wi"]), _t(x["use_prime"]),
                                 eta_outer)
    got = torch.autograd.grad(f, leaves, _t(x["g_f"]), allow_unused=True)
    wi, use_prime = jnp.asarray(x["wi"]), jnp.asarray(x["use_prime"])
    want = _jax_vjp(
        lambda dd, wo_, eo: (jb.bsdf_f(dd, wo_, wi, use_prime, eo),),
        dj, jnp.asarray(x["wo"]), jnp.asarray(x["eta_outer"]),
        {0: x["g_f"]})
    for name, a, b in zip(bsdf_ops.DIFF, got, want):
        _close_vjp(a, b, name)


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_sample_at_plain_has_sample_f_bits(kind):
    """X3's "sample" reference, sample_at_plain at bsdf_sample_f's own wi
    and flags, gives bsdf_sample_f's f, alpha_i and eta_sampled bit for
    bit, and its VJP (wi held fixed) is bsdf_sample_f's (where wi is
    detached) to the same bits here."""
    d, x = _inputs(kind)
    _, dt = _both_desc(d)
    args = [_t(x[k]) for k in ("u1", "u2", "use_prime", "eta_outer",
                               "prev_flags")]
    wo = _t(x["wo"])
    f, wi, _, flags, alpha_i, eta_s = bsdf_ops.sample_plain(
        dt, wo, args[0], args[1], args[2], args[3], args[4])
    at = bsdf_ops.sample_at_plain(dt, wo, wi, *args, flags)
    for a, b in zip(at, (f, alpha_i, eta_s)):
        assert torch.equal(a, b)
    cots = [_t(x[k]) for k in ("g_f", "g_alpha_i", "g_eta")]
    g_at = bsdf_ops.sample_at_bwd_plain(dt, wo, wi, *args, flags, *cots)
    g_plain = bsdf_ops.sample_bwd_plain(dt, wo, *args, *cots)
    for name, a, b in zip(bsdf_ops.DIFF, g_at, g_plain):
        _close(a, b.numpy(), name)


def test_wi_pdf_flags_carry_no_gradient():
    """wi, pdf and flags of the sample and pdf of the eval have no
    grad_fn; f, alpha_i and eta_sampled do."""
    d, x = _inputs("plastic")
    _, dt = _both_desc(d)
    _, desc, wo, eta_outer = _leaves(dt, x)
    f, wi, pdf, flags, alpha_i, eta_s = bsdf_ops.sample_f(
        desc, wo, _t(x["u1"]), _t(x["u2"]), _t(x["use_prime"]), eta_outer,
        _t(x["prev_flags"]))
    assert all(t.grad_fn is None and not t.requires_grad
               for t in (wi, pdf, flags))
    assert all(t.grad_fn is not None for t in (f, alpha_i, eta_s))
    f2, pdf2 = bsdf_ops.eval_f_pdf(desc, wo, wi, _t(x["use_prime"]),
                                   eta_outer)
    assert f2.grad_fn is not None
    assert pdf2.grad_fn is None and not pdf2.requires_grad


def test_eval_refuses_a_wi_that_requires_grad():
    """X3 holds wi fixed: eval_f_pdf refuses a wi with a gradient
    (under no_grad there is none to refuse)."""
    d, x = _inputs("glossy")
    _, dt = _both_desc(d)
    wi = _t(x["wi"]).requires_grad_()
    args = (dt, _t(x["wo"]), wi, _t(x["use_prime"]), _t(x["eta_outer"]))
    with pytest.raises(ValueError, match="wi must not require grad"):
        bsdf_ops.eval_f_pdf(*args)
    with torch.no_grad():
        f, _ = bsdf_ops.eval_f_pdf(*args)
    torch.testing.assert_close(f, bsdf_ops.eval_plain(*args)[0].detach(),
                               rtol=0, atol=0)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _sample_eval_both(kind, fused):
    """sample_eval_f, or sample_f then eval_f_pdf at wi, on one LOBES
    kind's lanes with leaves that require grad: (the eight outputs, the
    leaves' gradients of random cotangents on f, alpha_i, eta_sampled and
    f_b)."""
    d, x = _inputs(kind)
    _, dt = _both_desc(d)
    leaves, desc, wo, eta_outer = _leaves(dt, x)
    up, wi = _t(x["use_prime"]), _t(x["wi"])
    args = (desc, wo, _t(x["u1"]), _t(x["u2"]), up, eta_outer,
            _t(x["prev_flags"]))
    if fused:
        out = bsdf_ops.sample_eval_f(*args, wi)
    else:
        out = (*bsdf_ops.sample_f(*args),
               *bsdf_ops.eval_f_pdf(desc, wo, wi, up, eta_outer))
    g_f_b = np.random.default_rng(len(kind) + 1).normal(
        size=(N, 3)).astype(np.float32)
    cots = (_t(x["g_f"]), _t(x["g_alpha_i"]), _t(x["g_eta"]), _t(g_f_b))
    grads = torch.autograd.grad((out[0], out[4], out[5], out[6]), leaves,
                                cots, allow_unused=True)
    return out, grads


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_sample_eval_is_sample_then_eval(kind):
    """sample_eval_f on CPU tensors (the plain versions) gives sample_f's
    and eval_f_pdf's outputs bit for bit, and the same gradient of every
    leaf."""
    out, grads = _sample_eval_both(kind, True)
    want, want_grads = _sample_eval_both(kind, False)
    assert len(out) == 8
    for a, b in zip(out, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    for name, a, b in zip(bsdf_ops.DIFF, grads, want_grads):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_sample_eval_forward_matches_jax(kind):
    """sample_eval_f's eight outputs against bxdf.bsdf_sample_f, bsdf_f
    and bsdf_pdf of the JAX package, to test_torch_shading's _close
    tolerance (rtol 1e-5 / atol 1e-6 on >= 99.5% of the lanes, rtol 1e-3 /
    atol 1e-5 on all; flags exactly)."""
    d, x = _inputs(kind)
    dj, dt = _both_desc(d)
    out = bsdf_ops.sample_eval_f(
        dt, *[_t(x[k]) for k in ("wo", "u1", "u2", "use_prime", "eta_outer",
                                 "prev_flags", "wi")])
    out_j = jb.bsdf_sample_f(dj, *[jnp.asarray(x[k]) for k in (
        "wo", "u1", "u2", "use_prime", "eta_outer", "prev_flags")])
    J = [jnp.asarray(x[k]) for k in ("wo", "wi", "use_prime", "eta_outer")]
    out_j = (*out_j, jb.bsdf_f(dj, *J), jb.bsdf_pdf(dj, *J))
    for name, a, b in zip(("f", "wi", "pdf", "flags", "alpha_i", "eta",
                           "f_b", "pdf_b"), out, out_j):
        _close(a.detach(), b, name)


def test_sample_eval_pdf_b_carries_no_gradient():
    """sample_eval_f's wi, pdf, flags and pdf_b have no grad_fn; f,
    alpha_i, eta_sampled and f_b do."""
    d, x = _inputs("plastic")
    _, dt = _both_desc(d)
    _, desc, wo, eta_outer = _leaves(dt, x)
    out = bsdf_ops.sample_eval_f(
        desc, wo, _t(x["u1"]), _t(x["u2"]), _t(x["use_prime"]), eta_outer,
        _t(x["prev_flags"]), _t(x["wi"]))
    assert all(out[k].grad_fn is None and not out[k].requires_grad
               for k in (1, 2, 3, 7))
    assert all(out[k].grad_fn is not None for k in (0, 4, 5, 6))


@pytest.mark.parametrize("bad", ["requires grad", "shape", "lanes",
                                 "device"])
def test_sample_eval_refuses_a_bad_wi_b(bad):
    """X3 holds wi_b fixed and the kernel reads it lane by lane: a wi_b
    that requires grad (under no_grad there is none to refuse), of another
    shape or lane count than wo, or on another device, is refused before
    anything runs."""
    d, x = _inputs("glossy")
    _, dt = _both_desc(d)
    wi_b = _t(x["wi"])
    wi_b = {"requires grad": wi_b.clone().requires_grad_(),
            "shape": wi_b[:, :2], "lanes": wi_b[1:],
            "device": wi_b.to("meta")}[bad]
    args = (dt, *[_t(x[k]) for k in ("wo", "u1", "u2", "use_prime",
                                     "eta_outer", "prev_flags")], wi_b)
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError, match="wi_b must"):
        bsdf_ops.sample_eval_f(*args)
    assert not any(cuda_build.launch_counts.values())
    if bad == "requires grad":
        with torch.no_grad():
            out = bsdf_ops.sample_eval_f(*args)
        assert torch.equal(out[6], bsdf_ops.eval_plain(
            dt, args[1], wi_b, args[4], args[5])[0])


@pytest.mark.parametrize("entry", ["sample", "eval", "f_bwd",
                                   "sample_eval"])
def test_cuda_wrappers_refuse_cpu_tensors(entry):
    """The kernels' wrappers take CUDA tensors only: CPU tensors are
    refused before the library is built or anything launched."""
    d, x = _inputs("plastic", n=8)
    _, dt = _both_desc(d)
    wo, up, eo = _t(x["wo"]), _t(x["use_prime"]), _t(x["eta_outer"])
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if entry == "sample":
            bsdf_ops.sample_cuda(dt, wo, _t(x["u1"]), _t(x["u2"]), up, eo,
                                 _t(x["prev_flags"]))
        elif entry == "eval":
            bsdf_ops.eval_cuda(dt, wo, _t(x["wi"]), up, eo)
        elif entry == "sample_eval":
            bsdf_ops.sample_eval_cuda(dt, wo, _t(x["u1"]), _t(x["u2"]), up,
                                      eo, _t(x["prev_flags"]), _t(x["wi"]))
        else:
            bsdf_ops.f_bwd_cuda("eval", dt, wo, _t(x["wi"]), up, eo,
                                _t(x["g_f"]))
    with pytest.raises(ValueError, match="mode"):
        bsdf_ops.f_bwd_cuda("both", dt, wo, _t(x["wi"]), up, eo, None)
    with pytest.raises(ValueError, match="bits"):
        bsdf_ops.f_bwd_cuda("sample", dt, wo, _t(x["wi"]), up, eo, None)
    assert not any(cuda_build.launch_counts.values())


@pytest.mark.parametrize("entry", ["sample_ref", "f_bwd_ref"])
def test_reference_wrappers_refuse_cpu_tensors(entry):
    """The first designs' wrappers (sample_ref_cuda, f_bwd_ref_cuda) take
    CUDA tensors only, as the kernels' do: CPU tensors are refused before
    the library is built or anything launched."""
    d, x = _inputs("plastic", n=8)
    _, dt = _both_desc(d)
    wo, up, eo = _t(x["wo"]), _t(x["use_prime"]), _t(x["eta_outer"])
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if entry == "sample_ref":
            bsdf_ops.sample_ref_cuda(dt, wo, _t(x["u1"]), _t(x["u2"]), up, eo,
                                     _t(x["prev_flags"]))
        else:
            bsdf_ops.f_bwd_ref_cuda("eval", dt, wo, _t(x["wi"]), up, eo,
                                    _t(x["g_f"]))
    with pytest.raises(ValueError, match="bits"):
        bsdf_ops.f_bwd_ref_cuda("sample", dt, wo, _t(x["wi"]), up, eo, None)
    assert not any(cuda_build.launch_counts.values())


def test_plain_vjp_is_finite_where_the_jax_vjp_is_not():
    """wi = -wo makes wo + wi the zero vector in every microfacet lobe
    (evaluated on every lane, then selected): the JAX package's
    _normalize gives a NaN gradient there, on every lobe kind; the port's
    plain version keeps it finite (its zero vector is divided by 1, the
    sqrt kept out of the graph), and agrees with JAX elsewhere."""
    d, x = _inputs("lambert", n=64, seed=3)
    x["wi"][:8] = -x["wo"][:8]
    dj, dt = _both_desc(d)
    leaves, desc, wo, eta_outer = _leaves(dt, x)
    f, _ = bsdf_ops.eval_f_pdf(desc, wo, _t(x["wi"]), _t(x["use_prime"]),
                               eta_outer)
    got = torch.autograd.grad(f, leaves, _t(x["g_f"]), allow_unused=True)
    wi, use_prime = jnp.asarray(x["wi"]), jnp.asarray(x["use_prime"])
    want = _jax_vjp(
        lambda dd, wo_, eo: (jb.bsdf_f(dd, wo_, wi, use_prime, eo),),
        dj, jnp.asarray(x["wo"]), jnp.asarray(x["eta_outer"]),
        {0: x["g_f"]})
    g_wo = np.asarray(want[6])
    assert not np.isfinite(g_wo[:8]).all()
    assert all(bool(torch.isfinite(a).all()) for a in got)
    _close(got[6][8:], g_wo[8:], "wo")


def test_plain_vjp_nan_from_lobes_a_lane_lacks():
    """The plain VJP's fault, repaired: bsdf_f evaluates every lobe kind on
    every lane and selects after, so at grazing directions with alpha =
    1e-4 an unselected microfacet lobe's derivative (inf or NaN) times the
    zero the selection sends it was NaN, as the JAX package's VJP still is:
    a mirror lane, whose f does not depend on alpha at all, got a NaN
    alpha_prime gradient.  Each lobe now runs on its own lanes' inputs and
    on stand-ins elsewhere (bxdf._guard): every leaf's gradient is finite
    and the mirror lanes' alpha_prime gradient exactly 0."""
    d, x = _inputs("mirror", n=256, seed=5)
    d["alpha0"][:] = np.float32(1e-4)
    d["alpha_prime"][:] = np.float32(1e-4)
    g = np.random.default_rng(6)
    x["wo"][:, 2] = np.float32(1e-9)
    x["wi"][:, 2] = (10.0 ** g.uniform(-12, -3, 256)).astype(np.float32)
    x["use_prime"][:] = True
    dj, dt = _both_desc(d)
    leaves, desc, wo, eta_outer = _leaves(dt, x)
    f, _ = bsdf_ops.eval_f_pdf(desc, wo, _t(x["wi"]), _t(x["use_prime"]),
                               eta_outer)
    assert torch.equal(f, torch.zeros_like(f))  # a mirror has no f here
    got = torch.autograd.grad(f, leaves, _t(x["g_f"]), allow_unused=True)
    wi, use_prime = jnp.asarray(x["wi"]), jnp.asarray(x["use_prime"])
    want = _jax_vjp(
        lambda dd, wo_, eo: (jb.bsdf_f(dd, wo_, wi, use_prime, eo),),
        dj, jnp.asarray(x["wo"]), jnp.asarray(x["eta_outer"]),
        {0: x["g_f"]})
    for name, a in zip(bsdf_ops.DIFF, got):
        assert a is None or bool(torch.isfinite(a).all()), name
    assert got[5] is None or not bool(got[5].any())
    assert not np.isfinite(np.asarray(want[5])).all()


def _counting(monkeypatch):
    """Count the sample_f, eval_f_pdf and sample_eval_f calls in each round
    of make_bounce (round_ops.stop_after's hook opens a round), and every
    call of bxdf's three BSDF functions made outside them."""
    from nart_tpu_torch import round_ops

    seen = {"stray": 0}
    rounds = []
    inside = {"call": False}

    def watched(name, fn):
        def call(*a, **k):
            if not inside["call"]:
                seen["stray"] += 1
            return fn(*a, **k)
        monkeypatch.setattr(tb, name, call)

    for name in ("bsdf_sample_f", "bsdf_f", "bsdf_pdf"):
        watched(name, getattr(tb, name))

    def counted(slot, fn):
        def call(*a, **k):
            rounds[-1][slot] += 1
            inside["call"] = True
            try:
                return fn(*a, **k)
            finally:
                inside["call"] = False
        return call

    monkeypatch.setattr(bsdf_ops, "sample_f", counted(0, bsdf_ops.sample_f))
    monkeypatch.setattr(bsdf_ops, "eval_f_pdf",
                        counted(1, bsdf_ops.eval_f_pdf))
    monkeypatch.setattr(bsdf_ops, "sample_eval_f",
                        counted(2, bsdf_ops.sample_eval_f))
    monkeypatch.setattr(tpath, "make_bounce", tpath.make_bounce)  # restored
    round_ops.stop_after(tpath, "make_bounce", None, {"rounds": 0},
                         lambda *a: rounds.append([0, 0, 0]))
    return seen, rounds


def test_a_path_round_calls_the_functions(monkeypatch):
    """macbeth at 16x9 @ 1 spp on the per-round loop: every path round
    calls sample_eval_f once (strategy A's sample with strategy B's eval)
    and sample_f once (the scatter), eval_f_pdf never, and bxdf's BSDF
    functions run only inside them; so do
    a per-round fwd+bwd's rounds, whose backward (autograd over the plain
    versions on the CPU) reaches the material's leaves."""
    from nart_tpu_torch import bench
    from nart_tpu_torch import cluster_accel as tca
    from nart_tpu_torch import grad as tgrad

    seen, rounds = _counting(monkeypatch)
    sc = tscene.load_scene(os.path.join(FIX, "macbeth.json"), asset_root=FIX)
    params = trender.RenderParams(image_width=16, image_height=9, spp=1)
    sess = trender.RenderSession(sc, params, "cpu", per_round=True)
    img = sess.image()
    assert bool(torch.isfinite(img).all())
    assert len(rounds) >= 2 and {tuple(r) for r in rounds} == {(1, 0, 1)}, (
        rounds)
    assert seen["stray"] == 0

    rounds.clear()
    samples = trender.image_samples(16, 9, 16 + 2 * int(np.ceil(
        params.filter_width)), 1, "cpu")
    _, grads, _, n_rounds = tgrad.radiance_weighted_loss_and_grad(
        sc, tgrad.get_params(sc), tca.build_clusters(sc.tri_v.numpy()),
        samples, bench.rgb_cot(1, 16 * 9, "cpu"), params, 16, 9,
        device="cpu", per_round=True)
    assert n_rounds > 0 and {tuple(r) for r in rounds} == {(1, 0, 1)}, rounds
    assert seen["stray"] == 0
    g = grads["rho_d_const"]
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0


def test_round_ops_finds_the_bsdf_calls():
    """nart_tpu_torch.round_ops on the CPU (the plain route), macbeth 16x9
    @ 1, 2 rounds: the sample+eval call and the scatter's sample call are
    the two largest call sites of a path round, 80% of its operations,
    and the
    volume's flight step reads the medium's cells."""
    from nart_tpu_torch import round_ops
    from nart_tpu_torch.bench_configs import load_scene_doc

    sc = tscene.load_scene(round_ops.MACBETH, asset_root=FIX)
    params = trender.load_sessions(round_ops.MACBETH, {
        "image_width": 16, "image_height": 9, "spp": 1})[0]
    sites, n, launches = round_ops.round_ops("path", sc, params, "cpu", 2)
    assert n == 2 and launches == {}
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:2]
    assert sorted(callee for (_, callee), _ in top) == [
        "sample_eval_f", "sample_f"]
    assert sum(ops for _, ops in top) > 0.8 * sum(sites.values())
    vol = load_scene_doc(round_ops.VOLUME, os.path.dirname(round_ops.VOLUME))
    params = trender.load_sessions(round_ops.VOLUME, {
        "image_width": 16, "image_height": 9, "spp": 1})[0]
    sites, n, _ = round_ops.round_ops("volume", vol, params, "cpu", 2)
    assert n == 2
    assert any(callee == "medium_properties_cells" for _, callee in sites)


def test_mid_trace_bsdf_captures_the_sample_eval_call():
    """testing.mid_trace_bsdf (phase 27's and kernel_variants' lane sets)
    on macbeth 16x9 @ 1: a round's two BSDF calls, strategy A's sample
    with strategy B's eval ("sample A + eval B", with its wi_b) and the
    scatter's sample, copied; split_sample_eval gives the sample call's and
    the eval call's inputs, whose plain outputs are sample_eval_plain's."""
    from nart_tpu_torch import testing

    sc = tscene.load_scene(os.path.join(FIX, "macbeth.json"), asset_root=FIX)
    params = trender.RenderParams(image_width=16, image_height=9, spp=1)
    r, deep, calls = testing.mid_trace_bsdf(
        lambda: trender.RenderSession(sc, params, "cpu", per_round=True),
        rounds=3)
    assert 1 <= r <= 3 and deep >= 0
    assert list(calls) == ["sample A + eval B", "scatter"]
    fused = calls["sample A + eval B"]
    assert set(fused) == {"desc", "wo", "u1", "u2", "use_prime", "eta_outer",
                          "prev_flags", "wi_b"}
    assert "wi_b" not in calls["scatter"]
    s, e = testing.split_sample_eval(fused)
    assert e["wi"] is fused["wi_b"] and "wi_b" not in s
    keys = ("desc", "wo", "u1", "u2", "use_prime", "eta_outer", "prev_flags")
    out = bsdf_ops.sample_eval_plain(*[fused[k] for k in keys],
                                     fused["wi_b"])
    want = (*bsdf_ops.sample_plain(*[s[k] for k in keys]),
            *bsdf_ops.eval_plain(e["desc"], e["wo"], e["wi"], e["use_prime"],
                                 e["eta_outer"]))
    for a, b in zip(out, want):
        assert torch.equal(_bits(a), _bits(b))
