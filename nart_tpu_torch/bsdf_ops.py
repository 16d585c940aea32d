"""The BSDF lobe mixture of a path round, differentiable: BSDF::Sample_f
and BSDF::f with BSDF::Pdf as autograd Functions.

Counterpart of ``nart_tpu/bxdf.py``'s ``bsdf_sample_f``, ``bsdf_f`` and
``bsdf_pdf``, which reach no Pallas kernel: on the TPU XLA fuses their
masked evaluation of every lobe kind on every lane.  The port's plain
versions (``bxdf.py``) run that evaluation op by op, ~2,500 small kernels
a ``bsdf_sample_f``.  On CUDA tensors ``sample_f`` goes through
``_BsdfSample``, ``sample_eval_f`` through ``_BsdfSampleEval`` and
``eval_f_pdf`` through ``_BsdfEval``, autograd Functions whose forwards
are one launch each of csrc/bsdf.cu's ``nart_bsdf_sample`` (X1),
``nart_bsdf_sample_eval`` (X2's redesign: X1's sample and bsdf_f with
bsdf_pdf at a second direction wi_b of the same lanes, a path round's
strategy A and B, half of its threads running each) and
``nart_bsdf_eval`` (X2's first design), a thread computing only its
lane's own lobes, with the plain versions' bits; their backwards launch
``nart_bsdf_f_bwd`` (X3), the vector-Jacobian product of the
gradient-carrying outputs (f, and for the sample alpha_i and
eta_sampled) with wi held fixed: per-lane rows of the gradients of
rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo and
eta_outer (``sample_eval_f``'s twice, in "sample" and "eval" modes, the
two summed).  wi, pdf, flags and pdf_b carry no gradient (every call site
detaches them, as the JAX package's stop_gradient sites do), and
``eval_f_pdf`` and ``sample_eval_f`` refuse a wi (wi_b) that requires
grad.  Launches count in ``cuda_build.launch_counts`` as "bsdf_sample",
"bsdf_sample_eval", "bsdf_eval" and "bsdf_f_bwd" (inside a CUDA graph
capture, at every replay).  A path round calls ``sample_eval_f`` and
``sample_f`` (the scatter); ``eval_f_pdf`` is for other callers and the
reference the sample+eval launch's eval outputs are held to.  X1's and
X3's first designs stay as ``nart_bsdf_sample_ref`` and
``nart_bsdf_f_bwd_ref`` (``sample_ref_cuda``, ``f_bwd_ref_cuda``, counted
as "bsdf_sample_reference" and "bsdf_f_bwd_reference"): the references
the card's checks hold the redesign to; no path launches them.

On CPU tensors ``sample_f``, ``sample_eval_f`` and ``eval_f_pdf`` call the
plain versions (``bxdf``'s functions, wi and pdf detached) and autograd
differentiates them as it does any torch code, so CPU films, losses and
gradients are the plain functions'.  The Functions are the CUDA route
only: there is no fallback between the two, a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import bxdf, cuda_build

# the differentiable inputs, in X3's output order
DIFF = ("rho_d", "rho_s", "tau", "eta", "alpha0", "alpha_prime", "wo",
        "eta_outer")


def sample_f(desc: bxdf.BsdfDesc, wo, u1, u2, use_prime, eta_outer,
             prev_flags):
    """bxdf.bsdf_sample_f, wi and pdf without a gradient: (f, wi, pdf,
    flags, alpha_i, eta_sampled).  CUDA tensors go through _BsdfSample, CPU
    tensors through the plain version."""
    if not wo.is_cuda:
        return sample_plain(desc, wo, u1, u2, use_prime, eta_outer,
                            prev_flags)
    return _BsdfSample.apply(*desc, wo, u1, u2, use_prime, eta_outer,
                             prev_flags)


def eval_f_pdf(desc: bxdf.BsdfDesc, wo, wi, use_prime, eta_outer):
    """(bxdf.bsdf_f, bxdf.bsdf_pdf) of one (wo, wi), pdf without a
    gradient.  A wi that requires grad is refused (X3 holds it fixed).  CUDA
    tensors go through _BsdfEval, CPU tensors through the plain versions."""
    if wi.requires_grad and torch.is_grad_enabled():
        raise ValueError("eval_f_pdf: wi must not require grad (the call "
                         "sites detach it; X3 holds it fixed)")
    if not wo.is_cuda:
        return eval_plain(desc, wo, wi, use_prime, eta_outer)
    return _BsdfEval.apply(*desc, wo, wi, use_prime, eta_outer)


def sample_eval_f(desc: bxdf.BsdfDesc, wo, u1, u2, use_prime, eta_outer,
                  prev_flags, wi_b):
    """sample_f and eval_f_pdf at wi_b of the same lanes in one call: (f,
    wi, pdf, flags, alpha_i, eta_sampled, f_b, pdf_b), wi, pdf and pdf_b
    without a gradient.  A wi_b that requires grad, or is not wo's device
    and shape, is refused.  CUDA tensors go through _BsdfSampleEval (one
    launch of X2's redesign), CPU tensors through the plain versions."""
    if wi_b.requires_grad and torch.is_grad_enabled():
        raise ValueError("sample_eval_f: wi_b must not require grad (the "
                         "call site detaches it; X3 holds it fixed)")
    if wi_b.device != wo.device or wi_b.shape != wo.shape:
        raise ValueError(f"sample_eval_f: wi_b must be a {tuple(wo.shape)} "
                         f"tensor on {wo.device} (got {tuple(wi_b.shape)} on "
                         f"{wi_b.device})")
    if not wo.is_cuda:
        return sample_eval_plain(desc, wo, u1, u2, use_prime, eta_outer,
                                 prev_flags, wi_b)
    return _BsdfSampleEval.apply(*desc, wo, u1, u2, use_prime, eta_outer,
                                 prev_flags, wi_b)


def _diff(desc, wo, eta_outer):
    return (desc.rho_d, desc.rho_s, desc.tau, desc.eta, desc.alpha0,
            desc.alpha_prime, wo, eta_outer)


def _with_diff(desc, vals):
    """desc, wo and eta_outer with the DIFF fields replaced by vals."""
    d = desc._replace(**dict(zip(DIFF[:6], vals[:6])))
    return d, vals[6], vals[7]


class _BsdfSample(torch.autograd.Function):
    """bsdf_sample_f on the card: X1 forward, X3 ("sample") backward."""

    @staticmethod
    def forward(ctx, n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                alpha_prime, wo, u1, u2, use_prime, eta_outer, prev_flags):
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        ctx.set_materialize_grads(False)
        desc, wo, u1, u2, use_prime, eta_outer, prev_flags = _contiguous(
            desc, wo, u1, u2, use_prime, eta_outer, prev_flags)
        f, wi, pdf, flags, alpha_i, eta_s, bits = sample_cuda(
            desc, wo, u1, u2, use_prime, eta_outer, prev_flags)
        ctx.save_for_backward(*desc, wo, wi, u2, use_prime, eta_outer,
                              prev_flags, bits)
        ctx.mark_non_differentiable(wi, pdf, flags)
        return f, wi, pdf, flags, alpha_i, eta_s

    @staticmethod
    @once_differentiable
    def backward(ctx, g_f, _g_wi, _g_pdf, _g_flags, g_alpha_i, g_eta_s):
        (n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo, wi,
         u2, use_prime, eta_outer, prev_flags, bits) = ctx.saved_tensors
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        g = _needed(ctx, 8, 12, f_bwd_cuda(
            "sample", desc, wo, wi, use_prime, eta_outer,
            *_contiguous(g_f, g_alpha_i, g_eta_s), u2=u2,
            prev_flags=prev_flags, bits=bits))
        return (None, None, *g[:7], None, None, None, g[7], None)


class _BsdfEval(torch.autograd.Function):
    """(bsdf_f, bsdf_pdf) of one (wo, wi) on the card: X2 forward, X3
    ("eval") backward."""

    @staticmethod
    def forward(ctx, n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                alpha_prime, wo, wi, use_prime, eta_outer):
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        ctx.set_materialize_grads(False)
        desc, wo, wi, use_prime, eta_outer = _contiguous(
            desc, wo, wi, use_prime, eta_outer)
        f, pdf = eval_cuda(desc, wo, wi, use_prime, eta_outer)
        ctx.save_for_backward(*desc, wo, wi, use_prime, eta_outer)
        ctx.mark_non_differentiable(pdf)
        return f, pdf

    @staticmethod
    @once_differentiable
    def backward(ctx, g_f, _g_pdf):
        (n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo, wi,
         use_prime, eta_outer) = ctx.saved_tensors
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        g = _needed(ctx, 8, 11, f_bwd_cuda(
            "eval", desc, wo, wi, use_prime, eta_outer, *_contiguous(g_f)))
        return (None, None, *g[:7], None, None, g[7])


class _BsdfSampleEval(torch.autograd.Function):
    """sample_f and eval_f_pdf at wi_b on the card: X2's redesign forward
    (X1's and X2's outputs in one launch), X3 backward twice ("sample" at
    X1's wi, "eval" at wi_b, as _BsdfSample and _BsdfEval launch it), the
    two summed input by input."""

    @staticmethod
    def forward(ctx, n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                alpha_prime, wo, u1, u2, use_prime, eta_outer, prev_flags,
                wi_b):
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        ctx.set_materialize_grads(False)
        desc, wo, u1, u2, use_prime, eta_outer, prev_flags, wi_b = (
            _contiguous(desc, wo, u1, u2, use_prime, eta_outer, prev_flags,
                        wi_b))
        f, wi, pdf, flags, alpha_i, eta_s, bits, f_b, pdf_b = (
            sample_eval_cuda(desc, wo, u1, u2, use_prime, eta_outer,
                             prev_flags, wi_b))
        ctx.save_for_backward(*desc, wo, wi, u2, use_prime, eta_outer,
                              prev_flags, bits, wi_b)
        ctx.mark_non_differentiable(wi, pdf, flags, pdf_b)
        return f, wi, pdf, flags, alpha_i, eta_s, f_b, pdf_b

    @staticmethod
    @once_differentiable
    def backward(ctx, g_f, _g_wi, _g_pdf, _g_flags, g_alpha_i, g_eta_s,
                 g_f_b, _g_pdf_b):
        (n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0, alpha_prime, wo, wi,
         u2, use_prime, eta_outer, prev_flags, bits,
         wi_b) = ctx.saved_tensors
        desc = bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                             alpha_prime)
        g_s = f_bwd_cuda("sample", desc, wo, wi, use_prime, eta_outer,
                         *_contiguous(g_f, g_alpha_i, g_eta_s), u2=u2,
                         prev_flags=prev_flags, bits=bits)
        g_e = f_bwd_cuda("eval", desc, wo, wi_b, use_prime, eta_outer,
                         *_contiguous(g_f_b))
        for a, b in zip(g_s, g_e):  # g_s is this call's own: add in place
            a.add_(b)
        g = _needed(ctx, 8, 12, g_s)
        return (None, None, *g[:7], None, None, None, g[7], None, None)


def _needed(ctx, wo_at, eta_outer_at, grads):
    """grads with None where the input needs no gradient: the desc's six
    DIFF fields at arguments 2-7 of the Function's apply, wo and eta_outer
    at theirs."""
    n = ctx.needs_input_grad
    needs = (*n[2:8], n[wo_at], n[eta_outer_at])
    return tuple(g if need else None for g, need in zip(grads, needs))


def _contiguous(*xs):
    """Each tensor (a BsdfDesc's fields too) contiguous; None stays."""
    return tuple(bxdf.BsdfDesc(*_contiguous(*x))
                 if isinstance(x, bxdf.BsdfDesc)
                 else None if x is None else x.contiguous() for x in xs)


# ---------------------------------------------------------------------------
# Plain versions (the CPU's route, and the card's reference)
# ---------------------------------------------------------------------------


def sample_plain(desc, wo, u1, u2, use_prime, eta_outer, prev_flags):
    """X1's plain version: bxdf.bsdf_sample_f, wi and pdf detached."""
    f, wi, pdf, flags, alpha_i, eta_s = bxdf.bsdf_sample_f(
        desc, wo, u1, u2, use_prime, eta_outer, prev_flags)
    return f, wi.detach(), pdf.detach(), flags, alpha_i, eta_s


def eval_plain(desc, wo, wi, use_prime, eta_outer):
    """X2's plain version: (bxdf.bsdf_f, bxdf.bsdf_pdf), pdf detached."""
    return (bxdf.bsdf_f(desc, wo, wi, use_prime, eta_outer),
            bxdf.bsdf_pdf(desc, wo, wi, use_prime, eta_outer).detach())


def sample_then_eval(sample, evaluate):
    """A function of sample_eval_f's arguments that makes the two calls it
    stands for, sample(desc, wo, u1, u2, use_prime, eta_outer, prev_flags)
    and evaluate(desc, wo, wi_b, use_prime, eta_outer) (sample_f and
    eval_f_pdf, or their plain versions), and returns their outputs
    together."""
    def call(desc, wo, u1, u2, use_prime, eta_outer, prev_flags, wi_b):
        return (*sample(desc, wo, u1, u2, use_prime, eta_outer, prev_flags),
                *evaluate(desc, wo, wi_b, use_prime, eta_outer))
    return call


# X2's redesign's plain version: sample_plain, then eval_plain at wi_b
sample_eval_plain = sample_then_eval(sample_plain, eval_plain)


def sample_at_plain(desc, wo, wi, u1, u2, use_prime, eta_outer, prev_flags,
                    flags):
    """bsdf_sample_f's f, alpha_i and eta_sampled at a given sample: wi and
    flags as bsdf_sample_f (or X1) gave them, the lobes picked by u1 as
    there, every term from bxdf's own lobe functions.  In float32 these are
    bsdf_sample_f's bits; its VJP, wi held fixed, is the function X3
    computes in "sample" mode (chip_smoke.py holds X3 to its float64 VJP,
    where bsdf_sample_f's own VJP in float64 would sample another wi)."""
    n_f = desc.n_lobes.to(wo.dtype)
    idx = (u1 * n_f).to(torch.int64).clamp(0, 1)
    code = torch.where(idx == 0, desc.lobe[..., 0], desc.lobe[..., 1])
    other = torch.where(idx == 1, desc.lobe[..., 0], desc.lobe[..., 1])
    picked = [code == k for k in (bxdf.L_LAMBERT, bxdf.L_TS,
                                  bxdf.L_DIELECTRIC, bxdf.L_SPECULAR)]
    f = bxdf._lobe_f(desc, code, wo, wi, use_prime, eta_outer)
    matched = (eta_outer == desc.eta) & picked[2]
    f = torch.where(matched[..., None], desc.tau, f)
    f = torch.where(picked[3][..., None], bxdf.specular_sample(
        *bxdf._guard(picked[3], desc, wo, eta_outer))[0], f)
    specdiel = ~(picked[0] | picked[1] | picked[2] | picked[3])
    d, wo_s, eo_s = bxdf._guard(specdiel, desc, wo, eta_outer)
    f = torch.where(specdiel[..., None], bxdf.specdiel_sample(
        d, wo_s, u2, eo_s, prev_flags)[0], f)
    mix = (((flags & bxdf.SPECULAR) == 0) & (desc.n_lobes >= 2)
           & ~bxdf.lobe_static_specular(other))
    add = mix & (bxdf._lobe_pdf(desc, other, wo, wi, use_prime,
                                eta_outer) > 0.0)
    f = f + torch.where(add[..., None], bxdf._lobe_f(
        desc, other, wo, wi, use_prime, eta_outer), 0.0)
    alpha_i = torch.where(picked[1] | picked[2],
                          bxdf._ts_alpha(desc, use_prime),
                          torch.where(picked[0], 1.0, 0.0).to(wo.dtype))
    return f, alpha_i, bxdf.lobe_eta(desc, code)


def sample_at_bwd_plain(desc, wo, wi, u1, u2, use_prime, eta_outer,
                        prev_flags, flags, g_f, g_alpha_i=None,
                        g_eta_sampled=None):
    """The VJP of sample_at_plain (wi held fixed), in DIFF's order."""
    return _vjp_plain(
        lambda d, w, e: sample_at_plain(d, w, wi, u1, u2, use_prime, e,
                                        prev_flags, flags),
        desc, wo, eta_outer, (0, 1, 2), (g_f, g_alpha_i, g_eta_sampled))


def _vjp_plain(fn, desc, wo, eta_outer, keep, cots):
    """The plain VJP of fn(desc, wo, eta_outer)'s outputs at `keep` (those
    with a cotangent) at these inputs: every DIFF input's gradient (zeros
    where none reaches it), in DIFF's order."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_()
                  for x in _diff(desc, wo, eta_outer)]
        outs = fn(*_with_diff(desc, leaves))
        pairs = [(outs[k], g) for k, g in zip(keep, cots)
                 if g is not None and outs[k].requires_grad]
        got = (torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs], allow_unused=True)
               if pairs else (None,) * len(leaves))
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, got))


def sample_bwd_plain(desc, wo, u1, u2, use_prime, eta_outer, prev_flags,
                     g_f, g_alpha_i=None, g_eta_sampled=None):
    """X3's plain version in "sample" mode: the VJP of bxdf.bsdf_sample_f's
    (f, alpha_i, eta_sampled) at these inputs, a gradient for each DIFF
    input, in DIFF's order."""
    return _vjp_plain(
        lambda d, w, e: sample_plain(d, w, u1, u2, use_prime, e, prev_flags),
        desc, wo, eta_outer, (0, 4, 5), (g_f, g_alpha_i, g_eta_sampled))


def eval_bwd_plain(desc, wo, wi, use_prime, eta_outer, g_f):
    """X3's plain version in "eval" mode: the VJP of bxdf.bsdf_f."""
    return _vjp_plain(
        lambda d, w, e: eval_plain(d, w, wi, use_prime, e),
        desc, wo, eta_outer, (0,), (g_f,))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_lib():
    lib = cuda_build.load("bsdf")
    if lib.nart_bsdf_sample.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.nart_bsdf_sample, lib.nart_bsdf_sample_ref,
                   lib.nart_bsdf_eval, lib.nart_bsdf_sample_eval):
            fn.argtypes = [p, p, i64, p]
            fn.restype = ctypes.c_int
        for fn in (lib.nart_bsdf_f_bwd, lib.nart_bsdf_f_bwd_ref):
            fn.argtypes = [p, p, i64, i, p]
            fn.restype = ctypes.c_int
    return lib


def _check(n, **tensors):
    """Each named tensor (None allowed) on one CUDA device, contiguous, of
    its dtype and shape (n,) or (n, C)."""
    want = {"n_lobes": (torch.int64, ()), "lobe": (torch.int64, (2,)),
            "rho_d": (torch.float32, (3,)), "rho_s": (torch.float32, (3,)),
            "tau": (torch.float32, (3,)), "eta": (torch.float32, ()),
            "alpha0": (torch.float32, ()),
            "alpha_prime": (torch.float32, ()),
            "wo": (torch.float32, (3,)), "wi": (torch.float32, (3,)),
            "u1": (torch.float32, ()), "u2": (torch.float32, (2,)),
            "use_prime": (torch.bool, ()), "eta_outer": (torch.float32, ()),
            "prev_flags": (torch.int64, ()), "bits": (torch.int32, ()),
            "g_f": (torch.float32, (3,)), "g_alpha_i": (torch.float32, ()),
            "g_eta_sampled": (torch.float32, ()),
            "wi_b": (torch.float32, (3,))}
    device = None
    for name, x in tensors.items():
        if x is None:
            continue
        dtype, row = want[name]
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
        if device is None:
            device = x.device
        elif x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {x.dtype})")
        if tuple(x.shape) != (n, *row) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {(n, *row)} "
                             f"tensor (got {tuple(x.shape)})")


_IN = ("n_lobes", "lobe", "rho_d", "rho_s", "tau", "eta", "alpha0",
       "alpha_prime", "wo", "wi", "u1", "u2", "use_prime", "eta_outer",
       "prev_flags", "bits", "g_f", "g_alpha_i", "g_eta_sampled", "wi_b")


def _launch(entry, n, inputs, outs, *extra):
    """One launch of a bsdf.cu entry: inputs by name (the others null),
    outputs in the entry's order."""
    _check(n, **inputs)
    ptrs = (ctypes.c_void_p * len(_IN))(
        *[None if inputs.get(k) is None else inputs[k].data_ptr()
          for k in _IN])
    optrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(outs[0].device).cuda_stream
    rc = getattr(_kernel_lib(), entry)(ptrs, optrs, n, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _desc_inputs(desc, wo, use_prime, eta_outer):
    return dict(zip(bxdf.BsdfDesc._fields, desc), wo=wo,
                use_prime=use_prime, eta_outer=eta_outer)


def sample_cuda(desc, wo, u1, u2, use_prime, eta_outer, prev_flags):
    """Launch nart_bsdf_sample (X1): contiguous CUDA tensors of N lanes ->
    (f, wi, pdf, flags, alpha_i, eta_sampled, bits), the last X1's lobe bits
    (int32) for X3."""
    return _sample_launch("nart_bsdf_sample", "bsdf_sample", desc, wo, u1,
                          u2, use_prime, eta_outer, prev_flags)


def sample_ref_cuda(desc, wo, u1, u2, use_prime, eta_outer, prev_flags):
    """sample_cuda by X1's first design, nart_bsdf_sample_ref: the
    reference the redesign keeps the bits of (only the checks call it)."""
    return _sample_launch("nart_bsdf_sample_ref", "bsdf_sample_reference",
                          desc, wo, u1, u2, use_prime, eta_outer, prev_flags)


def sample_eval_cuda(desc, wo, u1, u2, use_prime, eta_outer, prev_flags,
                     wi_b):
    """Launch nart_bsdf_sample_eval (X2's redesign): sample_cuda's seven
    outputs, then bsdf_f and bsdf_pdf at wi_b (f_b (N, 3), pdf_b (N,))."""
    return _sample_launch("nart_bsdf_sample_eval", "bsdf_sample_eval", desc,
                          wo, u1, u2, use_prime, eta_outer, prev_flags, wi_b)


def _sample_launch(entry, count, desc, wo, u1, u2, use_prime, eta_outer,
                   prev_flags, wi_b=None):
    n = wo.shape[0]
    dev = wo.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
            torch.empty(n, **f32),
            torch.empty(n, dtype=torch.int64, device=dev),
            torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty(n, dtype=torch.int32, device=dev))
    if wi_b is not None:  # the eval outputs at wi_b
        outs += (torch.empty((n, 3), **f32), torch.empty(n, **f32))
    if n:
        _launch(entry, n,
                dict(_desc_inputs(desc, wo, use_prime, eta_outer), u1=u1,
                     u2=u2, prev_flags=prev_flags, wi_b=wi_b), outs)
        cuda_build.count_launch(count)
    return outs


def eval_cuda(desc, wo, wi, use_prime, eta_outer):
    """Launch nart_bsdf_eval (X2's first design): (f (N, 3), pdf (N,)),
    bsdf_f and bsdf_pdf of one (wo, wi)."""
    n = wo.shape[0]
    f32 = dict(dtype=torch.float32, device=wo.device)
    outs = (torch.empty((n, 3), **f32), torch.empty(n, **f32))
    if n:
        _launch("nart_bsdf_eval", n,
                dict(_desc_inputs(desc, wo, use_prime, eta_outer), wi=wi),
                outs)
        cuda_build.count_launch("bsdf_eval")
    return outs


def f_bwd_cuda(mode, desc, wo, wi, use_prime, eta_outer, g_f,
               g_alpha_i=None, g_eta_sampled=None, u2=None, prev_flags=None,
               bits=None):
    """Launch nart_bsdf_f_bwd (X3): mode "sample" (X1's outputs: wi and
    bits X1's, u2 and prev_flags its inputs) or "eval" (X2's f).  A None
    cotangent is zero.  Returns per-lane gradients of the DIFF inputs, in
    DIFF's order."""
    return _f_bwd_launch("nart_bsdf_f_bwd", "bsdf_f_bwd", mode, desc, wo,
                         wi, use_prime, eta_outer, g_f, g_alpha_i,
                         g_eta_sampled, u2, prev_flags, bits)


def f_bwd_ref_cuda(mode, desc, wo, wi, use_prime, eta_outer, g_f,
                   g_alpha_i=None, g_eta_sampled=None, u2=None,
                   prev_flags=None, bits=None):
    """f_bwd_cuda by X3's first design, nart_bsdf_f_bwd_ref: the reference
    the redesign is held beside (only the checks call it)."""
    return _f_bwd_launch("nart_bsdf_f_bwd_ref", "bsdf_f_bwd_reference",
                         mode, desc, wo, wi, use_prime, eta_outer, g_f,
                         g_alpha_i, g_eta_sampled, u2, prev_flags, bits)


def _f_bwd_launch(entry, count, mode, desc, wo, wi, use_prime, eta_outer,
                  g_f, g_alpha_i, g_eta_sampled, u2, prev_flags, bits):
    if mode not in ("sample", "eval"):
        raise ValueError(f"mode {mode!r}: 'sample' or 'eval'")
    sample = mode == "sample"
    if sample and (u2 is None or prev_flags is None or bits is None):
        raise ValueError("mode 'sample' takes X1's u2, prev_flags and bits")
    n = wo.shape[0]
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=x.device)
                 for x in _diff(desc, wo, eta_outer))
    if n:
        inputs = dict(_desc_inputs(desc, wo, use_prime, eta_outer), wi=wi,
                      g_f=g_f)
        if sample:
            inputs.update(u2=u2, prev_flags=prev_flags, bits=bits,
                          g_alpha_i=g_alpha_i, g_eta_sampled=g_eta_sampled)
        _launch(entry, n, inputs, outs, 0 if sample else 1)
        cuda_build.count_launch(count)
    return outs
