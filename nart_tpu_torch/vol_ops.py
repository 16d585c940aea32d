"""The volume's flight step, k of them in one call, differentiable: the
walk's state through k delta-tracking steps, as an autograd Function.

Counterpart of ``nart_tpu/integrators/volume.py``'s ``_make_vol_step``
step (:59-163, ``_ratio`` :53-57), which reaches no Pallas kernel: on the
TPU XLA fuses it, and the ``NART_VOL_FUSE`` steps of a round (:343,
:484), into a few fusions.  The plain version here, ``step_plain`` (k of
them: ``flight_steps_plain``), runs it op by op, ~318 aten operations a
step.  On CUDA tensors ``flight_steps`` goes through ``_VolSteps``, whose
forward is one launch of csrc/vol_step.cu's ``nart_vol_steps`` (V1: a
thread a lane, its state in registers through the k steps, the plain
version's bits; the segment starts added into the caller's int64
accumulator, so that a call is one graph node) and whose backward is one
launch of ``nart_vol_steps_bwd`` (V2: the k steps recomputed from the
saved incoming state, then reversed: per lane the cotangents of the
incoming beta and l_out, a row of the 8 cell corners' cotangents a step
at that step's cell, and partials of sigma_a, sigma_s and le), then
``reduce_rows``: one large-table backward (``select.lut_gather_bwd``, S2
on the card) for the k * N rows and torch sums of the partials.  Only
beta and l_out carry a gradient through a step (o, d and t do not: a
direction or a distance that required grad is refused on the card).
Launches count in ``cuda_build.launch_counts`` as "vol_steps" and
"vol_steps_bwd" (inside a CUDA graph capture, at every replay).  V1's and
V2's first designs stay as ``steps_ref_cuda`` / ``steps_bwd_ref_cuda``
(``nart_vol_steps_ref``, ``nart_vol_steps_bwd_ref``, counted as
"vol_steps_reference" and "vol_steps_bwd_reference"), the bits the
redesign is held to; no path launches them.  ``host_walk`` runs the same
source's lane functions, either design's, as host C++ on CPU tensors (the
CPU tests' hold on the redesign).

On CPU tensors ``flight_steps`` is ``flight_steps_plain`` and autograd
differentiates it as any torch code, so CPU films, losses and gradients
are the plain step's.  The Function is the CUDA route only: there is no
fallback between the two, a CUDA tensor launches the kernels or raises.
``flight_steps_vjp_plain`` is V2's algorithm in torch (its CPU twin) and
``flight_steps_vjp_reference`` the VJP that autograd takes of the plain
steps, per lane: the tests and chip_smoke.py hold V2 to it in float64.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import cuda_build, rng
from .media import (_unit, cell_coords, cell_weights, clip_to_aabb,
                    medium_properties_cells)
from .sampling import sample_exponential_decay, uniform_sample_sphere
from .select import lut_gather_bwd

_SEGMENT_EPS = float(np.float32(1e-4))
# the most steps one V2 launch reverses: its per-step records live in
# registers, one kernel instantiation a step count
MAX_STEPS = 8


@dataclass
class VolState:
    """Wavefront state of the walk, carried from step to step."""

    alive: torch.Tensor  # (N,) bool
    new_ray: torch.Tensor  # (N,) bool: the next step starts a segment
    bounce: torch.Tensor  # (N,) int64 scatter events so far
    u_mode: torch.Tensor  # (N,) event-choice uniform
    t_cur: torch.Tensor  # (N,) distance reached along the segment
    t_exit: torch.Tensor  # (N,) where the segment leaves the medium's box
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    state: torch.Tensor  # (N,) int64 RNG state
    beta: torch.Tensor  # (N, 3) throughput (event ratios, value 1)
    l_out: torch.Tensor  # (N, 3) radiance


FIELDS = tuple(VolState.__dataclass_fields__)
# the carried floats that depend on a parameter: the Function's
# differentiable outputs
_BETA, _L_OUT = FIELDS.index("beta"), FIELDS.index("l_out")


def _ratio(p, mask):
    """p / detach(p) where mask, else 1: a unit-valued gradient carrier."""
    safe = torch.where(mask & (p > 0.0), p, 1.0)
    return safe / safe.detach()


def step_plain(vs, cells, medium, sigma_maj, bounces, gather=None,
               rec=None):
    """One delta-tracking flight step, op by op: (vs', died, esc).  `died`
    marks lanes whose walk ended this step (absorbed, out of scatter
    events, or escaped), `esc` those that left the medium (their light
    pass is the caller's).  sigma_maj: the majorant as a () tensor on the
    medium's device (CUDA divides by a host scalar as a product with its
    reciprocal, which is not the same bits); bounces: the scatter limit.
    gather: as for media.density_lookup_cells; rec, a dict, receives the
    step's point and events (flight_steps_vjp_plain's records)."""
    # ---- a new segment: SampleT_maj's entry (media.h:128-140)
    setup = vs.alive & vs.new_ray
    _, st = rng.masked_next_float(vs.state, setup)  # u: drawn, unused
    um_new, st = rng.masked_next_float(st, setup)
    u_mode = torch.where(setup, um_new, vs.u_mode)
    box_hit, t0, t1 = clip_to_aabb(vs.o, vs.d, medium.bounds_min,
                                   medium.bounds_max)
    t_cur = torch.where(setup, torch.clamp(t0, min=0.0), vs.t_cur)
    t_exit = torch.where(setup, t1, vs.t_exit)
    # the segment misses the box or ends at once: escape
    esc_now = setup & (~box_hit | (t_cur + _SEGMENT_EPS > t_exit))
    new_ray = vs.new_ray & ~setup

    # ---- the flight step (media.h:147-178)
    flying = vs.alive & ~esc_now
    u_t, st = rng.masked_next_float(st, flying)
    t = t_cur + sample_exponential_decay(u_t, sigma_maj)
    left_segment = flying & (t >= t_exit)
    p = vs.o + vs.d * t[:, None]
    inside, s_a, s_s, le_med = medium_properties_cells(medium, cells, p,
                                                       gather)
    in_medium = flying & ~left_segment
    left_medium = in_medium & ~inside  # SampleMedium returned false

    sampling_lane = in_medium & inside
    p_absorb = s_a / sigma_maj
    p_scatter = s_s / sigma_maj
    pa_det, ps_det = p_absorb.detach(), p_scatter.detach()
    absorb = sampling_lane & (u_mode < pa_det)
    scatter = sampling_lane & ~absorb & (u_mode < pa_det + ps_det)
    null = sampling_lane & ~absorb & ~scatter
    if rec is not None:
        rec.update(p=p, absorb=absorb, scatter=scatter, null=null,
                   p_absorb=pa_det, p_scatter=ps_det)

    # event-probability ratios (value 1): the gradients' carriers
    beta = vs.beta * _ratio(p_absorb, absorb)[:, None]
    beta = beta * _ratio(p_scatter, scatter)[:, None]
    beta = beta * _ratio(1.0 - p_absorb - p_scatter, null)[:, None]

    # absorb: L += Le * beta, the walk ends (volumeintegrator.cpp:30-35)
    l_out = vs.l_out + torch.where(absorb[:, None], le_med * beta, 0.0)

    # scatter: past the bounce limit the walk ends, else a new segment
    over = scatter & (vs.bounce > bounces)
    bounce = vs.bounce + scatter.to(vs.bounce.dtype)
    redirect = scatter & ~over
    s1, st = rng.masked_next_float(st, redirect)
    s2, st = rng.masked_next_float(st, redirect)
    w_new, _ = uniform_sample_sphere(torch.stack([s1, s2], -1))
    o = torch.where(redirect[:, None], p, vs.o)
    d = torch.where(redirect[:, None], w_new, vs.d)
    new_ray = new_ray | redirect

    # null: redraw uMode, fly on from t
    um2, st = rng.masked_next_float(st, null)
    u_mode = torch.where(null, um2, u_mode)
    t_cur = torch.where(null, t, t_cur)

    # escape: left the segment or the medium, or missed the box
    # (volumeintegrator.cpp:66-80)
    esc = esc_now | left_segment | left_medium
    ended = absorb | over | esc
    out = VolState(
        alive=vs.alive & ~ended, new_ray=new_ray, bounce=bounce,
        u_mode=u_mode, t_cur=t_cur, t_exit=t_exit, o=o, d=d, state=st,
        beta=beta, l_out=l_out)
    return out, vs.alive & ended, esc


def flight_steps_plain(vs, k, cells, medium, sigma_maj, bounces, seg=None,
                       gather=None, recs=None):
    """V1's plain version: k calls of step_plain.  Returns (vs', died, esc,
    segment starts): died and esc OR-ed over the steps, the segment starts
    (the lanes alive at a step that starts a segment) summed into seg (a
    () int64 accumulator, added to in place and returned) or, where seg is
    None, a new () int64 tensor.  gather: step_plain's; recs, a list,
    receives each step's record."""
    died = torch.zeros_like(vs.alive)
    esc = torch.zeros_like(vs.alive)
    count = torch.zeros((), dtype=torch.int64, device=vs.alive.device)
    for _ in range(k):
        count = count + (vs.alive & vs.new_ray).sum()
        rec = None if recs is None else {}
        vs, died_k, esc_k = step_plain(vs, cells, medium, sigma_maj, bounces,
                                       gather, rec)
        if recs is not None:
            recs.append(rec)
        died = died | died_k
        esc = esc | esc_k
    if seg is None:
        return vs, died, esc, count
    return vs, died, esc, seg.add_(count)


def flight_steps(vs, k, cells, medium, sigma_maj, bounces, seg=None):
    """k flight steps of the walk: flight_steps_plain's (vs', died, esc,
    segment starts), the starts added into seg where it is given (the
    machines pass their ray count: on the card V1 adds into it, one graph
    node a call) or else counted into a new () int64 tensor.  CUDA tensors
    go through _VolSteps (V1 forward, V2 backward), CPU tensors through
    the plain version."""
    if not vs.o.is_cuda:
        return flight_steps_plain(vs, k, cells, medium, sigma_maj, bounces,
                                  seg)
    if torch.is_grad_enabled():
        for name, x in (("o", vs.o), ("d", vs.d), ("t_cur", vs.t_cur),
                        ("t_exit", vs.t_exit), ("u_mode", vs.u_mode),
                        ("bounds_min", medium.bounds_min),
                        ("bounds_max", medium.bounds_max)):
            if x.requires_grad:
                raise ValueError(f"flight_steps: {name} requires grad; only "
                                 "beta, l_out, the cells, sigma_a, sigma_s "
                                 "and le carry a gradient through a step")
    if seg is None:
        seg = torch.zeros((), dtype=torch.int64, device=vs.o.device)
    outs = _VolSteps.apply(k, bounces, tuple(medium.density.shape), (seg,),
                           *[getattr(vs, f) for f in FIELDS], cells,
                           medium.sigma_a, medium.sigma_s, medium.le,
                           medium.bounds_min, medium.bounds_max, sigma_maj)
    return (VolState(*outs[:len(FIELDS)]), *outs[len(FIELDS):], seg)


class _VolSteps(torch.autograd.Function):
    """k flight steps on the card: V1 forward, V2 backward.  acc, a 1-tuple
    (no input of the graph), holds the () int64 accumulator V1 adds the
    segment starts into."""

    @staticmethod
    def forward(ctx, k, bounces, shape, acc, *args):
        ctx.set_materialize_grads(False)
        args = [x.contiguous() for x in args]
        outs = steps_cuda(k, bounces, shape, *args, seg=acc[0])[:-1]
        ctx.save_for_backward(*args)
        ctx.k, ctx.bounces, ctx.shape = k, bounces, shape
        ctx.mark_non_differentiable(*[o for j, o in enumerate(outs)
                                      if j not in (_BETA, _L_OUT)])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g_beta, g_l = grads[_BETA], grads[_L_OUT]
        args = ctx.saved_tensors
        nf = len(FIELDS)
        lead = 4  # k, bounces, shape, acc: no gradient
        out = [None] * (lead + len(args))
        if g_beta is None and g_l is None:
            return tuple(out)
        cells, sigma_a, sigma_s, le = args[nf:nf + 4]
        g_beta = (torch.zeros_like(args[_BETA]) if g_beta is None
                  else g_beta.contiguous())
        g_l = (torch.zeros_like(args[_L_OUT]) if g_l is None
               else g_l.contiguous())
        g_b, g_lo, rows, idx, p_sa, p_ss, p_le = steps_bwd_cuda(
            ctx.k, ctx.bounces, ctx.shape, *args, g_beta, g_l)
        out[lead + _BETA], out[lead + _L_OUT] = g_b, g_lo
        out[lead + nf:lead + nf + 4] = reduce_rows(
            rows, idx, p_sa, p_ss, p_le, cells.shape[0], sigma_a, sigma_s,
            le, ctx.needs_input_grad[lead + nf:lead + nf + 4])
        return tuple(out)


def reduce_rows(rows, idx, p_sa, p_ss, p_le, n_cells, sigma_a, sigma_s, le,
                needs=(True,) * 4):
    """The gradients of (cells, sigma_a, sigma_s, le) from V2's per-lane
    outputs: the k * N cell rows (rows (k, N, 8) at idx (k, N)) through one
    large-table backward, the partials (N,), (N,), (N, 3) by torch sums, in
    that order; None where needs is False."""
    out = [None] * 4
    if needs[0]:
        out[0] = lut_gather_bwd(rows.reshape(-1, 8), idx.reshape(-1),
                                n_cells)
    for j, (p, leaf) in enumerate(((p_sa, sigma_a), (p_ss, sigma_s),
                                   (p_le, le)), 1):
        if needs[j]:
            out[j] = p.sum(0).reshape(leaf.shape)
    return out


# ---------------------------------------------------------------------------
# Plain versions of the backward (the CPU's twin of V2, and the reference)
# ---------------------------------------------------------------------------


def flight_steps_vjp_plain(vs, k, cells, medium, sigma_maj, bounces, g_beta,
                           g_l):
    """V2's algorithm in torch: the k steps recomputed from vs (no graph,
    the forward's own dtype and branches), then reversed with the chain
    rule written out, as nart_vol_steps_bwd does a lane at a time.  The
    reverse pass runs in float64 from the density on: the step's row read
    again, the density, the event probabilities (p_null = 1 - p_absorb -
    p_scatter cancels where the density nears the majorant, and 1 / p_null
    carries the null event's gradient) and every product after them, cast
    to beta's dtype at the end.  g_beta, g_l: the cotangents of beta and
    l_out after the k steps.  Returns (g_beta_in (N, 3), g_l_in (N, 3),
    rows (k, N, 8), idx (k, N) int64, and the partials of sigma_a (N,),
    sigma_s (N,) and le (N, 3)); rows are g_dens times the corner weights
    at the step's cell (idx, clamped as the look-up clamps it), zero where
    the lane sampled nothing."""
    f64 = torch.float64
    shape = tuple(medium.density.shape)
    n_cells = cells.shape[0]
    recs = []
    with torch.no_grad():
        for _ in range(k):
            rec = {"beta": vs.beta}
            vs, _, _ = step_plain(vs, cells, medium, sigma_maj, bounces,
                                  rec=rec)
            recs.append(rec)
        cells64, maj = cells.to(f64), sigma_maj.to(f64)
        sig_a, sig_s = medium.sigma_a.to(f64), medium.sigma_s.to(f64)
        le = medium.le.to(f64)
        gb, gl = g_beta.to(f64), g_l.to(f64)
        p_sa = torch.zeros_like(gb[:, 0])
        p_ss = torch.zeros_like(p_sa)
        p_le = torch.zeros_like(gb)
        rows, idxs = [None] * k, [None] * k
        for s in reversed(range(k)):
            r = recs[s]
            _, p_unit = _unit(medium, r["p"])
            idx, f = cell_coords(shape, p_unit)
            idxs[s] = idx = idx.clamp(0, n_cells - 1)
            w = cell_weights(f)
            row = cells64[idx]
            dens = None  # density_lookup_cells' sum, of float64 products
            for j in range(8):
                term = row[:, j] * w[j]
                dens = term if dens is None else dens + term
            pa = (sig_a * dens) / maj
            ps = (sig_s * dens) / maj
            pn = 1.0 - pa - ps
            sampled = r["absorb"] | r["scatter"] | r["null"]
            ma = r["absorb"] & (pa > 0.0)
            ms = r["scatter"] & (ps > 0.0)
            mn = r["null"] & (pn > 0.0)
            safe_a = torch.where(ma, pa, 1.0)
            safe_s = torch.where(ms, ps, 1.0)
            safe_n = torch.where(mn, pn, 1.0)
            b0 = r["beta"].to(f64)
            b1 = b0 * (safe_a / safe_a)[:, None]
            b2 = b1 * (safe_s / safe_s)[:, None]
            b3 = b2 * (safe_n / safe_n)[:, None]
            ab = r["absorb"][:, None]
            # l' = l + [absorb] le * dens * beta'
            g_lemed = torch.where(ab, gl * b3, 0.0)
            gb = gb + torch.where(ab, gl * (le * dens[:, None]), 0.0)
            p_le = p_le + torch.where(ab, g_lemed * dens[:, None], 0.0)
            g_dens = (g_lemed * le).sum(-1)
            # beta' = ((beta * r_a) * r_s) * r_n
            g_rn = (gb * b2).sum(-1)
            gb = gb * (safe_n / safe_n)[:, None]
            g_rs = (gb * b1).sum(-1)
            gb = gb * (safe_s / safe_s)[:, None]
            g_ra = (gb * b0).sum(-1)
            gb = gb * (safe_a / safe_a)[:, None]
            # r = safe / detach(safe); p_null = 1 - p_absorb - p_scatter
            g_pn = torch.where(mn, g_rn / safe_n, 0.0)
            g_pa = torch.where(ma, g_ra / safe_a, 0.0) - g_pn
            g_ps = torch.where(ms, g_rs / safe_s, 0.0) - g_pn
            # p_absorb = sigma_a * dens / maj, p_scatter likewise
            g_sa, g_ss = g_pa / maj, g_ps / maj
            p_sa = p_sa + torch.where(sampled, g_sa * dens, 0.0)
            p_ss = p_ss + torch.where(sampled, g_ss * dens, 0.0)
            g_dens = g_dens + g_sa * sig_a + g_ss * sig_s
            rows[s] = torch.stack([torch.where(sampled, g_dens * wj, 0.0)
                                   for wj in w], -1)
    dt = vs.beta.dtype
    return (gb.to(dt), gl.to(dt), torch.stack(rows).to(dt), torch.stack(idxs),
            p_sa.to(dt), p_ss.to(dt), p_le.to(dt))


def flight_steps_vjp_reference(vs, k, cells, medium, sigma_maj, bounces,
                               g_beta, g_l, dtype=torch.float64):
    """The VJP that autograd takes of flight_steps_plain, lane by lane, in
    flight_steps_vjp_plain's layout, and a (N,) bool: the lanes whose
    forward in `dtype` chose the float32 forward's events in every step.
    beta, l_out, the cells, sigma_a, sigma_s and le are taken in `dtype`
    (sigma_a, sigma_s and le expanded to a value a lane, so that autograd
    gives per-lane partials; the cells read by plain indexing, whose
    per-step rows autograd differentiates); the walk's geometry (o, d, t,
    the draws) stays float32 as the plain version computes it, so only an
    event choice within the probabilities' rounding of u_mode can differ
    (on such a lane the VJP is of another branch)."""
    n = vs.beta.shape[0]
    events = ("absorb", "scatter", "null")
    recs32, recs = [], []
    with torch.no_grad():
        flight_steps_plain(vs, k, cells, medium, sigma_maj, bounces,
                           recs=recs32)
    with torch.enable_grad():
        beta = vs.beta.detach().to(dtype).requires_grad_()
        l_out = vs.l_out.detach().to(dtype).requires_grad_()
        cells_x = cells.detach().to(dtype).requires_grad_()
        lane = [x.detach().to(dtype).expand(n, *x.shape).clone()
                .requires_grad_()
                for x in (medium.sigma_a, medium.sigma_s, medium.le)]
        med = replace(medium, sigma_a=lane[0], sigma_s=lane[1], le=lane[2])
        taps = []

        def gather(idx, table):
            row = table[idx]
            taps.append((idx, row))
            return row

        out, _, _, _ = flight_steps_plain(
            replace(vs, beta=beta, l_out=l_out), k, cells_x, med, sigma_maj,
            bounces, gather=gather, recs=recs)
        leaves = [beta, l_out, *lane] + [row for _, row in taps]
        got = torch.autograd.grad(
            [out.beta, out.l_out], leaves,
            [g_beta.to(dtype), g_l.to(dtype)], allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, got)]
    agree = torch.ones(n, dtype=torch.bool, device=beta.device)
    for a, b in zip(recs32, recs):
        for e in events:
            agree &= a[e] == b[e]
    return (got[0], got[1], torch.stack(got[5:]),
            torch.stack([i for i, _ in taps]), got[2], got[3], got[4], agree)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

# (dtype, trailing shape) of the launchers' inputs, in their order (n lanes
# for the state, the cotangents; the medium's own shapes after "cells")
_STATE = {"alive": (torch.bool, ()), "new_ray": (torch.bool, ()),
          "bounce": (torch.int64, ()), "u_mode": (torch.float32, ()),
          "t_cur": (torch.float32, ()), "t_exit": (torch.float32, ()),
          "o": (torch.float32, (3,)), "d": (torch.float32, (3,)),
          "state": (torch.int64, ()), "beta": (torch.float32, (3,)),
          "l_out": (torch.float32, (3,))}
_MEDIUM = {"sigma_a": (), "sigma_s": (), "le": (3,), "bounds_min": (3,),
           "bounds_max": (3,), "sigma_maj": ()}


_ENTRIES = ("nart_vol_steps", "nart_vol_steps_bwd", "nart_vol_steps_ref",
            "nart_vol_steps_bwd_ref")
# the redesign's cell index is 32 bits: the table's floats must fit
_MAX_CELL_FLOATS = 2 ** 31 - 1


def _kernel_lib():
    lib = cuda_build.load("vol_step")
    if lib.nart_vol_steps.argtypes is None:
        p, i64, i, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_uint32)
        for name in _ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = [p, p, i64, i, i, i, i, i64, i64, p]
            fn.restype = ctypes.c_int
        lib.nart_vol_node_floor.argtypes = [i64, p]
        lib.nart_vol_node_floor.restype = ctypes.c_int
        lib.nart_vol_trig_check.argtypes = [u32, u32, p, p]
        lib.nart_vol_trig_check.restype = ctypes.c_int
    return lib
def _check(shape, named):
    """Each named tensor on one CUDA device, contiguous, float32 (the state
    fields their own dtypes), of its shape."""
    device = None
    for name, x, dtype, want in named:
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
        if device is None:
            device = x.device
        elif x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {x.dtype})")
        if tuple(x.shape) != tuple(want) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(want)} "
                             f"tensor (got {tuple(x.shape)})")
    if len(shape) != 3 or min(shape) < 2:
        raise ValueError(f"density grid {shape}: (Z, Y, X), each at least 2")


def _checked(entry, k, shape, args):
    """(n, n_cells) of a launch's arguments, each checked (_check); the
    redesign's (every entry but the first designs') also its cell table
    32-byte aligned (two 16-byte loads a row) and within a 32-bit index."""
    n = args[0].shape[0]
    if not 1 <= k <= MAX_STEPS:
        raise ValueError(f"{entry}: k = {k} steps (one launch takes 1 to "
                         f"{MAX_STEPS})")
    rz, ry, rx = shape
    n_cells = (rz - 1) * (ry - 1) * (rx - 1)
    names = list(_STATE) + ["cells"] + list(_MEDIUM) + ["g_beta", "g_l"]
    want = ([(n, *_STATE[f][1]) for f in _STATE] + [(n_cells, 8)]
            + list(_MEDIUM.values()) + [(n, 3), (n, 3)])
    dtypes = [_STATE[f][0] for f in _STATE] + [torch.float32] * 9
    _check(shape, list(zip(names, args, dtypes, want)))
    if not entry.endswith("_ref"):
        cells = args[len(_STATE)]
        if 8 * n_cells > _MAX_CELL_FLOATS:
            raise ValueError(f"{entry}: {n_cells} cells of 8 floats (the "
                             "cell index is 32 bits: at most "
                             f"{_MAX_CELL_FLOATS} floats)")
        if cells.data_ptr() % 32:
            raise ValueError(f"{entry}: the cell table must be 32-byte "
                             "aligned (two 16-byte loads a row)")
    return n, n_cells


def _launch(entry, k, bounces, shape, args, outs):
    n, n_cells = _checked(entry, k, shape, args)
    rz, ry, rx = shape
    ptrs = (ctypes.c_void_p * len(args))(*[x.data_ptr() for x in args])
    optrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    rc = getattr(_kernel_lib(), entry)(ptrs, optrs, n, k, rx, ry, rz,
                                       n_cells, int(bounces), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _v1_outs(args, seg):
    """V1's outputs for its arguments: the state's fields, died, esc, and
    the segment starts' accumulator (seg, or a new zeroed () int64)."""
    x = args[0]
    if seg is None:
        seg = torch.zeros((), dtype=torch.int64, device=x.device)
    return tuple(torch.empty_like(a) for a in args[:len(FIELDS)]) + (
        torch.empty_like(x), torch.empty_like(x), seg)


def _v2_outs(n, k, device):
    """V2's seven outputs for n lanes and k steps."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
            torch.empty((k, n, 8), **f32),
            torch.empty((k, n), dtype=torch.int64, device=device),
            torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty((n, 3), **f32))


def _steps(entry, count, k, bounces, shape, args, seg):
    x = args[0]
    if seg is not None and not (seg.dtype == torch.int64 and seg.dim() == 0
                                and seg.device == x.device):
        raise ValueError(f"{entry}: seg must be a () int64 tensor on "
                         f"{x.device} (got {seg.dtype} {tuple(seg.shape)} on "
                         f"{seg.device})")
    outs = _v1_outs(args, seg)
    if x.shape[0]:
        _launch(entry, k, bounces, shape, args, outs)
        cuda_build.count_launch(count)
    return outs


def steps_cuda(k, bounces, shape, *args, seg=None):
    """Launch nart_vol_steps (V1): the state's 11 fields (VolState's
    order), the cells (n_cells, 8, 32-byte aligned) and the medium's
    sigma_a, sigma_s, le, bounds_min, bounds_max and sigma_maj, contiguous
    CUDA tensors of N lanes -> the state's 11 fields after k steps, died,
    esc (N,) bool and the segment starts: seg (a () int64 accumulator on
    the lanes' device) with them added, or a new () int64 count where seg
    is None."""
    return _steps("nart_vol_steps", "vol_steps", k, bounces, shape, args,
                  seg)


def steps_ref_cuda(k, bounces, shape, *args):
    """V1's first design (nart_vol_steps_ref), the reference: steps_cuda's
    outputs, the segment starts a new () int64 count."""
    return _steps("nart_vol_steps_ref", "vol_steps_reference", k, bounces,
                  shape, args, None)


def _steps_bwd(entry, count, k, bounces, shape, args):
    n = args[0].shape[0]
    outs = _v2_outs(n, k, args[0].device)
    if n:
        _launch(entry, k, bounces, shape, args, outs)
        cuda_build.count_launch(count)
    return outs


def steps_bwd_cuda(k, bounces, shape, *args):
    """Launch nart_vol_steps_bwd (V2): steps_cuda's inputs (the state
    before the k steps), then the cotangents of beta and l_out after them
    (N, 3) -> flight_steps_vjp_plain's seven outputs."""
    return _steps_bwd("nart_vol_steps_bwd", "vol_steps_bwd", k, bounces,
                      shape, args)


def steps_bwd_ref_cuda(k, bounces, shape, *args):
    """V2's first design (nart_vol_steps_bwd_ref), the reference:
    steps_bwd_cuda's arguments and outputs."""
    return _steps_bwd("nart_vol_steps_bwd_ref", "vol_steps_bwd_reference",
                      k, bounces, shape, args)


def node_floor_cuda(n, device):
    """One launch of an empty kernel on V1's grid for n lanes (a graph
    node's own cost, for a measurement; no path launches it, not
    counted)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel_lib().nart_vol_node_floor(n, stream)
    if rc != 0:
        raise RuntimeError(f"nart_vol_node_floor launch failed: CUDA error "
                           f"{rc}")


def trig_check_cuda(lo, hi, device):
    """The redesign's sine and cosine (csrc/vol_step.cu's sincos_small)
    against the card's sinf and cosf on every float whose bits lie in
    [lo, hi]: a () int64 tensor, the count of values that differ (a
    measurement; not counted)."""
    bad = torch.zeros((), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel_lib().nart_vol_trig_check(lo, hi, bad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nart_vol_trig_check launch failed: CUDA error "
                           f"{rc}")
    return bad


def host_walk(design, k, bounces, shape, *args):
    """csrc/vol_step.cu's lane functions built as host C++ (g++, no
    contraction: cuda_build.load_host_cu) on CPU tensors: design 0 the first
    design's (V1's and V2's references), 1 the redesign's.  args:
    steps_bwd_cuda's, contiguous CPU tensors.  Returns V1's outputs
    (steps_cuda's, the segment starts a new () int64) and V2's seven
    (steps_bwd_cuda's) from the same incoming state."""
    n = args[0].shape[0]
    if not 1 <= k <= MAX_STEPS:
        raise ValueError(f"host_walk: k = {k} steps (1 to {MAX_STEPS})")
    rz, ry, rx = shape
    n_cells = (rz - 1) * (ry - 1) * (rx - 1)
    for x in args:
        if x.is_cuda or not x.is_contiguous():
            raise ValueError("host_walk takes contiguous CPU tensors")
    v1, v2 = _v1_outs(args, None), _v2_outs(n, k, args[0].device)
    lib = cuda_build.load_host_cu("vol_step")
    fn = lib.nart_vol_host_walk
    if fn.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [i, p, p, i64, i, i, i, i, i64, i64]
        fn.restype = ctypes.c_int
    outs = v1 + v2
    ptrs = (ctypes.c_void_p * len(args))(*[x.data_ptr() for x in args])
    optrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    rc = fn(design, ptrs, optrs, n, k, rx, ry, rz, n_cells, int(bounces))
    if rc != 0:
        raise RuntimeError(f"nart_vol_host_walk failed: {rc}")
    return v1, v2
