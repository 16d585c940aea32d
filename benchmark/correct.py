"""The comparison that decides a run's ``correct``: the program's answers
against the plain reference's (reference/ref.py), on the host, in
float64.

Render cells compare the kept image:
  film_rel_l1  sum |image - ref| / sum |ref| over the RGB of every pixel.
Train cells compare each kept step (the traffic's set_up_units, then the
window's last step):
  loss_rel     |loss - ref| / |ref|, the worst step;
  grad_gap     the worst leaf of the worst step: | |g| - |g_ref| | (norms
               of the leaf's gradient) over the larger of |g_ref| and the
               median of the reference's nonzero leaf norms; 0 where both
               norms are 0.
LIMITS holds each number's limit, set from the readings that PERF.md
gives (the program's sound runs below it, the lower-precision control
above it).  A number that is not finite fails.
"""

import math
import statistics

LIMITS = {
    "film_rel_l1": 2e-4,
    "loss_rel": 7e-4,
    "grad_gap": 0.2,
}


def film_rel_l1(img, ref):
    a, b = img[..., :3].double(), ref[..., :3].double()
    return float((a - b).abs().sum() / b.abs().sum())


def loss_rel(loss, ref):
    return abs(loss - ref) / abs(ref)


def leaf_gaps(g, g_ref):
    """{leaf path: the gap of its gradient's norm} (grad_gap's terms)."""
    norms = {p: float(x.double().norm()) for p, x in g_ref.items()}
    nonzero = [v for v in norms.values() if v > 0.0]
    median = statistics.median(nonzero) if nonzero else 0.0
    gaps = {}
    for p, ref_norm in norms.items():
        norm = float(g[p].double().norm())
        gaps[p] = (0.0 if norm == ref_norm
                   else abs(norm - ref_norm) / max(ref_norm, median))
    return gaps


def grad_gap(g, g_ref):
    return max(leaf_gaps(g, g_ref).values(), default=0.0)


def numbers(mode, answers, ref_answers):
    """{name: value} of the numbers compared."""
    if mode == "render":
        return {"film_rel_l1": film_rel_l1(answers[0], ref_answers[0])}
    out = {"loss_rel": 0.0, "grad_gap": 0.0}
    for (_, loss, g), (ref_loss, g_ref) in zip(answers, ref_answers,
                                               strict=True):
        out["loss_rel"] = max(out["loss_rel"], loss_rel(loss, ref_loss))
        out["grad_gap"] = max(out["grad_gap"], grad_gap(g, g_ref))
    return out


def verdict(nums, limits=LIMITS):
    """(correct, {name: {"value", "limit"}}): correct where every number
    is finite and under its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in nums.items())
    return ok, checks


def reference_answers(cell, seed, answers, device, size=None,
                      carry_dtype=None):
    """The reference's answers to the same units as `answers`."""
    from . import assets, cells
    from .reference import ref

    factors = cells.draws(cell, seed).factors
    scene_file = assets.scene_file(cell.config)
    if cell.traffic["mode"] == "render":
        return [ref.render_image(cell.config, cell.traffic, factors,
                                 scene_file, device, size, carry_dtype)]
    return ref.train_steps(cell.config, cell.traffic, factors, scene_file,
                           [base for base, _, _ in answers], device, size,
                           carry_dtype)
