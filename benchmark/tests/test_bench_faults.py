"""Runs on the CPU at a small size, through everything a run does but
the look for a card: the harness, the program, the reference and the
comparison.  A sound run is correct; a run whose timed path is broken
underneath, and the lower-precision control, are not.

At small sizes the program's kept replay machine cuts chunks that need
more rounds than the capacity the first chunk set (PERF.md, Open
questions): test_the_kept_machines_cut_shows holds, at 16x9 where it
shows on SEED, that the comparison catches it and that the program's own
per-round route, which has no capacity, agrees with the reference on the
chunk cut.  The other train tests take that
route (_per_round), so that they test the harness and its faults, not
that defect again.

The faults a cell can have: an answer altered where it is produced;
half of the batch left out, the mean taken over the rest; for a train
step, a step that returns nothing new (its gradients all zero).  The
cells run on one chip, so no exchange between chips can be left out; a
render unit carries no state from one image to the next."""

import pytest
import torch

from benchmark import correct, spec
from benchmark.reference import control
from benchmark.run import run_cell

SIZE = (32, 18)
CUT_SIZE = (16, 9)
SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


def _cell(name):
    return spec.Cell(spec.load_benchmark(), name)


def _run(name):
    return run_cell(_cell(name), SEED, 0.01, 0, CPU, size=SIZE)


@pytest.fixture
def _per_round(monkeypatch):
    """The train entry on the program's per-round route."""
    from nart_tpu_torch import grad

    orig = grad.radiance_weighted_loss_and_grad

    def step(*args, **kw):
        kw.pop("machines", None)
        return orig(*args, per_round=True, **kw)
    monkeypatch.setattr(grad, "radiance_weighted_loss_and_grad", step)


@pytest.mark.parametrize("name", ["macbeth.render", "macbeth.train"])
def test_a_sound_run_is_correct(name, _per_round):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in _cell(name).end_to_end}
    assert set(res["metrics"]) == names


def _half_splat(orig):
    def splat(film, jitter, l_alpha, *args):
        half = max(jitter.shape[0] // 2, 1)
        return orig(film, jitter[:half], l_alpha[:half], *args)
    return splat


def _scaled_image(orig):
    def finalize(*args):
        return orig(*args) * 1.01
    return finalize


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_a_broken_render_is_not_correct(fault, monkeypatch):
    from nart_tpu_torch import film

    if fault == "half_batch":
        monkeypatch.setattr(film, "splat_grid", _half_splat(film.splat_grid))
    else:
        monkeypatch.setattr(film, "finalize", _scaled_image(film.finalize))
    res = _run("macbeth.render")
    assert not res["correct"], res["checks"]


def _broken_step(orig, fault):
    from nart_tpu_torch import grad

    def step(scene, theta, accel, samples, cot, *args, **kw):
        if fault == "half_batch":
            n = cot.shape[1]
            cot = cot.clone()
            cot[:, n // 2:] = 0.0
            cot[:, : n // 2] *= 2.0
        loss, g, rays, rounds = orig(scene, theta, accel, samples, cot,
                                     *args, **kw)
        if fault == "no_update":
            g = grad.unflatten_like(torch.zeros_like(grad.flatten_leaves(g)),
                                    g)
        elif fault == "altered_answer":  # the loss and gradients by 10%
            loss = loss * 1.1
            g = grad.unflatten_like(grad.flatten_leaves(g) * 1.1, g)
        return loss, g, rays, rounds
    return step


@pytest.mark.parametrize("fault", ["no_update", "half_batch",
                                   "altered_answer"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch, _per_round):
    from nart_tpu_torch import grad

    monkeypatch.setattr(grad, "radiance_weighted_loss_and_grad",
                        _broken_step(grad.radiance_weighted_loss_and_grad,
                                     fault))
    res = _run("macbeth.train")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["macbeth.render", "macbeth.train"])
def test_the_control_is_not_correct(name):
    nums = control.control_numbers(_cell(name), SEED, CPU, size=SIZE)
    ok, checks = correct.verdict(nums)
    assert not ok, checks


def test_the_kept_machines_cut_shows():
    """The kept machine (the window's route) on SEED: a chunk whose walks
    need more rounds than its capacity is cut, the run is not correct,
    and the program's per-round route agrees with the reference there."""
    from benchmark import cells
    from nart_tpu_torch import grad

    cell = _cell("macbeth.train")
    prog = cells.Program(cell, SEED, CPU, CUT_SIZE)
    prog.set_up(cell.traffic["set_up_units"])
    kept = prog.answers()
    eager = [grad.radiance_weighted_loss_and_grad(
        prog.sess.scene, prog.theta, prog.sess.accel,
        prog.samples[b:b + 1], prog.cot, prog.params, *CUT_SIZE,
        chunk_base=b, device=CPU, per_round=True) for b, _, _ in kept]
    prog.close()
    want = correct.reference_answers(cell, SEED, kept, CPU, CUT_SIZE)
    cut = [correct.loss_rel(loss, ref) > correct.LIMITS["loss_rel"]
           for (_, loss, _), (ref, _) in zip(kept, want)]
    assert any(cut)
    for (loss, _, _, _), (ref, _) in zip(eager, want):
        assert correct.loss_rel(float(loss), ref) <= correct.LIMITS["loss_rel"]
