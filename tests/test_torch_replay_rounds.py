"""The kept replay machine (nart_tpu_torch/replay.py, rounds.ReplayRunner)
against the per-round replay, on the CPU.

The machine runs a fwd+bwd call on the card as CUDA graphs: the forward k
rounds to each host check, writing every round's carry into a store at a
slot counted on the device, and the backward one captured round replayed
once for each round, last to first.  Here the same schedule runs eagerly,
with the same store and slots.  It must give the per-round replay's loss
(rtol 1e-6) and every gradient leaf (rtol 1e-5 / atol 1e-7), with the same
rays and rounds: on the path work queue (a nested-glass stack under a disk
light, whose packed tables the rounds derive from the trainable leaves,
and a textured plastic scene under a textured environment light) and on
the volume's static machine, for k = 1, 3 and 4 with round counts that 3
and 4 do not divide (so the last rounds run past the end, and write the
store's spare slot).  One machine serves calls with other parameters,
samples, cotangents and chunk_base; an n_rounds below the count regrows;
the backward makes no traversal query; a dropped machine is freed at once.
8x8 at 2 spp on 10 work slots.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import rounds as trounds
from nart_tpu_torch import testing
from nart_tpu_torch.integrators import path as tpath
from nart_tpu_torch.integrators import volume as tvol

W = H = 8
SPP = 2
LANES = 10
KS = (1, 3, 4)


def _textured():
    """env_scene with a 4x4 albedo texture on its plastic: texels that are
    half floats (the render route's half table then reads the gradient's
    values, so the forward that measures the rounds takes the replay's
    decisions)."""
    sc = testing.env_scene(("plastic",), roughness=0.3)
    tex = np.random.default_rng(3).uniform(0.2, 0.9, (16, 3))
    return dataclasses.replace(
        sc, rho_d_tex=torch.zeros(1, dtype=torch.int32),
        tex_data=torch.from_numpy(tex.astype(np.float16).astype(np.float32)),
        tex_off=torch.zeros(1, dtype=torch.int32),
        tex_w=torch.full((1,), 4, dtype=torch.int32),
        tex_h=torch.full((1,), 4, dtype=torch.int32), tex_slots=("rho_d",))


def _case(kind):
    """(scene, accel, params) of a case."""
    if kind == "volume":
        dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
        sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
        return sc, None, trender.RenderParams(
            image_width=W, image_height=H, spp=SPP, bounces=16,
            integrator="volume")
    sc = (testing.simple_scene(("glass", "glass", "lambert"),
                               priorities=[2, 3, 0]) if kind == "glass"
          else _textured())
    return sc, tca.build_clusters(sc.tri_v.numpy()), trender.RenderParams(
        image_width=W, image_height=H, spp=SPP, bounces=6,
        roughening_factor=0.2)


def _inputs(seed=0, chunk_base=0):
    samples = trender.image_samples(W, H, W + 2, SPP + chunk_base,
                                    "cpu")[chunk_base:]
    rng = np.random.default_rng(seed)
    cot = torch.from_numpy(rng.random((SPP, W * H, 4), dtype=np.float32))
    return samples, cot


def _call(kind, per_round=False, machines=None, theta=None, seed=0,
          chunk_base=0, n_rounds=None):
    sc, acc, params = _case(kind)
    samples, cot = _inputs(seed, chunk_base)
    return tgrad.radiance_weighted_loss_and_grad(
        sc, tgrad.get_params(sc) if theta is None else theta, acc, samples,
        cot, params, W, H, chunk_base=chunk_base, lanes=LANES,
        n_rounds=n_rounds, device="cpu", machines=machines,
        per_round=per_round)


def _assert_same(got, want):
    """Loss rtol 1e-6, every gradient leaf rtol 1e-5 / atol 1e-7, the same
    rays and rounds."""
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert got[2:] == want[2:]
    a, b = tgrad.flatten_leaves(got[1]), tgrad.flatten_leaves(want[1])
    assert torch.isfinite(a).all() and b.abs().sum() > 0
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _replay_runner(machines):
    (machine,) = [m for k, m in machines.items()
                  if k[0].endswith("_replay")]
    return machine, machine.runner


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["glass", "textured", "volume"])
def test_schedule_matches_per_round_replay(kind, k, monkeypatch):
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", k)
    want = _call(kind, per_round=True)
    machines = {}
    got = _call(kind, machines=machines)
    _assert_same(got, want)
    rounds = want[3]
    assert rounds % 3 and rounds % 4  # rounds past the end for k = 3, 4
    _, runner = _replay_runner(machines)
    assert runner.k == k
    assert runner.rounds_run == -(-rounds // k) * k
    assert runner.back_rounds == rounds
    assert runner.captures == runner.replays == 0  # no graph on the CPU
    if kind == "textured":
        assert got[1]["tex_data"].abs().sum() > 0


def _doubled(kind):
    """The case's parameters, each leaf scaled (albedos, the lights' Le,
    the medium): another call's theta."""
    sc, _, _ = _case(kind)
    return tgrad._map_params(lambda x: x * 0.7, tgrad.get_params(sc))


@pytest.mark.parametrize("kind", ["glass", "volume"])
def test_kept_machine_serves_other_calls(kind):
    """One kept machine, three calls: other parameters, samples, cot and
    chunk_base each time, and each call equals a fresh per-round replay
    (no stale buffer, no stale table)."""
    machines = {}
    calls = [dict(), dict(theta=_doubled(kind), seed=1, chunk_base=2),
             dict(seed=2, chunk_base=5)]
    kept = None
    for kw in calls:
        got = _call(kind, machines=machines, **kw)
        _assert_same(got, _call(kind, per_round=True, **kw))
        machine, _ = _replay_runner(machines)
        assert kept is None or machine is kept
        kept = machine
    assert kept.calls == 3


@pytest.mark.parametrize("kind", ["glass", "volume"])
def test_short_n_rounds_regrows(kind):
    """n_rounds = 2, far below the count: the call reports unfinished
    lanes, the entry point measures again and grows the store, and the
    result is the full chunk's."""
    sc, acc, params = _case(kind)
    samples, cot = _inputs()
    fn = (tvol.trace_vol_static_loss if kind == "volume"
          else tpath.trace_balanced_loss)
    theta = tgrad._as_leaves(tgrad.get_params(sc), "cpu")
    _, _, unfinished, rounds = fn(tgrad.put_params(sc, theta), acc, samples,
                                  cot, params, W, H, n_rounds=2,
                                  n_lanes=LANES)
    assert unfinished > 0 and rounds == 2
    machines = {}
    got = _call(kind, machines=machines, n_rounds=2)
    _assert_same(got, _call(kind, per_round=True))
    machine, _ = _replay_runner(machines)
    assert machine.capacity >= got[3] > 2


def test_backward_makes_no_traversal_query(monkeypatch):
    """On a kept machine's second call (no measuring forward), the
    forward queries once in every round it runs and the backward not at
    all: both queries are answered from the store."""
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
    sc, acc, params = _case("glass")
    samples, cot = _inputs()
    rho_s = sc.rho_s_const.clone().requires_grad_()
    scn = dataclasses.replace(sc, rho_s_const=rho_s)
    machines = {}
    tpath.trace_balanced_loss(scn, acc, samples, cot, params, W, H,
                              n_lanes=LANES, machines=machines)[0].backward()
    _, runner = _replay_runner(machines)
    ran = runner.rounds_run
    calls.update(closest=0, any=0)
    loss, _, unfinished, rounds = tpath.trace_balanced_loss(
        scn, acc, samples, cot, params, W, H, n_lanes=LANES,
        machines=machines)
    assert unfinished == 0
    assert runner.rounds_run - ran == -(-rounds // trounds.ROUNDS_PER_CHECK) \
        * trounds.ROUNDS_PER_CHECK
    assert calls == {"closest": runner.rounds_run - ran,
                     "any": runner.rounds_run - ran}
    rho_s.grad = None
    loss.backward()
    assert calls["closest"] == calls["any"] == runner.rounds_run - ran
    assert torch.isfinite(rho_s.grad).all() and rho_s.grad.abs().sum() > 0


def test_backward_after_a_later_call_raises():
    """A call's backward reads the machine's store: after a later call on
    the same machine it would read that call's rounds, so it raises."""
    sc, acc, params = _case("glass")
    samples, cot = _inputs()
    theta = tgrad._as_leaves(tgrad.get_params(sc), "cpu")
    scn = tgrad.put_params(sc, theta)
    machines = {}
    first = tpath.trace_balanced_loss(scn, acc, samples, cot, params, W, H,
                                      n_lanes=LANES, machines=machines)[0]
    tpath.trace_balanced_loss(scn, acc, samples, cot, params, W, H,
                              n_lanes=LANES, machines=machines)
    with pytest.raises(RuntimeError, match="reused this replay machine"):
        first.backward()


@pytest.mark.parametrize("kind", ["glass", "volume"])
def test_dropped_machine_is_freed_at_once(kind):
    """A kept replay machine (and, on the card, its two graphs and its
    store) goes when its last reference does, with no cyclic garbage left
    for the collector."""
    machines = {}
    _call(kind, machines=machines)
    machine, runner = _replay_runner(machines)
    refs = [weakref.ref(x) for x in (machine, runner)]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        del machine, runner
        machines.clear()
        assert [r() for r in refs] == [None, None]
    finally:
        if was_enabled:
            gc.enable()
