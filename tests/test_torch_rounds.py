"""The round runner (nart_tpu_torch/rounds.py) and the machines kept by a
session, on the CPU.

The runner's schedule -- k rounds to each host check, the round count kept
on the device -- runs here eagerly, as it runs on the card inside a CUDA
graph.  It must give the per-round loop's per-item radiance, rays and
rounds bit for bit: the per-round loop is written out here as the port ran
it before the runner (one round, then a host check), on the path work
queue and both volume machines, for k = 1, 3 and 8, with round counts that
k does not divide (so the last k rounds run past the end), and on a volume
run cut at a small MAX_STEPS.  Rounds past the end must change nothing: on
a finished core every field stays the same, no item is pulled and only
zeros are added.  A session renders all chunks of one shape with one kept
machine, whose chunk_base is a tensor, and each chunk's items match the
JAX package's compiled chunk (render._trace_balanced_jit) under
test_torch_render's criterion (rtol 1e-4 / atol 1e-5 on >= 99.5% of the
items; equal rays and rounds).
"""

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import render as jrender
from nart_tpu import testing as jtesting
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import render as trender
from nart_tpu_torch import rounds as trounds
from nart_tpu_torch import scene as tscene
from nart_tpu_torch import testing
from nart_tpu_torch.integrators import path as tpath
from nart_tpu_torch.integrators import volume as tvol
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

W = H = 8
SPP = 2
LANES = 10  # 19 path rounds, 13 volume rounds: neither 3 nor 8 divides them
KS = (1, 3, 8)


def _samples(w=W, h=H, spp=SPP):
    return trender.image_samples(w, h, w + 2, spp, "cpu")


def _path_case():
    sc = testing.simple_scene(("glass", "glass", "lambert"),
                              priorities=[2, 3, 0])
    params = trender.RenderParams(image_width=W, image_height=H, spp=SPP,
                                  bounces=6, roughening_factor=0.2)
    return sc, tca.build_clusters(sc.tri_v.numpy()), params


def _volume_case():
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
    params = trender.RenderParams(image_width=W, image_height=H, spp=SPP,
                                  bounces=16, integrator="volume")
    return sc, params


def _path_loop(sc, acc, samples, params):
    """The per-round loop, as path.trace_balanced ran it before the
    runner: one round, then a host check."""
    core, step = tpath._balanced_machine(sc, acc, samples, params, W, H, 0,
                                         LANES)
    total = samples.shape[0] * samples.shape[1]
    la_out = torch.zeros((total + LANES, 4))
    lane = torch.arange(LANES)
    rounds = 0
    while bool(core[0].alive.any()):
        core, dying, la, item = step(core)
        la_out.index_add_(0, torch.where(dying, item, total + lane),
                          torch.where(dying[:, None], la, 0.0))
        rounds += 1
    return la_out[:total].reshape(samples.shape[:2] + (4,)), \
        int(core[0].rays), rounds


def _volume_loop(machine, sc, samples, params):
    """The volume machines' per-round loop before the runner."""
    core, step_round, n = machine(sc, samples, params, W, 0, LANES)
    total = samples.shape[0] * samples.shape[1]
    rows = -(-total // n) * n
    la_out = torch.zeros((rows + n, 3))
    lane = torch.arange(n)
    rays, rounds = 0, 0
    while rounds < tvol.MAX_STEPS and bool(core[0].alive.any()):
        core, died, l_done, item, seg = step_round(core)
        la_out.index_add_(0, torch.where(died, item, rows + lane),
                          torch.where(died[:, None], l_done, 0.0))
        rays += int(seg)
        rounds += 1
    la = torch.cat([la_out[:total], torch.ones((total, 1))], dim=-1)
    return la.reshape(samples.shape[:2] + (4,)), rays, rounds


def _run(kind, samples, k, monkeypatch, per_round=False):
    """The machine's tracer through the runner with k rounds to a check:
    (la, rays, rounds, the runner)."""
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", k)
    machines = {}
    if kind == "path":
        sc, acc, params = _path_case()
        out = tpath.trace_balanced(sc, acc, samples, params, W, H,
                                   n_lanes=LANES, machines=machines,
                                   per_round=per_round)
    else:
        sc, params = _volume_case()
        tracer = (tvol.trace_vol_static if kind == "static"
                  else tvol.trace_balanced)
        out = tracer(sc, None, samples, params, W, H, n_lanes=LANES,
                     machines=machines, per_round=per_round)
    (machine,) = machines.values()
    return out + (machine.runner,)


def _reference(kind, samples):
    if kind == "path":
        sc, acc, params = _path_case()
        return _path_loop(sc, acc, samples, params)
    sc, params = _volume_case()
    machine = (tvol._static_machine if kind == "static"
               else tvol._queue_machine)
    return _volume_loop(machine, sc, samples, params)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["path", "static", "queue"])
def test_schedule_matches_per_round_loop(kind, k, monkeypatch):
    samples = _samples()
    la_ref, rays_ref, rounds_ref = _reference(kind, samples)
    la, rays, rounds, runner = _run(kind, samples, k, monkeypatch)
    assert torch.equal(la, la_ref)
    assert (rays, rounds) == (rays_ref, rounds_ref)
    # the checks: ceil(rounds / k); the rounds run past the end: fewer
    # than k, and here some (the counts were chosen so that 3 and 8
    # divide none of them)
    assert rounds_ref > 8 and rounds_ref % 3 and rounds_ref % 8
    assert runner.rounds_run == -(-rounds_ref // k) * k
    assert runner.captures == runner.replays == 0  # no graph on the CPU
    # the per-round loop through the same entry point
    la1, rays1, rounds1, runner1 = _run(kind, samples, k, monkeypatch,
                                        per_round=True)
    assert torch.equal(la1, la_ref) and (rays1, rounds1) == (rays, rounds)
    assert runner1.k == 1 and runner1.rounds_run == rounds_ref


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["static", "queue"])
def test_max_steps_cut_stays_exact(kind, k, monkeypatch):
    """A volume run cut at MAX_STEPS rounds: the same items finished, the
    same segments and rounds as the per-round loop's cut."""
    monkeypatch.setattr(tvol, "MAX_STEPS", 5)
    samples = _samples()
    la_ref, rays_ref, rounds_ref = _reference(kind, samples)
    la, rays, rounds, runner = _run(kind, samples, k, monkeypatch)
    assert rounds_ref == rounds == 5
    assert torch.equal(la, la_ref) and rays == rays_ref
    # unfinished items are zeros: the cut left some
    assert bool((la[..., :3] == 0).all(-1).any())
    assert runner.rounds_run == -(-5 // k) * k


def _finished(kind):
    """A machine run to its end: (core, step) with step(core) -> (core',
    its per-lane outputs)."""
    samples = _samples()
    if kind == "path":
        sc, acc, params = _path_case()
        core, step = tpath._balanced_machine(sc, acc, samples, params, W, H,
                                             0, LANES)
    else:
        sc, params = _volume_case()
        machine = (tvol._static_machine if kind == "static"
                   else tvol._queue_machine)
        core, step_round, _ = machine(sc, samples, params, W, 0, LANES)

        def step(c):
            return step_round(c)
    while bool(core[0].alive.any()):
        core = step(core)[0]
    return core, step


@pytest.mark.parametrize("kind", ["path", "static", "queue"])
def test_rounds_past_the_end_change_nothing(kind):
    core, step = _finished(kind)
    before = [t.clone() for t in trounds.carry_tensors(core)]
    for _ in range(3):
        core, dying, la, *rest = step(core)
        assert not bool(dying.any())
        if kind != "path":  # the volume's segment starts
            assert int(rest[1]) == 0
    after = trounds.carry_tensors(core)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert a.dtype == b.dtype and torch.equal(a, b)


@dataclass
class _Lanes:
    alive: torch.Tensor
    left: torch.Tensor  # rounds each lane has to run


@pytest.mark.parametrize("k", KS)
def test_runner_counts_live_rounds_on_the_device(k):
    """A toy machine: lane i runs left[i] rounds, and each round adds the
    live lanes to a buffer in place (as the machines' sinks do).  The
    device count is the longest lane's, whatever k; the rounds past it add
    nothing."""
    left0 = torch.tensor([0, 3, 7, 1, 10])
    done = torch.zeros((), dtype=torch.int64)

    def round_fn(core):
        lanes, = core
        done.add_(lanes.alive.sum())
        left = torch.where(lanes.alive, lanes.left - 1, lanes.left)
        return (_Lanes(alive=lanes.alive & (left > 0), left=left),)

    runner = trounds.RoundRunner(round_fn, k=k)
    core, rounds = runner.run((_Lanes(alive=left0 > 0, left=left0),))
    assert int(rounds) == 10 and int(done) == int(left0.sum())
    assert runner.rounds_run == -(-10 // k) * k
    assert not bool(core[0].alive.any())
    # a second call starts from its own carry, its count from 0
    core, rounds = runner.run((_Lanes(alive=left0 > 2, left=left0),))
    assert int(rounds) == 10 and int(done) == 21 + 20


def test_session_chunks_share_one_machine_and_match_jax():
    """Two chunks of a render through RenderSession.trace_chunk: one kept
    machine (its chunk_base a tensor that each chunk overwrites), each
    chunk's items against the JAX package's compiled chunk with the same
    global chunk_base."""
    w = h = 16
    spp, chunk, lanes = 4, 2, 64
    jsc = jtesting.simple_scene(("lambert", "plastic"))
    tp = trender.RenderParams(image_width=w, image_height=h, spp=spp,
                              bounces=6, roughening_factor=0.3,
                              spp_chunk=chunk, lanes=lanes)
    sess = trender.RenderSession(
        tscene.from_numpy(dataclasses.asdict(jsc)), tp, "cpu")
    assert (sess.render_w, sess.render_h) == (w, h)
    samples, state = trender.pixel_streams(w, h, sess.total_w, spp, "cpu")
    pix = torch.arange(w * h)
    jp = jrender.RenderParams(image_width=w, image_height=h, spp=spp,
                              bounces=6, roughening_factor=0.3,
                              accel="brute")
    sj = jax.tree_util.tree_map(jnp.asarray, jsc)
    kept, las = [], []
    for base in range(0, spp, chunk):
        la_t, _, rays_t, rounds_t = sess.trace_chunk(
            samples[base:base + chunk], state, base, pix % w, pix // w)
        (machine,) = sess.machines.values()
        kept.append(machine)
        assert int(machine.chunk_base) == base
        la_j, rays_j, rounds_j = jrender._trace_balanced_jit(
            jnp.asarray(samples[base:base + chunk].numpy()), sj, None, jp,
            w, h, base, n_lanes=lanes)
        las.append(la_t)
        la_j = np.asarray(la_j)
        close = np.isclose(la_t.numpy(), la_j, rtol=1e-4, atol=1e-5).all(-1)
        assert close.mean() >= 0.995, (base, close.mean())
        assert (rays_t, rounds_t) == (float(rays_j), int(rounds_j))
    assert kept[0] is kept[1]
    # the chunks differ (their streams are seeded by the global sample)
    assert not torch.equal(*las)


@pytest.mark.parametrize("integrator", ["path", "volume"])
def test_session_film_equals_per_round_film(integrator):
    """A four-chunk render on the session's kept machine: the per-round
    loop's film, rays and rounds."""
    if integrator == "path":
        sc, _, params = _path_case()
    else:
        sc, params = _volume_case()
    params = dataclasses.replace(params, spp=4, spp_chunk=1, lanes=LANES)
    films, stats = [], []
    for per_round in (False, True):
        sess = trender.RenderSession(sc, params, "cpu", per_round=per_round)
        films.append(sess.render())
        stats.append(sess.stats)
        assert len(sess.machines) == 1
    assert torch.equal(*films) and stats[0] == stats[1]
    assert stats[0]["rounds"] > 4


@pytest.mark.parametrize("integrator", ["path", "volume"])
def test_dropped_machine_is_freed_at_once(integrator):
    """A kept machine (and, on the card, its graph) goes when its last
    reference does, with no cyclic garbage left for the collector: a
    graph collected during another graph's capture would invalidate it."""
    import gc
    import weakref

    samples = _samples()
    machines = {}
    if integrator == "path":
        sc, acc, params = _path_case()
        tpath.trace_balanced(sc, acc, samples, params, W, H, n_lanes=LANES,
                             machines=machines)
    else:
        sc, params = _volume_case()
        tvol.trace_vol_static(sc, None, samples, params, W, H,
                              n_lanes=LANES, machines=machines)
    (machine,) = machines.values()
    refs = [weakref.ref(x) for x in (machine, machine.runner)]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        del machine
        machines.clear()
        assert [r() for r in refs] == [None, None]
    finally:
        if was_enabled:
            gc.enable()
