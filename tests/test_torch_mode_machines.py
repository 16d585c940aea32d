"""The "regen" and "spp" modes' kept machines (path.trace_regen,
path.trace_lockstep, volume.trace_lockstep) against their per-round loops,
on the CPU.

Each machine runs its rounds on rounds.RoundRunner's CPU schedule (k
rounds, then the host check: what the card runs inside a CUDA graph) and
must give the per-round loop's radiance, RNG states and ray count bit for
bit, for k = 1, 3 and 8.  The per-round loops are the routes the port ran
before the machines: "regen"'s loop written out here as it stood, and
path.trace / volume.trace, which stay the per-round loops of "spp" (and
the reference of the films held to nart_tpu's in test_torch_modes.py).
Also: rounds past the end change nothing; the "spp" bounce cap and the
volume's MAX_STEPS cut stay exact; one kept machine serves two shards'
strips of one shape (other pixels and states copied in) with each strip's
per-round bits; a dropped machine is freed at once; a "bvh" session (its
queries now capture on the card) gives its per-round film on the k-round
schedule.  Scenes: simple_scene with nested glass at 8x8, and the
volume's _env_scene medium.
"""

import dataclasses
import gc
import weakref
from dataclasses import replace

import pytest
import torch

from nart_tpu_torch import camera as tcamera
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import render as trender
from nart_tpu_torch import rounds as trounds
from nart_tpu_torch import scene as tscene
from nart_tpu_torch import testing
from nart_tpu_torch.integrators import path as tpath
from nart_tpu_torch.integrators import volume as tvol
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_volume import _env_scene

W = H = 8
KS = (1, 3, 8)
KINDS = ("regen", "spp", "volume spp")


def _path_case(bounces=6):
    sc = testing.simple_scene(("glass", "glass", "lambert"),
                              priorities=[2, 3, 0])
    params = trender.RenderParams(image_width=W, image_height=H, spp=3,
                                  bounces=bounces, roughening_factor=0.2)
    return sc, tca.build_clusters(sc.tri_v.numpy()), params


def _volume_case():
    # scattering enough for walks of 18 flight steps at 8x8
    js = _env_scene(sigma_a=0.1, sigma_s=4.0, med_le=(0.5, 0.5, 0.5))
    sc = tscene.from_numpy(dataclasses.asdict(js))
    params = trender.RenderParams(image_width=W, image_height=H, spp=2,
                                  bounces=16, integrator="volume")
    return sc, None, params


def _lanes(params, rows=None):
    """(px, py, samples, state) of the rows `rows` of the 8x8 grid (all by
    default): the render's per-pixel streams, as a shard's strips take
    them."""
    samples, state = trender.pixel_streams(W, H, W + 2, params.spp, "cpu")
    pix = torch.arange(W * H)
    if rows is not None:
        pix = pix[(pix // W >= rows[0]) & (pix // W < rows[1])]
    return pix % W, pix // W, samples[:, pix], state[pix]


def _regen_loop(sc, acc, px, py, samples, state, params):
    """"regen"'s per-round loop as the port ran it before its machine:
    one round, then a host check."""
    n, spp_chunk = px.shape[0], samples.shape[0]
    bounce_body = tpath.make_bounce(sc, acc, params)
    lane = torch.arange(n)

    def cast(jit):
        return tcamera.cast_rays(sc.cam_to_world, sc.fov, params.image_width,
                                 params.image_height, px, py, jit)

    paths = tpath._paths_init(*cast(samples[0]), state)
    bounce = torch.zeros(n, dtype=torch.int64)
    samp = torch.zeros(n, dtype=torch.int64)
    la_out = torch.zeros(((spp_chunk + 1) * n, 4))
    while bool(paths.alive.any()):
        was_alive = paths.alive
        p = bounce_body(bounce, paths)
        bounce_next = torch.where(was_alive, bounce + 1, bounce)
        alive = p.alive & (bounce_next < params.bounces)
        dying = was_alive & ~alive
        la = torch.cat([p.l, p.alpha[:, None]], dim=-1)
        slot = torch.where(dying, samp * n, spp_chunk * n) + lane
        la_out.index_add_(0, slot, torch.where(dying[:, None], la, 0.0))
        nxt = samp + 1
        respawn = dying & (nxt < spp_chunk)
        samp = torch.where(dying, nxt, samp)
        o_new, d_new = cast(samples[nxt.clamp(max=spp_chunk - 1), lane])
        paths = tpath._respawn(replace(p, alive=alive), respawn, o_new,
                               d_new, p.state)
        bounce = torch.where(respawn, 0, bounce_next)
    return (la_out[:spp_chunk * n].reshape(spp_chunk, n, 4), paths.state,
            int(paths.rays))


def _reference(kind, case, px, py, samples, state):
    """The per-round loop of `kind`: (la, state, rays)."""
    sc, acc, params = case
    if kind == "regen":
        return _regen_loop(sc, acc, px, py, samples, state, params)
    o, d = tcamera.cast_rays(sc.cam_to_world, sc.fov, params.image_width,
                             params.image_height, px, py, samples[0])
    tracer = tvol.trace if kind == "volume spp" else tpath.trace
    l, a, st, rays = tracer(sc, acc, o, d, state, params)
    return torch.cat([l, a[:, None]], dim=-1)[None], st, rays


def _tracer(kind):
    return {"regen": tpath.trace_regen, "spp": tpath.trace_lockstep,
            "volume spp": tvol.trace_lockstep}[kind]


def _case(kind):
    return _volume_case() if kind == "volume spp" else _path_case()


def _samples_of(kind, samples):
    """The samples a call takes: the chunk in "regen", one sample in
    "spp"."""
    return samples if kind == "regen" else samples[:1]


def _equal(got, want):
    la, st, rays = got
    la_r, st_r, rays_r = want
    assert torch.equal(la, la_r) and torch.equal(st, st_r)
    assert rays == rays_r


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_machine_matches_per_round_loop(kind, k, monkeypatch):
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", k)
    case = _case(kind)
    px, py, samples, state = _lanes(case[2])
    samples = _samples_of(kind, samples)
    want = _reference(kind, case, px, py, samples, state)
    machines = {}
    got = _tracer(kind)(*case[:2], px, py, samples, state, case[2],
                        machines=machines)
    _equal(got, want)
    assert want[2] > 0 and want[0][..., :3].sum() > 0
    (machine,) = machines.values()
    runner = machine.runner
    rounds = int(runner.rounds)
    assert runner.k == k and runner.rounds_run == -(-rounds // k) * k
    assert runner.captures == runner.replays == 0  # no graph on the CPU
    # the per-round loop through the same entry point
    got1 = _tracer(kind)(*case[:2], px, py, samples, state, case[2],
                         per_round=True)
    _equal(got1, want)


@pytest.mark.parametrize("kind", KINDS)
def test_rounds_past_the_end_change_nothing(kind):
    case = _case(kind)
    px, py, samples, state = _lanes(case[2])
    machines = {}
    _tracer(kind)(*case[:2], px, py, _samples_of(kind, samples), state,
                  case[2], machines=machines)
    (machine,) = machines.values()
    core, _ = machine.runner.run(machine.init())
    sinks = [t for t in (getattr(machine, "la_out", None),
                         getattr(machine, "rays", None)) if t is not None]
    before = [t.clone() for t in trounds.carry_tensors(core) + sinks]
    for _ in range(3):
        core = machine.runner.round_fn(core)
    after = trounds.carry_tensors(core) + sinks
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_spp_bounce_cap_stays_exact(k, monkeypatch):
    """One bounce leaves paths alive at the cap: the machine stops there as
    trace() does, whatever k."""
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", k)
    outs = {}
    for bounces in (1, 2):
        case = _path_case(bounces)
        px, py, samples, state = _lanes(case[2])
        want = _reference("spp", case, px, py, samples[:1], state)
        machines = {}
        outs[bounces] = got = tpath.trace_lockstep(
            *case[:2], px, py, samples[:1], state, case[2],
            machines=machines)
        _equal(got, want)
        (machine,) = machines.values()
        assert int(machine.runner.rounds) == bounces
    assert outs[1][2] < outs[2][2]  # the cap cut live paths


@pytest.mark.parametrize("k", KS)
def test_volume_max_steps_cut_stays_exact(k, monkeypatch):
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", k)
    case = _volume_case()
    px, py, samples, state = _lanes(case[2])
    full = tvol.trace_lockstep(*case[:2], px, py, samples[:1], state,
                               case[2])
    monkeypatch.setattr(tvol, "MAX_STEPS", 5)
    want = _reference("volume spp", case, px, py, samples[:1], state)
    machines = {}
    got = tvol.trace_lockstep(*case[:2], px, py, samples[:1], state, case[2],
                              machines=machines)
    _equal(got, want)
    (machine,) = machines.values()
    assert int(machine.runner.rounds) == 5
    assert machine.runner.rounds_run == -(-5 // k) * k
    assert full[2] > got[2]  # the cut left walks unfinished


@pytest.mark.parametrize("kind", KINDS)
def test_one_machine_serves_strips_of_one_shape(kind, monkeypatch):
    """Two shards' strips of one shape (rows 0-3 and 4-7): one kept
    machine, each call's own pixels and states copied in, each strip's
    per-round bits."""
    monkeypatch.setattr(trounds, "ROUNDS_PER_CHECK", 3)
    case = _case(kind)
    machines = {}
    las = []
    for rows in ((0, 4), (4, 8)):
        px, py, samples, state = _lanes(case[2], rows)
        samples = _samples_of(kind, samples)
        got = _tracer(kind)(*case[:2], px, py, samples, state, case[2],
                            machines=machines)
        _equal(got, _reference(kind, case, px, py, samples, state))
        las.append(got[0])
    assert len(machines) == 1
    assert not torch.equal(*las)


@pytest.mark.parametrize("kind", KINDS)
def test_dropped_machine_is_freed_at_once(kind):
    """As test_torch_rounds' for "balanced": no cycle through the runner,
    so a machine (and, on the card, its graph) goes with its last
    reference."""
    case = _case(kind)
    px, py, samples, state = _lanes(case[2])
    machines = {}
    _tracer(kind)(*case[:2], px, py, _samples_of(kind, samples), state,
                  case[2], machines=machines)
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


@pytest.mark.parametrize("mode", ["balanced", "regen", "spp"])
def test_bvh_session_film_equals_per_round_film(mode):
    """accel="bvh" on the k-round schedule: the per-round loop's film and
    stats, one kept machine a chunk shape."""
    sc, _, params = _path_case()
    params = dataclasses.replace(params, accel="bvh", wavefront=mode, spp=2,
                                 spp_chunk=1, lanes=16)
    films, stats = [], []
    for per_round in (False, True):
        sess = trender.RenderSession(sc, params, "cpu", per_round=per_round)
        films.append(sess.render())
        stats.append(sess.stats)
        assert len(sess.machines) == 1
        (machine,) = sess.machines.values()
        assert machine.runner.k == (1 if per_round else 4)
    assert torch.equal(*films) and stats[0] == stats[1]
    assert films[0][..., 3].sum() > 0
