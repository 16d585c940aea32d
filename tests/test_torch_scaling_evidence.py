"""nart_tpu_torch.scaling_evidence on the CPU: simple_glass at 16x16 @ 2
spp, the ranks of Layout(4, 1) one after another (ranks 2 and 3 own no
strip of 8 rows at this height: they report no rounds).

The tool's per-rank rays and rounds are sharding.render_shard's, the
ranks' rays sum to a one-process render's, the balance and drain fields
agree with the rounds, and the byte counts follow tools/scaling_evidence.py's
formulas (its film psum; its gradient psum against the JAX package's own
parameter tree).  The work queue's drain count is held to the JAX tool's
loop, run on the port's machine step by step.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nart_tpu import grad as jgrad
from nart_tpu import testing as jtesting
from nart_tpu_torch import render, scaling_evidence, sharding
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

SIZE, SPP, RANKS = 16, 2, 4


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "evidence.json"
    assert scaling_evidence.main([str(SIZE), str(SPP), "--ranks", str(RANKS),
                                  "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_ranks_are_render_shards(record):
    sess = scaling_evidence.session(SIZE, SPP, "cpu")
    layout = sharding.Layout(RANKS, 1)
    stats = [sharding.render_shard(sess, layout, r, drain=True)[1]
             for r in range(RANKS)]
    assert record["rays_per_rank"] == [s["rays"] for s in stats]
    assert record["rounds_per_rank"] == [s["rounds"] for s in stats]
    assert record["drain_tail_rounds"] == [s["drain"] for s in stats]
    assert record["n_ranks"] == RANKS and record["spp_chunk"] == SPP
    assert record["rounds_per_rank"][2:] == [0, 0]  # no strip of theirs
    assert all(r > 0 for r in record["rounds_per_rank"][:2])
    assert record["device_ms_per_rank"] == [None] * RANKS
    assert record["device"] == "cpu"


def test_rays_sum_to_one_process_render(record):
    sess = scaling_evidence.session(SIZE, SPP, "cpu")
    sess.render()
    assert sum(record["rays_per_rank"]) == sess.stats["rays"] > 0


def test_balance_and_drain_fields(record):
    rounds = np.array(record["rounds_per_rank"], float)
    drain = np.array(record["drain_tail_rounds"], float)
    assert np.all(drain <= rounds) and np.all(drain >= 0)
    assert record["rounds_mean"] == rounds.mean()
    assert record["rounds_max"] == rounds.max()
    assert record["round_balance_efficiency"] == rounds.mean() / rounds.max()
    busy = rounds > 0
    assert record["drain_tail_fraction"] == pytest.approx(
        (drain[busy] / rounds[busy]).mean(), rel=1e-12)


def test_bytes_follow_the_jax_tool(record):
    fb = 2  # ceil(filter width 2)
    k = 2 * fb + 1
    rows = -(-SIZE // RANKS)
    assert record["psum_film_bytes_per_step"] == \
        (rows * RANKS + k) * (SIZE + 4 + k) * 5 * 4
    assert record["all_reduce_film_bytes"] == \
        (SIZE + 2 * fb) * (SIZE + 2 * fb) * 5 * 4
    scene = jtesting.simple_scene(("glass", "glass", "lambert"),
                                  priorities=[2, 3, 0])
    theta = jgrad.get_params(jax.tree_util.tree_map(np.asarray, scene))
    assert record["psum_grad_bytes_per_step"] == sum(
        np.asarray(x).size * 4 for x in jax.tree_util.tree_leaves(theta))


@pytest.mark.parametrize("lanes", [0, 64])
def test_drain_count_is_the_jax_tools_loop(lanes):
    """path.trace_balanced's drain counter against tools/scaling_evidence.py's
    loop on the same machine: a round is a drain round when the queue head
    had passed the last item as it began.  With 64 lanes for 512 items the
    queue refills for a while; with the automatic lanes it never does."""
    sess = scaling_evidence.session(16, 2, "cpu")
    p = sess.params
    samples = render.image_samples(16, 16, sess.total_w, p.spp, "cpu")
    drain = torch.zeros((), dtype=torch.int64)
    _, _, rounds = tpath.trace_balanced(sess.scene, sess.accel, samples, p,
                                        16, 16, n_lanes=lanes, drain=drain)
    core, step = tpath._balanced_machine(sess.scene, sess.accel, samples, p,
                                         16, 16, 0, lanes)
    total, want, live = samples.shape[0] * samples.shape[1], 0, 0
    while bool(core[0].alive.any()):
        want += int(core[3] >= total)
        live += 1
        core = step(core)[0]
    assert rounds == live and int(drain) == want
    assert (want == live) == (lanes == 0)


def test_drain_counting_changes_no_bits():
    """render_shard counts drain rounds only when asked, on a machine of its
    own: the film, rays and rounds are the uncounted call's bits, and the
    machine of the uncounted call runs no counter."""
    sess = scaling_evidence.session(16, 2, "cpu")
    layout = sharding.Layout(2, 1)
    plain, s_plain = sharding.render_shard(sess, layout, 0)
    counted, s_counted = sharding.render_shard(sess, layout, 0, drain=True)
    assert torch.equal(plain, counted)
    assert s_plain["drain"] is None and s_counted["drain"] >= 0
    assert (s_plain["rays"], s_plain["rounds"]) == (s_counted["rays"],
                                                    s_counted["rounds"])
    drains = sorted((m.drain is not None) for m in sess.machines.values())
    assert drains == [False, True]
