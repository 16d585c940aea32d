"""nart_tpu_torch.select (small-table look-ups) vs nart_tpu.select.

The same numpy inputs through the JAX package's one-hot look-ups (on the
CPU) and the port's: forward values exactly (a look-up copies a row), the
vector-Jacobian products to rtol 1e-5 / atol 1e-6 (the per-row sums run in
another order: the one-hot product's transpose there, a serial sum per row
here), int and bool tables exactly, indices below 0 and from n up clamped.
materials.make_bsdf's five per-mesh table gradients (mesh_lookup) against
the JAX make_bsdf's (mesh_luts) at rtol 1e-5.  The large tables (more
than 64 rows: an 8,192-texel env map, the 343 rows of 8 of a small
density's packed cells) against the JAX package's plain gather and its
scatter-add, with uniform indices and with every lane on one row.  A float
look-up is the autograd Function _LutGather on every device; on the CPU
its forward and backward run their plain versions.  A differentiable path
round (textured plastic under a textured env map, both tables of more than
64 texels) and a volume flight step read no trainable table through
PyTorch's own indexing backward.  Several tables read by one index are
one look-up (one launch on the card): the bits and gradients of one
look-up a table, and make_bsdf one look-up a call.  The large-table
backward's radix sort, by its plain mirror (select.radix_order_plain):
torch.sort(stable=True)'s permutation, and, summed row by row in that
order, the plain backward's bits.  A look-up's small trainable tables
take one backward dispatch (select.lut_gather_bwd_many: one launch on the
card), its large table its own, their gradients the JAX VJPs; a
differentiable macbeth round's backward makes one such dispatch
(make_bsdf's look-up); the dispatcher refuses what the kernel does not
take on every device.  The kernels (csrc/small_lut.cu,
csrc/large_lut.cu) against the plain versions on the card are in
tests/test_torch_kernels.py (no jax there), which skips without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import materials as jm
from nart_tpu import select as jsel
from nart_tpu import testing as jtesting
from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import cuda_build
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import materials as tm
from nart_tpu_torch import media as tmedia
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from nart_tpu_torch import select as tsel
from nart_tpu_torch import testing
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
LANES = 1000
TABLES = ("rho_d_const", "rho_s_const", "tau_const", "alpha_const",
          "eta_const")


def _indices(n, g):
    """LANES indices in [0, n), with a few below 0 and from n up."""
    idx = g.integers(0, n, LANES)
    idx[:8] = [-1, -7, n, n + 5, 0, n - 1, -1000, 10 * n]
    return idx


@pytest.mark.parametrize("fn", ["small_lut", "auto_lut"])
@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("n", [1, 3, 64, 65])
def test_lut_forward_and_vjp_match_jax(fn, width, n):
    """Forward exact, VJP to rtol 1e-5 / atol 1e-6; the JAX package's
    small_lut (one-hot at any n) and auto_lut (a plain gather at n = 65)
    against the port's one small_lut."""
    g = np.random.default_rng(n * 10 + (width or 1))
    shape = (n,) if width is None else (n, width)
    table = g.normal(size=shape).astype(np.float32)
    idx = _indices(n, g)
    cot = g.normal(size=(LANES,) + shape[1:]).astype(np.float32)

    jlut = getattr(jsel, fn)(jnp.asarray(idx.astype(np.int32)), n)
    out_j, vjp = jax.vjp(jlut, jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot))

    tt = torch.from_numpy(table).requires_grad_()
    out_t = tsel.small_lut(torch.from_numpy(idx), n)(tt)
    (grad_t,) = torch.autograd.grad(out_t, tt, torch.from_numpy(cot))

    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(out_t.detach().numpy(),
                                  table[np.clip(idx, 0, n - 1)])
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
def test_int_and_bool_tables_exact(dtype):
    """Int tables round-trip the JAX one-hot product exactly (values below
    2^24), bool tables its any(); here both are plain indexing."""
    g = np.random.default_rng(5)
    n = 6
    table = (g.integers(0, 1 << 20, n) if dtype == np.int32
             else g.random(n) < 0.5).astype(dtype)
    idx = _indices(n, g)
    out_j = jsel.small_lut(jnp.asarray(idx.astype(np.int32)), n)(
        jnp.asarray(table))
    out_t = tsel.small_lut(torch.from_numpy(idx), n)(torch.from_numpy(table))
    assert out_t.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(out_t.numpy(),
                                  table[np.clip(idx, 0, n - 1)])


@pytest.mark.parametrize("width", [None, 3])
def test_lut_gather_function_on_the_cpu(width):
    """small_lut's float look-up is _LutGather, with its plain versions on
    the CPU: the forward is table[idx]'s bits, the backward the per-row sum
    that table[idx]'s autograd gives; no kernel launch is counted."""
    g = np.random.default_rng(11)
    n = 4
    shape = (n,) if width is None else (n, width)
    table = torch.from_numpy(g.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, n, LANES))
    cot = torch.from_numpy(
        g.normal(size=(LANES,) + shape[1:]).astype(np.float32))
    cuda_build.reset_launch_counts()
    a = table.clone().requires_grad_()
    out = tsel.small_lut(idx, n)(a)
    assert type(out.grad_fn).__name__ == "_LutGatherBackward"
    (ga,) = torch.autograd.grad(out, a, cot)
    b = table.clone().requires_grad_()
    (gb,) = torch.autograd.grad(b[idx], b, cot)
    assert torch.equal(out.detach(), table[idx])
    assert torch.equal(ga, gb)
    assert torch.equal(ga, tsel.lut_gather_bwd_plain(cot, idx, n))
    assert not any(cuda_build.launch_counts.values())
    with pytest.raises(ValueError):
        tsel.lut_gather(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        tsel.small_lut(idx.to("meta"), n)(table.to("meta"))


def test_make_bsdf_table_gradients_match_jax():
    """The five per-mesh tables' gradients through make_bsdf (mesh_lookup
    here, mesh_luts there) on a four-material simple_scene, with a few
    out-of-range mesh ids (clamped on both sides)."""
    js = jtesting.simple_scene(("lambert", "plastic", "glass", "glossy"))
    sj = jax.tree_util.tree_map(jnp.asarray, js)
    ts = tscene.from_numpy(dataclasses.asdict(js))
    g = np.random.default_rng(7)
    n = 512
    mesh = g.integers(0, js.n_meshes, n)
    mesh[:4] = [-1, js.n_meshes, js.n_meshes + 3, -2]
    st = g.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    sn = g.normal(size=(n, 3)).astype(np.float32)
    dpds = g.normal(size=(n, 3)).astype(np.float32)
    tweak = g.uniform(0.2, 1.0, n).astype(np.float32)
    outs = ("rho_d", "rho_s", "tau", "eta", "alpha0", "alpha_prime")
    cots = {k: g.normal(size=(n, 3) if k in ("rho_d", "rho_s", "tau")
                        else (n,)).astype(np.float32) for k in outs}

    def fj(tables):
        _, d = jm.make_bsdf(dataclasses.replace(sj, **tables),
                            jnp.asarray(mesh.astype(np.int32)),
                            jnp.asarray(st), jnp.asarray(sn),
                            jnp.asarray(dpds), jnp.asarray(tweak))
        return {k: getattr(d, k) for k in outs}

    _, vjp = jax.vjp(fj, {k: getattr(sj, k) for k in TABLES})
    (grads_j,) = vjp({k: jnp.asarray(v) for k, v in cots.items()})

    leaves = {k: getattr(ts, k).clone().requires_grad_() for k in TABLES}
    _, d = tm.make_bsdf(dataclasses.replace(ts, **leaves),
                        torch.from_numpy(mesh), torch.from_numpy(st),
                        torch.from_numpy(sn), torch.from_numpy(dpds),
                        torch.from_numpy(tweak))
    loss = sum((getattr(d, k) * torch.from_numpy(cots[k])).sum()
               for k in outs)
    grads_t = torch.autograd.grad(loss, [leaves[k] for k in TABLES])
    for k, gt in zip(TABLES, grads_t):
        gj = np.asarray(grads_j[k])
        assert np.abs(gj).sum() > 0.0, k
        np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _cells_table(g):
    """The packed cell table (343 rows of 8) of a random 8^3 density."""
    dens = torch.from_numpy(g.uniform(0.0, 1.0, (8, 8, 8)).astype(np.float32))
    return tmedia.pack_density_cells(dens).numpy()


@pytest.mark.parametrize("lanes", ["uniform", "one row"])
@pytest.mark.parametrize("table", ["n=65", "env map", "cells"])
def test_large_lut_matches_jax(table, lanes):
    """small_lut on tables of more than 64 rows (the large-table backward
    on the card): the forward the JAX package's plain gather's bits, the
    VJP its scatter-add's to rtol 1e-5 / atol 1e-6 (a float32 sum in another
    order), with uniform indices and with every lane on one row; the
    look-up is _LutGather, run here by its plain versions."""
    g = np.random.default_rng(len(table) * 10 + len(lanes))
    tab = {"n=65": lambda: g.normal(size=(65, 3)),
           "env map": lambda: g.uniform(0.0, 4.0, (64 * 128, 3)),
           "cells": lambda: _cells_table(g)}[table]().astype(np.float32)
    n = tab.shape[0]
    idx = (g.integers(0, n, LANES) if lanes == "uniform"
           else np.full(LANES, g.integers(0, n)))
    cot = g.normal(size=(LANES,) + tab.shape[1:]).astype(np.float32)

    jlut = jsel.auto_lut(jnp.asarray(idx.astype(np.int32)), n)
    out_j, vjp = jax.vjp(jlut, jnp.asarray(tab))
    (grad_j,) = vjp(jnp.asarray(cot))

    tt = torch.from_numpy(tab).requires_grad_()
    out_t = tsel.small_lut(torch.from_numpy(idx), n)(tt)
    assert type(out_t.grad_fn).__name__ == "_LutGatherBackward"
    (grad_t,) = torch.autograd.grad(out_t, tt, torch.from_numpy(cot))

    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(out_t.detach().numpy(), tab[idx])
    assert np.abs(grad_t.numpy()).sum() > 0.0
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=RTOL, atol=ATOL)


# autograd nodes that only move, reshape or join a tensor's values: a table
# read through them is the leaf itself
_SHAPE_NODES = ("ViewBackward0", "UnsafeViewBackward0",
                "ReshapeAliasBackward0", "CatBackward0", "StackBackward0",
                "SliceBackward0", "SelectBackward0", "ExpandBackward0",
                "CloneBackward0", "ToCopyBackward0", "PermuteBackward0",
                "TBackward0", "TransposeBackward0", "SqueezeBackward0",
                "SqueezeBackward1", "UnsqueezeBackward0")


def _nodes(fn):
    """Every autograd node reachable from fn."""
    seen, stack = {}, [fn]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        stack += [nxt for nxt, _ in node.next_functions]
    return list(seen.values())


def _tables_read(node):
    """The leaves a node's first input is, or is a rearrangement of."""
    out, stack = [], [node.next_functions[0][0]]
    while stack:
        fn = stack.pop()
        if fn is None:
            continue
        name = type(fn).__name__
        if name == "AccumulateGrad":
            out.append(fn.variable)
        elif name in _SHAPE_NODES:
            stack += [nxt for nxt, _ in fn.next_functions]
    return out


def _textured_env_scene():
    """Textured plastic (a 12x12 albedo texture) under an 8x16 textured env
    map: both tables of more than 64 texels."""
    sc = testing.env_scene(("plastic",), tex_h=8, tex_w=16, roughness=0.3)
    tex = np.random.default_rng(4).uniform(0.2, 0.9, (144, 3))
    return dataclasses.replace(
        sc, rho_d_tex=torch.zeros(1, dtype=torch.int32),
        tex_data=torch.from_numpy(tex.astype(np.float32)),
        tex_off=torch.zeros(1, dtype=torch.int32),
        tex_w=torch.full((1,), 12, dtype=torch.int32),
        tex_h=torch.full((1,), 12, dtype=torch.int32), tex_slots=("rho_d",))


@pytest.mark.parametrize("kind", ["path round", "volume flight step"])
def test_no_table_read_through_index_backward(kind):
    """The differentiable path round (every bounce of a lockstep trace) and
    the volume's flight step (every step of a lockstep walk) read their
    large trainable tables (the texture, the env map, the density's cells)
    through _LutGather: no float leaf that requires grad is read through
    an IndexBackward0 node (PyTorch's gather, whose backward is the serial
    indexing_backward on the card), and the tables are read through
    _LutGatherBackward."""
    if kind == "path round":
        sc = _textured_env_scene()
        accel = tca.build_clusters(sc.tri_v.numpy())
        params = trender.RenderParams(image_width=6, image_height=6, spp=1,
                                      bounces=3)
        want = ("tex_data", "light_le_tex[0]")
    else:
        dens = np.random.default_rng(5).uniform(0.3, 1.0, (8, 8, 8))
        sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
        accel = None
        params = trender.RenderParams(image_width=6, image_height=6, spp=1,
                                      integrator="volume")
        want = ("medium.density",)
    leaves = tgrad._as_leaves(tgrad.get_params(sc), "cpu")
    scene = tgrad.put_params(sc, leaves)
    out = tgrad.render_lanes(scene, accel, params, 6, 6, 1)
    names = {id(v): f"{k}[{i}]" for k in ("light_le_tex",)
             for i, v in enumerate(leaves[k]) if v is not None}
    names.update({id(leaves[k]): k for k in tgrad.TRAINABLE_FIELDS})
    if "medium" in leaves:
        names.update({id(v): f"medium.{k}"
                      for k, v in leaves["medium"].items()})
    nodes = _nodes(out.grad_fn)
    through_index = [names.get(id(v), "?") for node in nodes
                     if type(node).__name__ == "IndexBackward0"
                     for v in _tables_read(node)]
    assert through_index == []
    through_lut = {names.get(id(v), "?") for node in nodes
                   if type(node).__name__ == "_LutGatherBackward"
                   for v in _tables_read(node)}
    assert set(want) <= through_lut, through_lut


def test_lut_runs_counts_the_large_backward_look_ups():
    """lut_runs.runs on a per-round fwd+bwd of the textured scene: the
    backward look-ups of the 144-texel texture and the 128-texel env map
    (the large-table backward's tables) are counted, with the longest run
    of one row between 1 and the lanes, and select's backward is itself
    again afterwards."""
    from nart_tpu_torch import lut_runs

    sc = _textured_env_scene()
    accel = tca.build_clusters(sc.tri_v.numpy())
    params = trender.RenderParams(image_width=6, image_height=6, spp=1,
                                  bounces=3)
    inner = tsel.lut_gather_bwd
    out = lut_runs.runs(sc, accel, params, "cpu")
    assert tsel.lut_gather_bwd is inner
    assert {(144, 3), (128, 3)} <= set(out), out
    for (n, _), rec in out.items():
        assert n > tsel.AUTO_LUT_ROWS
        assert rec["launches"] >= 1
        assert 1 <= rec["rows"] <= min(n, rec["lanes"])
        assert 1 <= rec["run"] <= rec["lanes"]
        assert 0 <= rec["row"] < n



# the large-table backward's radix sort, by its plain mirror: the rows the
# path reads (the env map, the density cells, the texture) and the edges
RADIX_ROWS = (1, 8192, 29791, 9047075)


def _radix_idx(kind, n, lanes, g):
    if kind == "uniform":
        return g.integers(0, n, lanes)
    if kind == "one row":
        return np.full(lanes, g.integers(0, n))
    idx = g.integers(0, n, lanes)  # masked: -1, clamped to row 0
    idx[g.random(lanes) < 0.5] = -1
    return idx


@pytest.mark.parametrize("kind", ["uniform", "one row", "masked"])
@pytest.mark.parametrize("n", RADIX_ROWS)
@pytest.mark.parametrize("lanes", [1, 3000, 2 * tsel.RADIX_TILE + 5])
def test_radix_order_is_torch_sort(n, kind, lanes):
    """select.radix_order_plain (the passes and counting ranks of
    nart_lut_large_bwd's radix sort: 1, 2, 2 and 3 passes over 1, 13, 15
    and 24 bits) gives torch.sort(stable=True)'s keys and permutation of
    the clamped rows, for lane counts that are no multiple of its tiles."""
    g = np.random.default_rng(n + lanes + len(kind))
    idx = torch.from_numpy(_radix_idx(kind, n, lanes, g))
    keys, order = tsel.radix_order_plain(idx, n)
    want_keys, want_order = torch.sort(
        idx.clamp(0, n - 1).to(torch.int32), stable=True)
    assert keys.dtype == order.dtype == torch.int32
    assert torch.equal(keys, want_keys)
    assert torch.equal(order.long(), want_order)


def test_radix_schedule():
    """The passes of at most 8 bits over ceil(log2 n) bits (at least 1)."""
    assert [tsel.radix_schedule(n) for n in RADIX_ROWS] == [
        (1, 1, 1), (13, 2, 7), (15, 2, 8), (24, 3, 8)]
    assert tsel.radix_schedule(2**31 - 1) == (31, 4, 8)
    assert tsel.radix_schedule(257) == (9, 2, 5)


@pytest.mark.parametrize("n,width", [(8192, 3), (29791, 8), (65, 1)])
def test_radix_order_then_row_sums_is_the_plain_backward(n, width):
    """The mirror's order, then each row's cotangents summed in that order
    (a serial sum over the sorted lanes), gives the plain backward's bits:
    the stable order keeps every row's lanes in lane order."""
    g = np.random.default_rng(n)
    lanes = 3 * tsel.RADIX_TILE + 7
    idx = torch.from_numpy(_radix_idx("masked", n, lanes, g))
    cot = torch.from_numpy(g.normal(size=(lanes, width)).astype(np.float32))
    if width == 1:
        cot = cot[:, 0]
    keys, order = tsel.radix_order_plain(idx, n)
    sums = cot.new_zeros((n,) + tuple(cot.shape[1:])).index_add_(
        0, keys.long(), cot[order.long()])
    assert torch.equal(sums, tsel.lut_gather_bwd_plain(
        cot, idx.clamp(0, n - 1), n))


@pytest.mark.parametrize("n", [4, 100])
def test_many_table_look_up(n):
    """lut(a, b, c, ...) in one look-up (one _LutGather application) gives
    the bits of one look-up a table, int and bool tables among the float
    ones included, and each float table's gradient the bits of its own
    look-up's; a table no gradient reaches gets none."""
    g = np.random.default_rng(n)
    idx = torch.from_numpy(_indices(n, g))
    shapes = [(n, 3), (n,), (n, 8), (n, 1), (n, 4)]
    tables = [torch.from_numpy(g.normal(size=s).astype(np.float32))
              for s in shapes]
    ints = torch.from_numpy(g.integers(-5, 5, n))
    flags = torch.from_numpy(g.random(n) < 0.5)
    cots = [torch.from_numpy(g.normal(size=(LANES,) + s[1:])
                             .astype(np.float32)) for s in shapes]
    lut = tsel.small_lut(idx, n)

    many = [t.clone().requires_grad_() for t in tables]
    unused = tables[0].clone().requires_grad_()
    counts = {"apply": 0}
    inner = tsel._LutGather.apply

    def counted(*args):
        counts["apply"] += 1
        return inner(*args)

    tsel._LutGather.apply = counted
    try:
        a, i, b, f, c, d, e, u = lut(many[0], ints, many[1], flags, many[2],
                                     many[3], many[4], unused)
    finally:
        tsel._LutGather.apply = inner
    assert counts["apply"] == 1
    assert torch.equal(i, ints[idx.clamp(0, n - 1)])
    assert torch.equal(f, flags[idx.clamp(0, n - 1)])
    outs = (a, b, c, d, e)
    # rows of a table that needs no gradient need none: nothing computed
    # from them alone is traced
    mixed = lut(many[0], tables[1])
    assert mixed[0].requires_grad and not mixed[1].requires_grad
    grads = torch.autograd.grad(
        sum((o * k).sum() for o, k in zip(outs, cots)), many + [unused],
        allow_unused=True)
    assert grads[-1] is None
    for t, o, k, gm in zip(tables, outs, cots, grads):
        one = t.clone().requires_grad_()
        out1 = lut(one)
        (g1,) = torch.autograd.grad(out1, one, k)
        assert torch.equal(o, out1.detach())
        assert torch.equal(gm, g1)


def test_make_bsdf_is_one_look_up():
    """make_bsdf reads its per-mesh tables in one look-up (the float ones
    in one launch on the card): one _LutGather application a call on an
    untextured scene, one more a texture slot's fetch of the float32
    texture table."""
    counts = {"apply": 0}
    inner = tsel._LutGather.apply

    def counted(*args):
        counts["apply"] += 1
        return inner(*args)

    g = np.random.default_rng(3)
    n = 64
    args = (torch.from_numpy(g.normal(size=(n, 2)).astype(np.float32)),
            torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)),
            torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)),
            torch.full((n,), 0.5))
    tsel._LutGather.apply = counted
    try:
        plain = testing.simple_scene(("lambert", "plastic", "glass",
                                      "glossy"))
        tm.make_bsdf(plain, torch.from_numpy(g.integers(-1, 5, n)), *args)
        assert counts["apply"] == 1
        counts["apply"] = 0
        textured = _textured_env_scene()
        tm.make_bsdf(textured, torch.zeros(n, dtype=torch.int64), *args)
        assert counts["apply"] == 2  # the tables, rho_d's texel fetch
    finally:
        tsel._LutGather.apply = inner


def test_many_table_wrapper_refuses_more_tables_than_a_launch_reads():
    """nart_lut_gather_many reads at most MAX_TABLES tables: the wrapper
    refuses more before it looks at the device (small_lut splits them)."""
    t = torch.zeros(4, 3)
    idx = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="tables"):
        tsel.lut_gather_many_cuda([t] * (tsel.MAX_TABLES + 1), idx)
    outs = tsel.small_lut(idx, 4)(*[t] * (tsel.MAX_TABLES + 1))
    assert len(outs) == tsel.MAX_TABLES + 1
    assert all(torch.equal(o, t[idx]) for o in outs)


@pytest.mark.parametrize("scene", ["macbeth", "simple_glass"])
def test_path_round_look_ups(scene):
    """A forward path round reads its float tables in 4 look-ups (4
    launches on the card): make_bsdf's per-mesh tables, and macbeth's env
    map three times or simple_glass's three packed-light sites."""
    import os

    if scene == "macbeth":
        root = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")
        sc = tscene.load_scene(os.path.join(root, "macbeth.json"),
                               asset_root=root)
        params = trender.RenderParams(image_width=24, image_height=16, spp=1)
    else:
        sc = testing.simple_scene(("glass", "glass", "lambert"),
                                  priorities=[2, 3, 0])
        params = trender.RenderParams(image_width=16, image_height=16,
                                      spp=1, bounces=10)
    counts = {"apply": 0}
    inner = tsel._LutGather.apply

    def counted(*args):
        counts["apply"] += 1
        return inner(*args)

    tsel._LutGather.apply = counted
    try:
        sess = trender.RenderSession(sc, params, "cpu", per_round=True)
        sess.image()
    finally:
        tsel._LutGather.apply = inner
    assert counts["apply"] == 4 * sess.stats["rounds"] > 0


def _recording(name, calls):
    """tsel.<name> wrapped so that each call's (rows, cotangent shapes) is
    appended to calls; returns the original."""
    inner = getattr(tsel, name)

    def rec(grads, idx, rows):
        calls.append((list(rows), [tuple(g.shape[1:]) for g in grads]))
        return inner(grads, idx, rows)

    def rec_one(g, idx, n):
        calls.append(([n], [tuple(g.shape[1:])]))
        return inner(g, idx, n)

    setattr(tsel, name, rec if name == "lut_gather_bwd_many" else rec_one)
    return inner


@pytest.mark.parametrize("n", [1, 4])
def test_small_tables_backward_is_one_dispatch(n):
    """One look-up of small trainable tables (n to 64 rows of 1 to 4 values),
    a float table that needs no gradient and a table of 100 rows (S2's):
    each trainable table's gradient is the VJP of the JAX package's
    small_lut (auto_lut above 64 rows) on the same indices to rtol 1e-5 /
    atol 1e-6 (positive cotangents: with n = 1 all 1,000 lanes sum into one
    row, and a signed float32 sum that cancels differs between two orders
    by more than rtol times its value); the small trainable tables'
    backward is one lut_gather_bwd_many call with those tables alone, in
    their order, and the large table's its own lut_gather_bwd call."""
    g = np.random.default_rng(40 + n)
    small = [(n,), (7, 2), (16, 3), (33, 4), (64, 1), (64, 3)]
    shapes = small[:3] + [(100, 3)] + small[3:]
    tables = [g.normal(size=s).astype(np.float32) for s in shapes]
    fixed = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    idx = _indices(n, g)
    ci = np.clip(idx, 0, n - 1)
    cots = [g.uniform(0.0, 1.0, (LANES,) + s[1:]).astype(np.float32)
            for s in shapes]

    leaves = [torch.from_numpy(t).requires_grad_() for t in tables]
    outs = tsel.small_lut(torch.from_numpy(idx), n)(
        *leaves[:2], fixed, *leaves[2:])
    assert not outs[2].requires_grad
    outs = outs[:2] + outs[3:]
    many, one = [], []
    inner_many = _recording("lut_gather_bwd_many", many)
    inner_one = _recording("lut_gather_bwd", one)
    try:
        grads = torch.autograd.grad(
            sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)),
            leaves)
    finally:
        tsel.lut_gather_bwd_many = inner_many
        tsel.lut_gather_bwd = inner_one
    assert many == [([s[0] for s in small], [s[1:] for s in small])]
    assert one == [([100], [(3,)])]
    jidx = jnp.asarray(ci.astype(np.int32))
    for t, c, gt in zip(tables, cots, grads):
        rows = t.shape[0]
        fn = jsel.small_lut if rows <= tsel.AUTO_LUT_ROWS else jsel.auto_lut
        _, vjp = jax.vjp(fn(jidx, rows), jnp.asarray(t))
        (gj,) = vjp(jnp.asarray(c))
        assert np.abs(np.asarray(gj)).sum() > 0.0
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                                   atol=ATOL, err_msg=str(t.shape))


def test_path_round_backward_is_one_small_table_dispatch():
    """A per-round fwd+bwd of macbeth (24x16 @ 1 spp) on the CPU: every
    backward round makes exactly one small-table backward dispatch (one
    launch on the card), make_bsdf's look-up, with the five trainable
    per-mesh tables (rho_d, rho_s, tau of 3 values, eta, alpha of 1) of
    the scene's mesh count."""
    import os

    from nart_tpu_torch import bench

    root = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")
    sc = tscene.load_scene(os.path.join(root, "macbeth.json"),
                           asset_root=root)
    params = trender.RenderParams(image_width=24, image_height=16, spp=1)
    samples = trender.image_samples(24, 16, 24 + 2 * int(np.ceil(
        params.filter_width)), 1, "cpu")
    many = []
    inner = _recording("lut_gather_bwd_many", many)
    try:
        _, grads, _, rounds = tgrad.radiance_weighted_loss_and_grad(
            sc, tgrad.get_params(sc), tca.build_clusters(sc.tri_v.numpy()),
            samples, bench.rgb_cot(1, 24 * 16, "cpu"), params, 24, 16,
            device="cpu", per_round=True)
    finally:
        tsel.lut_gather_bwd_many = inner
    n_mesh = sc.mat_type.shape[0]
    assert rounds > 0
    assert many == [([n_mesh] * 5, [(3,), (3,), (3,), (), ()])] * rounds
    assert float(grads["rho_d_const"].abs().sum()) > 0.0


@pytest.mark.parametrize("bad", ["17 tables", "rows of 5", "65 rows",
                                 "meta device"])
def test_small_table_backward_refusals(bad):
    """lut_gather_bwd_many (and its CUDA wrapper) refuse, before any
    launch and on every device, more than MAX_TABLES tables, rows of more
    than 4 values, tables of more than 64 rows, and a device that is
    neither the card nor the CPU."""
    idx = torch.zeros(8, dtype=torch.int64)
    g3 = torch.ones(8, 3)
    grads, rows = {
        "17 tables": ([g3] * (tsel.MAX_TABLES + 1), [4] * 17),
        "rows of 5": ([g3, torch.ones(8, 5)], [4, 4]),
        "65 rows": ([g3, g3], [4, tsel.AUTO_LUT_ROWS + 1]),
        "meta device": ([g3.to("meta")], [4]),
    }[bad]
    if bad == "meta device":
        idx = idx.to("meta")
    cuda_build.reset_launch_counts()
    for fn in (tsel.lut_gather_bwd_many, tsel.lut_gather_bwd_many_cuda):
        with pytest.raises(ValueError):
            fn(grads, idx, rows)
    assert not any(cuda_build.launch_counts.values())
