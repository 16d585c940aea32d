"""nart_tpu_torch.select (small-table look-ups) vs nart_tpu.select.

The same numpy inputs through the JAX package's one-hot look-ups (on the
CPU) and the port's: forward values exactly (a look-up copies a row), the
vector-Jacobian products to rtol 1e-5 / atol 1e-6 (the per-row sums run in
another order: the one-hot product's transpose there, a serial sum per row
here), int and bool tables exactly, indices below 0 and from n up clamped.
materials.make_bsdf's five per-mesh table gradients (mesh_lookup) against
the JAX make_bsdf's (mesh_luts) at rtol 1e-5.  A float look-up is the
autograd Function _LutGather on every device; on the CPU its forward and
backward run their plain versions.  The kernels (csrc/small_lut.cu) against them on the card are in
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
from nart_tpu_torch import cuda_build
from nart_tpu_torch import materials as tm
from nart_tpu_torch import scene as tscene
from nart_tpu_torch import select as tsel
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
    """Forward exact, VJP to rtol 1e-5 / atol 1e-6; n = 65 takes auto_lut's
    plain gather on both sides, small_lut's one-hot (JAX) and look-up
    (here) at any n."""
    g = np.random.default_rng(n * 10 + (width or 1))
    shape = (n,) if width is None else (n, width)
    table = g.normal(size=shape).astype(np.float32)
    idx = _indices(n, g)
    cot = g.normal(size=(LANES,) + shape[1:]).astype(np.float32)

    jlut = getattr(jsel, fn)(jnp.asarray(idx.astype(np.int32)), n)
    out_j, vjp = jax.vjp(jlut, jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot))

    tt = torch.from_numpy(table).requires_grad_()
    out_t = getattr(tsel, fn)(torch.from_numpy(idx), n)(tt)
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
