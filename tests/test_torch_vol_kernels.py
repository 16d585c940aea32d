"""The volume's flight-step kernels (nart_tpu_torch/csrc/vol_step.cu: V1
nart_vol_steps, V2 nart_vol_steps_bwd) against their plain versions, on
the card.

Marked ``gpu``: each test skips (with its reason) when no CUDA device is
present, deciding inside the fixture, never at import.  Run them on a
machine with a card with ``python -m pytest tests/test_torch_vol_kernels.py``.
On testing.vol_lane_set's lanes (every branch of a step; the null event
at p_null = 0 and near the majorant): V1's every output the plain steps'
bits on every lane for k = 1, 2 and 4, also from a CUDA graph's replay;
V2 within rtol 1e-5 / atol 1e-6 of the float64 VJP of the plain steps on
every lane, and its torch twin's (flight_steps_vjp_plain) reverse pass
within the same; V1 and V2 their first designs' (nart_vol_steps_ref,
nart_vol_steps_bwd_ref) bits on every lane; V1's segment starts added
into an accumulator, also at each replay of a graph; the Function
(vol_ops.flight_steps) launches V1 once a call and V2 once a backward,
its leaves' gradients within rtol 1e-5 / atol 1e-6 of float64 autograd;
a step count above MAX_STEPS, a direction that requires grad and a cell
table not 32-byte aligned (the redesign's two 16-byte loads a row) are
refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nart_tpu_torch import cuda_build, media, testing, vol_ops

pytestmark = pytest.mark.gpu

N = 4096
RTOL, ATOL = 1e-5, 1e-6
GRADS = ("g_beta", "g_l", "rows", "idx", "p_sa", "p_ss", "p_le")


@pytest.fixture(scope="module")
def lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return testing.vol_lane_set(N, 19, "cuda")


def _args(s):
    m = s["medium"]
    return [getattr(s["vs"], f) for f in vol_ops.FIELDS] + [
        s["cells"], m.sigma_a, m.sigma_s, m.le, m.bounds_min, m.bounds_max,
        s["sigma_maj"]]


def _shape(s):
    return tuple(s["medium"].density.shape)


def _plain(s, k):
    out, died, esc, seg = vol_ops.flight_steps_plain(
        s["vs"], k, s["cells"], s["medium"], s["sigma_maj"], s["bounces"])
    return [getattr(out, f) for f in vol_ops.FIELDS] + [died, esc, seg]


def _same_bits(got, want):
    for name, a, b in zip(list(vol_ops.FIELDS) + ["died", "esc", "seg"],
                          got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("k", [1, 2, 4])
def test_v1_is_the_plain_steps(lanes, k):
    _same_bits(vol_ops.steps_cuda(k, lanes["bounces"], _shape(lanes),
                                  *_args(lanes)), _plain(lanes, k))


def test_v1_from_a_graph_replay(lanes):
    args, shape = _args(lanes), _shape(lanes)
    vol_ops.steps_cuda(4, lanes["bounces"], shape, *args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = vol_ops.steps_cuda(4, lanes["bounces"], shape, *args)
    graph.replay()
    torch.cuda.synchronize()
    _same_bits(outs, _plain(lanes, 4))


@pytest.mark.parametrize("k", [1, 4])
def test_v1_and_v2_are_their_first_designs(lanes, k):
    args, shape, b = _args(lanes), _shape(lanes), lanes["bounces"]
    _same_bits(vol_ops.steps_cuda(k, b, shape, *args),
               vol_ops.steps_ref_cuda(k, b, shape, *args))
    g = (lanes["g_beta"], lanes["g_l"])
    for name, x, y in zip(GRADS, vol_ops.steps_bwd_cuda(k, b, shape, *args,
                                                        *g),
                          vol_ops.steps_bwd_ref_cuda(k, b, shape, *args,
                                                     *g)):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


def test_v1_adds_into_an_accumulator(lanes):
    args, shape, b = _args(lanes), _shape(lanes), lanes["bounces"]
    count = int(vol_ops.steps_cuda(4, b, shape, *args)[-1])
    acc = torch.full((), 5, dtype=torch.int64, device="cuda")
    assert vol_ops.steps_cuda(4, b, shape, *args, seg=acc)[-1] is acc
    assert int(acc) == 5 + count
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        vol_ops.steps_cuda(4, b, shape, *args, seg=acc)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert int(acc) == 5 + 3 * count


@pytest.mark.parametrize("k", [1, 4])
def test_v2_within_the_float64_vjp(lanes, k):
    g = (lanes["g_beta"], lanes["g_l"])
    got = vol_ops.steps_bwd_cuda(k, lanes["bounces"], _shape(lanes),
                                 *_args(lanes), *g)
    vjp = (lanes["cells"], lanes["medium"], lanes["sigma_maj"],
           lanes["bounces"], *g)
    *ref, agree = vol_ops.flight_steps_vjp_reference(lanes["vs"], k, *vjp)
    twin = vol_ops.flight_steps_vjp_plain(lanes["vs"], k, *vjp)
    assert bool(agree.all())
    for name, a, t, r in zip(GRADS, got, twin, ref):
        if name == "idx":
            assert torch.equal(a, r) and torch.equal(t, r)
            continue
        assert bool(torch.isfinite(a).all()), name
        for x in (a, t):
            np.testing.assert_allclose(x.double().cpu().numpy(),
                                       r.cpu().numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_function_launches_and_gradients(lanes):
    """flight_steps on CUDA tensors: one V1 launch forward, one V2 launch
    (and one large-table backward) backward; the gradients of the incoming
    beta and l_out within rtol 1e-5 / atol 1e-6 of float64 autograd of the
    plain steps, those of the density, sigma_a, sigma_s and le (float32
    sums over the lanes) within atol 1e-6 plus rtol 1e-5 times the
    float64 sum of their terms' magnitudes (the look-up kernels' criterion,
    chip_smoke.py phase 24)."""
    m = lanes["medium"]

    def leaves(dtype):
        return [x.detach().to(dtype).requires_grad_() for x in (
            lanes["vs"].beta, lanes["vs"].l_out, m.density, m.sigma_a,
            m.sigma_s, m.le)]

    def grads(run, xs):
        med = dataclasses.replace(m, density=xs[2], sigma_a=xs[3],
                                  sigma_s=xs[4], le=xs[5])
        vs = dataclasses.replace(lanes["vs"], beta=xs[0], l_out=xs[1])
        out, _, _, _ = run(vs, 4, media.pack_density_cells(xs[2]), med,
                           lanes["sigma_maj"], lanes["bounces"])
        return torch.autograd.grad(
            [out.beta, out.l_out], xs,
            [lanes["g_beta"].to(xs[0].dtype), lanes["g_l"].to(xs[0].dtype)])

    cuda_build.reset_launch_counts()
    got = grads(vol_ops.flight_steps, leaves(torch.float32))
    counts = dict(cuda_build.launch_counts)
    assert counts["vol_steps"] == 1 and counts["vol_steps_bwd"] == 1
    assert counts["lut_gather_large_bwd"] == 1
    # the float64 plain steps read the cells by plain indexing (the look-up
    # kernel takes float32 tables)
    want = grads(lambda *a: vol_ops.flight_steps_plain(
        *a, gather=lambda idx, table: table[idx]), leaves(torch.float64))
    # the magnitudes of each sum's terms, from the float64 VJP's lane rows
    # and partials
    *ref, _ = vol_ops.flight_steps_vjp_reference(
        lanes["vs"], 4, lanes["cells"], m, lanes["sigma_maj"],
        lanes["bounces"], lanes["g_beta"], lanes["g_l"])
    row_mag = torch.zeros(lanes["cells"].shape, dtype=torch.float64,
                          device="cuda").index_add_(
        0, ref[3].reshape(-1), ref[2].abs().reshape(-1, 8))
    dens = m.density.detach().double().requires_grad_()
    (dens_mag,) = torch.autograd.grad(media.pack_density_cells(dens), dens,
                                      row_mag)
    mags = (want[0].abs(), want[1].abs(), dens_mag, ref[4].abs().sum(),
            ref[5].abs().sum(), ref[6].abs().sum(0))
    for name, a, b, mag in zip(("beta", "l_out", "density", "sigma_a",
                                "sigma_s", "le"), got, want, mags):
        err = (a.double() - b).abs()
        assert bool((err <= ATOL + RTOL * mag).all()), (name,
                                                        float(err.max()))


def test_refusals(lanes):
    with pytest.raises(ValueError, match="1 to 8"):
        vol_ops.steps_cuda(vol_ops.MAX_STEPS + 1, lanes["bounces"],
                           _shape(lanes), *_args(lanes))
    vs = dataclasses.replace(lanes["vs"],
                             d=lanes["vs"].d.clone().requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        vol_ops.flight_steps(vs, 1, lanes["cells"], lanes["medium"],
                             lanes["sigma_maj"], lanes["bounces"])
    cells = lanes["cells"]
    off = torch.empty(cells.numel() + 1, device="cuda")[1:].view(cells.shape)
    off.copy_(cells)
    args = _args(lanes)
    args[len(vol_ops.FIELDS)] = off
    with pytest.raises(ValueError, match="32-byte aligned"):
        vol_ops.steps_cuda(1, lanes["bounces"], _shape(lanes), *args)
    _same_bits(vol_ops.steps_ref_cuda(1, lanes["bounces"], _shape(lanes),
                                      *args), _plain(lanes, 1))
