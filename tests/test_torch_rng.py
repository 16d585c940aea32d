"""nart_tpu_torch rng + sampling vs nart_tpu: bit-exact streams.

Inputs are made with numpy and handed to both packages; RNG states,
Latin-square samples and stream seeds must match bit for bit.  The warps
go through sin/cos/arccos, whose last bit differs between the two
libraries' implementations, so they are held to rtol 1e-5 / atol 2e-6.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import rng as jrng
from nart_tpu import sampling as jsamp
from nart_tpu.integrators import path as jpath
from nart_tpu_torch import rng as trng
from nart_tpu_torch import sampling as tsamp
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

EDGE_STATES = np.array(
    [0, 1, 7, 123456, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_next_float_stream_bit_exact():
    seeds = np.concatenate(
        [EDGE_STATES,
         np.random.default_rng(0).integers(0, 2**32, 256, dtype=np.uint32)])
    yj = jrng.seed(jnp.asarray(seeds))
    yt = trng.seed(_t(seeds))
    for _ in range(40):
        fj, yj = jrng.next_float(yj)
        ft, yt = trng.next_float(yt)
        np.testing.assert_array_equal(np.asarray(yj).astype(np.int64),
                                      yt.numpy())
        np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


def test_raw_states_edge_cases():
    """States (not seeds) at the uint32 edges, including 0xFFFFFFFF."""
    y = EDGE_STATES
    fj, yj = jrng.next_float(jnp.asarray(y))
    ft, yt = trng.next_float(_t(y))
    np.testing.assert_array_equal(np.asarray(yj).astype(np.int64), yt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


@pytest.mark.parametrize("max_inclusive", [0, 1, 5, 63, 1023, 9999, 65535])
def test_next_int32_bit_exact(max_inclusive):
    seeds = np.concatenate(
        [EDGE_STATES,
         np.random.default_rng(max_inclusive).integers(
             0, 2**32, 128, dtype=np.uint32)])
    yj, yt = jnp.asarray(seeds), _t(seeds)
    for _ in range(8):
        vj, yj = jrng.next_int32(yj, jnp.uint32(max_inclusive))
        vt, yt = trng.next_int32(yt, max_inclusive)
        np.testing.assert_array_equal(np.asarray(vj).astype(np.int64),
                                      vt.numpy())
        assert (vt >= 0).all() and (vt <= max_inclusive).all()


def test_masked_draw_preserves_state():
    y0 = trng.seed(torch.arange(4))
    mask = torch.tensor([True, False, True, False])
    _, y1 = trng.masked_next_float(y0, mask)
    assert (y1[1::2] == y0[1::2]).all()
    assert (y1[0::2] != y0[0::2]).all()


def test_path_stream_seed_near_2_32():
    ids = np.concatenate([
        np.arange(2**32 - 300, 2**32, dtype=np.uint64),
        np.arange(0, 300, dtype=np.uint64),
        np.array([2**31 - 1, 2**31, 0x85EBCA6B], np.uint64),
    ]).astype(np.uint32)
    want = np.asarray(jpath._path_stream_seed(jnp.asarray(ids)))
    got = tpath._path_stream_seed(_t(ids)).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_latin_square_bit_exact(n):
    seeds = np.array([0, 17, 999, 2**32 - 1, 123456789], np.uint32)
    sj, yj = jsamp.latin_square(jrng.seed(jnp.asarray(seeds)), n)
    st, yt = tsamp.latin_square(trng.seed(_t(seeds)), n)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(yj).astype(np.int64), yt.numpy())


def _u2(n, seed=0):
    return np.random.default_rng(seed).random((n, 2), dtype=np.float32)


@pytest.mark.parametrize("warp", ["disk", "ring", "sphere", "cosine"])
def test_warps_match(warp):
    u = _u2(4096, seed=len(warp))
    uj, ut = jnp.asarray(u), torch.from_numpy(u)
    if warp == "disk":
        pairs = [(jsamp.uniform_sample_disk(uj), tsamp.uniform_sample_disk(ut))]
    elif warp == "ring":
        (xj, pj), (xt, pt) = (jsamp.uniform_sample_ring(uj, np.float32(0.3)),
                              tsamp.uniform_sample_ring(ut, 0.3))
        pairs = [(xj, xt), (pj, pt)]
    elif warp == "sphere":
        (wj, pj), (wt, pt) = (jsamp.uniform_sample_sphere(uj),
                              tsamp.uniform_sample_sphere(ut))
        pairs = [(wj, wt), (pj, pt)]
    else:
        (wj, pj), (wt, pt) = (jsamp.cosine_sample_hemisphere(uj),
                              tsamp.cosine_sample_hemisphere(ut))
        pairs = [(wj, wt), (pj, pt)]
    for a, b in pairs:
        # sin/cos differ by an ulp between the libraries; the hemisphere's
        # z = sqrt(1 - r^2) amplifies that near the horizon
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=2e-6)


def test_package_imports_without_jax():
    """The port must import on a machine with no JAX at all."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import nart_tpu_torch.render, nart_tpu_torch.cluster_accel, "
            "nart_tpu_torch.grad, nart_tpu_torch.kernel_stats; "
            "assert 'nart_tpu' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
