"""nart_tpu_torch.sharding's gradients against the JAX package's, on the
CPU.

The virtual ranks of several Layouts each replay their (strips, sample
slab) block of one chunk (radiance_weighted_loss_and_grad_shard); their
losses and gradients summed are held against
``nart_tpu.grad.radiance_weighted_loss_and_grad`` on the same scene,
samples and cotangent with tests/test_torch_grad.py's tolerances (loss rtol
1e-4, leaves rtol 1e-3 / atol 1e-5).  simple_scene at 8x8, 2 spp, 3
bounces, 16 work slots; the JAX side traces with its brute-force
intersector.
"""

import jax
import jax.numpy as jnp
import numpy as np

from nart_tpu import grad as jgrad
from nart_tpu import render as jrender
from nart_tpu import testing as jtesting
from nart_tpu_torch import sharding as tsharding
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_sharding import (GH, GW, LANES, _gparams,
                                       _grad_inputs, _leaves, _shards_summed)


def test_sharded_gradients_match_jax():
    ts, acc, samples, cot = _grad_inputs()
    sj = jax.tree_util.tree_map(jnp.asarray,
                                jtesting.simple_scene(("lambert",)))
    jp = _gparams(jrender, accel="brute")
    loss_j, grads_j, _, _ = jgrad.radiance_weighted_loss_and_grad(
        sj, jgrad.get_params(sj), None, jnp.asarray(samples.numpy()),
        jnp.asarray(cot.numpy()), jp, GW, GH, lanes=LANES)
    want = _leaves(jax.tree_util.tree_map(np.asarray, grads_j))
    assert np.abs(np.asarray(grads_j["rho_d_const"])).sum() > 0
    for shape in ((2, 1), (2, 2), (4, 2)):
        loss, grads = _shards_summed(tsharding.Layout(*shape), ts, acc,
                                     samples, cot)
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-4)
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)
