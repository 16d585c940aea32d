"""One intra-op thread for the port's CPU tests that compare with JAX.

In a process that has run a JAX CPU computation, the first parallel call
of torch.sqrt on a float32 tensor of 4096 elements now and then comes back
about 12 bits short on the half that an OpenMP worker thread computed
(elements 2048-4095: ATen hands MKL's vmsSqrt 2048-element chunks), while
cos and sin are right and the same call repeated is right.  One call of
torch.sqrt on a few elements first (MKL's first vmsSqrt made on the main
thread alone) prevents it, as does one intra-op thread, with which no
worker computes anything.  A test that holds values computed by torch to
1e-5 against the JAX package can meet it, so every tests/test_torch_*.py
module that imports JAX takes this fixture (and so do the long CPU-only
modules, which one thread runs far faster beside xdist's other workers):

    from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

The reproduction, in fresh processes (the JAX call, then the port's, on
tests/test_torch_rng.py's disk-warp inputs; each process prints one JSON
line, the summary counts the processes whose port result was off):

    python -m tests.test_torch_harness --procs 120 [--warm | --one-thread]
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """torch runs on one intra-op thread for the module's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1


def _child(setup):
    """One process of the reproduction: returns its record."""
    import os

    # tests/conftest.py's 8 virtual devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from nart_tpu import sampling as jsamp

    u = np.random.default_rng(4).random((4096, 2), dtype=np.float32)
    want = np.asarray(jsamp.uniform_sample_disk(jnp.asarray(u)))
    if setup == "warm":
        torch.sqrt(torch.rand(16))
    elif setup == "one-thread":
        torch.set_num_threads(1)
    ut = torch.from_numpy(u)
    u64 = u.astype(np.float64)
    # the port's uniform_sample_disk, one operation at a time
    r = torch.sqrt(ut[:, 0])
    theta = ut[:, 1] * (2.0 * np.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    got = torch.stack([r * c, r * s], -1).numpy()
    th = theta.numpy().astype(np.float64)
    rec = {"threads": torch.get_num_threads(),
           "jax_vs_port": float(np.abs(got - want).max())}
    for name, val, exact in (("sqrt", r, np.sqrt(u64[:, 0])),
                             ("cos", c, np.cos(th)), ("sin", s, np.sin(th))):
        err = np.abs(val.numpy() - exact)
        bad = np.nonzero(err > 1e-5)[0]
        rec[name] = [int(len(bad)), float(err.max()),
                     int(bad.min()) if len(bad) else -1,
                     int(bad.max()) if len(bad) else -1]
    again = np.abs(torch.sqrt(ut[:, 0]).numpy() - np.sqrt(u64[:, 0])).max()
    rec["sqrt_again"] = float(again)
    return rec


def main(argv=None):
    import argparse
    import json
    import os
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=120)
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--warm", action="store_const", dest="setup",
                    const="warm", default="none")
    ap.add_argument("--one-thread", action="store_const", dest="setup",
                    const="one-thread")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.setup)))
        return 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "tests.test_torch_harness", "--child"]
    if args.setup != "none":
        cmd.append("--" + args.setup)

    def one(_):
        out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             check=True, timeout=300).stdout
        return json.loads(out.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        recs = list(pool.map(one, range(args.procs)))
    off = [r for r in recs if r["jax_vs_port"] > 1e-5]
    for r in off:
        print(json.dumps(r))
    print(f"setup {args.setup}: {len(off)} of {len(recs)} processes off by "
          "more than 1e-5; sqrt off in "
          f"{sum(1 for r in recs if r['sqrt'][0])}, cos in "
          f"{sum(1 for r in recs if r['cos'][0])}, sin in "
          f"{sum(1 for r in recs if r['sin'][0])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
