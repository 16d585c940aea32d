"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX
package, compared by whole top-level names; the reference loads nothing
of the program either."""

import os
import subprocess
import sys

from benchmark import nojax, spec


def test_top_level_names_are_compared_whole():
    assert nojax.forbidden_modules(
        ["nart_tpu_torch", "nart_tpu_torch.grad", "jaxtyping", "flaxen",
         "numpy"]) == []
    assert nojax.forbidden_modules(["nart_tpu", "nart_tpu.render"]) == \
        ["nart_tpu"]
    assert nojax.forbidden_modules(["jax._src.api", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def _modules_after(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.split()


def test_a_run_loads_no_jax():
    """A whole CPU run of a cell (tiny) through the harness, the program
    and the reference: no forbidden module in the process after it."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import nojax, spec\n"
        "from benchmark.run import run_cell\n"
        "cell = spec.Cell(spec.load_benchmark(), 'macbeth.render')\n"
        "run_cell(cell, 5, 0.01, 1, torch.device('cpu'), size=(8, 4))\n"
        "print(' '.join(nojax.forbidden_modules()) or 'none')\n"
        "print('nart_tpu_torch' in sys.modules)\n")
    assert _modules_after(code) == ["none", "True"]


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.reference.ref, benchmark.reference.control\n"
        "import benchmark.correct\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'nart_tpu_torch', 'nart_tpu', 'jax'}) or 'none')\n")
    assert _modules_after(code) == ["none"]
    here = os.path.join(spec.HERE, "reference")
    for dirpath, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(("import ", "from ")):
                            assert "nart_tpu" not in s, (f, s)
                            assert "jax" not in s, (f, s)
