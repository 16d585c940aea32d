"""The check that nothing of JAX, or of the JAX package beside the
program, was loaded into the process: module names compared by their
whole top-level name (the part before the first dot), so the program,
nart_tpu_torch, passes and nart_tpu fails."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nart_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (sys.modules' keys by
    default), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
