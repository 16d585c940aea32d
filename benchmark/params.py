"""The inputs a run draws from its seed, handed alike to the program and
to the reference: a factor for every trainable leaf the configuration
lists (configs/<name>.json's "leaves", in that order), the first sample
chunk of a train cell, and the unit whose answer a render cell keeps for
the comparison.

A leaf's factor is drawn uniformly in [0.9, 1.1], so each seed gives
other images and other gradients.
"""

import numpy as np

LOW, HIGH = 0.9, 1.1
DRAWN_UNITS = 32  # a render cell keeps the answer of a unit drawn below


def leaves(theta, path=()):
    """(path, tensor) of every leaf of a parameter dict (as the program's
    and the reference's get_params give it) in a fixed order: keys as
    given, lists by index, nested dicts by key; None entries skipped."""
    if isinstance(theta, dict):
        for k, v in theta.items():
            yield from leaves(v, path + (k,))
    elif isinstance(theta, (list, tuple)):
        for i, v in enumerate(theta):
            yield from leaves(v, path + (i,))
    elif theta is not None:
        yield path, theta


def _rebuild(theta, fn, path=()):
    if isinstance(theta, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in theta.items()}
    if isinstance(theta, (list, tuple)):
        return [_rebuild(v, fn, path + (i,)) for i, v in enumerate(theta)]
    return None if theta is None else fn(path, theta)


class Draws:
    """What one seed draws, in this order: the leaves' factors (by
    path), the first chunk of a sequence of n_chunks, the kept unit."""

    def __init__(self, seed, paths, n_chunks):
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        self.factors = {tuple(p): float(np.float32(rng.uniform(LOW, HIGH)))
                        for p in paths}
        self.first_chunk = int(rng.integers(0, n_chunks))
        self.kept_unit = int(rng.integers(0, DRAWN_UNITS))

    def scaled(self, theta):
        """theta with each leaf times its factor (a leaf the draws do not
        name is refused)."""
        def scale(path, x):
            if path not in self.factors:
                raise KeyError(f"no factor drawn for leaf {path}")
            return x * self.factors[path]
        return _rebuild(theta, scale)
