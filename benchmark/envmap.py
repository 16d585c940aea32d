"""Environment maps the benchmark makes where a configuration's published
map is not in the repository: made from a fixed seed at the published
map's size, so that every run and both sides (the program and the
reference) read the same texels, as a model's weights are made from a
seed at its published widths.

``garage`` is an indoor car park in latitude-longitude layout (row 0 the
zenith, as nart's environment light reads it): a dim concrete ambient
that varies slowly, rows of bright fluorescent tubes on the ceiling, and
a few openings to daylight at the horizon.  Its dynamic range (ambient
~0.05-0.3, tubes ~20-60) is what makes importance sampling matter."""

import numpy as np


def garage(width, height, seed, tubes=48, openings=3):
    """float32 (height, width, 3), every value a half float."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(height, dtype=np.float64) + 0.5) / height * np.pi
    phi = (np.arange(width, dtype=np.float64) + 0.5) / width * 2.0 * np.pi
    th, ph = theta[:, None], phi[None, :]
    # slow variation: a few low-order waves over the sphere
    wave = np.zeros((height, width))
    for _ in range(8):
        kt, kp = rng.integers(1, 5), rng.integers(1, 7)
        a, b, c = rng.uniform(0, 2 * np.pi, 3)
        wave += np.cos(kt * th + a) * np.cos(kp * ph + b) * rng.uniform(
            0.3, 1.0) + 0.1 * np.sin(c)
    wave = (wave - wave.min()) / (wave.max() - wave.min())
    ambient = 0.05 + 0.25 * wave
    up = th < 0.5 * np.pi
    tint = np.where(up[..., None], np.array([1.0, 0.98, 0.95]),
                    np.array([0.9, 0.85, 0.8]) * 0.6)
    img = ambient[..., None] * tint
    # daylight through openings near the horizon
    for _ in range(openings):
        p0 = rng.uniform(0, 2 * np.pi)
        dp = rng.uniform(0.3, 0.7)
        rows = (th > 0.5 * np.pi - 0.18) & (th < 0.5 * np.pi + 0.03)
        cols = ((ph - p0) % (2 * np.pi)) < dp
        img = np.where((rows & cols)[..., None],
                       rng.uniform(4.0, 9.0) * np.array([0.85, 0.93, 1.0]),
                       img)
    # fluorescent tubes: thin bright strips on the ceiling
    for _ in range(tubes):
        t0 = rng.uniform(0.08, 0.42) * np.pi
        p0 = rng.uniform(0, 2 * np.pi)
        dt = rng.uniform(0.004, 0.01) * np.pi
        dp = rng.uniform(0.06, 0.2)
        r0, r1 = np.searchsorted(theta, [t0, t0 + dt])
        c = np.nonzero(((phi - p0) % (2 * np.pi)) < dp)[0]
        level = rng.uniform(20.0, 60.0)
        color = np.array([1.0, rng.uniform(0.95, 1.0), rng.uniform(0.85, 1.0)])
        img[r0:max(r1, r0 + 1), c] = level * color
    return img.astype(np.float32).astype(np.float16).astype(np.float32)
