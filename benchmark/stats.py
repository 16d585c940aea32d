"""The clock arithmetic of the end-to-end metrics."""

import statistics


def rate_m(units, samples_per_unit, window_s):
    """Millions of pixel-samples a second: every sample of the units
    finished in the window over the whole window."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return units * samples_per_unit / window_s / 1e6


def percentile(values, q):
    """The q-th percentile (0 < q < 100) of every value, by linear
    interpolation between the closest ranks (statistics.quantiles'
    "inclusive" method); of one value, that value."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q) - 1]

