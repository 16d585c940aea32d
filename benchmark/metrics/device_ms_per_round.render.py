"""Busy device milliseconds a round of the traced render units."""

from benchmark import readers


def read(summary):
    return readers.device_ms_per_round(summary, "render")
