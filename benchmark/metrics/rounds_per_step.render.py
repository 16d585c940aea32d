"""Rounds a render unit ran, as the program reports them."""

from benchmark import readers


def read(summary):
    return readers.rounds_per_step(summary, "render")
