"""The lower-precision control of the comparison: the reference put in
the program's place with each path's carry (throughput, radiance,
roughening factor, ray) stored in bfloat16 after every bounce (the
configurations state float32, and no operation of theirs uses a tensor
core, so TF32 would change nothing: the step below is bfloat16), compared
with the reference by correct.numbers.  Its numbers must fail the limits
(correct.LIMITS): PERF.md gives its readings on the card at each cell's
own size, and benchmark/tests/test_bench_faults.py holds it at a small
size on the CPU."""

import torch

from .. import cells, correct

CONTROL_DTYPE = torch.bfloat16


def answers(cell, seed, device, size=None, carry_dtype=None, bases=None):
    """The answers a run keeps, worked out by the reference (carry_dtype:
    the control's), in the program's answers' form; a train cell's steps
    are those of its set-up (or `bases`)."""
    tr = cell.traffic
    if tr["mode"] == "render":
        return correct.reference_answers(cell, seed, None, device, size,
                                         carry_dtype)
    if bases is None:
        d = cells.draws(cell, seed)
        n = cells.n_chunks(cell.config, tr)
        bases = [(d.first_chunk + i) % n * tr["spp_per_unit"]
                 for i in range(tr["set_up_units"])]
    steps = correct.reference_answers(
        cell, seed, [(b, None, None) for b in bases], device, size,
        carry_dtype)
    return [(b, loss, g) for b, (loss, g) in zip(bases, steps, strict=True)]


def control_numbers(cell, seed, device, size=None):
    """correct.numbers of the control against the reference."""
    got = answers(cell, seed, device, size, CONTROL_DTYPE)
    want = answers(cell, seed, device, size)
    if cell.traffic["mode"] != "render":
        want = [(loss, g) for _, loss, g in want]
    return correct.numbers(cell.traffic["mode"], got, want)
