"""The readings that set the comparison's limits (correct.LIMITS), at a
cell's own size on the card, in one process: for each seed the
program's numbers against the reference (the lower readings: sound
runs), and for each control seed the control's (reference/control.py:
the upper readings).

    python3 -m benchmark.calibrate --workload macbeth.train \
        --seeds 1,2,3 --control-seeds 1,2,3 [--out readings.jsonl]

The program answers as a run does: its set-up units and one unit more,
as the window's last (a render cell keeps its image: every unit makes
the same one).  One JSON line a reading, with the seconds the reference
took.  --survey SEEDS: for a train cell, the rounds the program's
forward machine measures on every chunk of the sequence, against the
capacity the kept replay machine takes from the first chunk (a chunk
that needs more is cut; PERF.md, Open questions)."""

import argparse
import json
import sys
import time

import torch

from . import cells, correct, spec
from .reference import control


def program_numbers(cell, seed, device, size=None):
    """(correct.numbers of a run's kept answers, the reference's seconds,
    the worst leaf of each kept step)."""
    prog = cells.Program(cell, seed, device, size)
    prog.set_up(cell.traffic["set_up_units"])
    prog.unit()
    prog.keep_last()
    answers = prog.answers()
    prog.close()
    t0 = time.perf_counter()
    want = correct.reference_answers(cell, seed, answers, device, size)
    ref_s = time.perf_counter() - t0
    worst = [max(correct.leaf_gaps(g, g_ref).items(), key=lambda kv: kv[1])
             for (_, _, g), (_, g_ref) in zip(answers, want)] \
        if cell.traffic["mode"] == "train" else []
    return (correct.numbers(cell.traffic["mode"], answers, want), ref_s,
            [[str(p), v] for p, v in worst])


def half_batch(cell, seed, device):
    """program_numbers with half of the batch left out and the mean taken
    over the rest, planted in the program: a train step's cotangent 0 on
    its second half of pixels and 2 on the first; a render's film splat
    of the first half of its samples (the film then takes their mean)."""
    from nart_tpu_torch import film, grad

    orig_step, orig_splat = grad.radiance_weighted_loss_and_grad, \
        film.splat_grid

    def step(scene, theta, accel, samples, cot, *args, **kw):
        n = cot.shape[1]
        cot = cot.clone()
        cot[:, n // 2:] = 0.0
        cot[:, :n // 2] *= 2.0
        return orig_step(scene, theta, accel, samples, cot, *args, **kw)

    def splat(buf, jitter, la, *args):
        h = max(jitter.shape[0] // 2, 1)
        return orig_splat(buf, jitter[:h], la[:h], *args)

    grad.radiance_weighted_loss_and_grad, film.splat_grid = step, splat
    try:
        return program_numbers(cell, seed, device)
    finally:
        grad.radiance_weighted_loss_and_grad = orig_step
        film.splat_grid = orig_splat


def survey(cell, seed, device):
    """{"capacity", "rounds": [the forward's rounds on each chunk]}."""
    from nart_tpu_torch.integrators import path
    from nart_tpu_torch.replay import pad_rounds

    prog = cells.Program(cell, seed, device)
    rounds = []
    machines = {}
    for i in range(prog.n_chunks):
        base = i * prog.k
        rounds.append(path.trace_balanced(
            prog.sess.scene, prog.sess.accel,
            prog.samples[base:base + prog.k], prog.params, prog.width,
            prog.height, chunk_base=base, machines=machines)[2])
    first = rounds[prog.draws.first_chunk]
    prog.close()
    return {"capacity": pad_rounds(first), "first": first,
            "max": max(rounds), "rounds": rounds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--survey", default="")
    ap.add_argument("--half-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    lines = []

    def emit(rec):
        rec.update(workload=args.workload,
                   kind=torch.cuda.get_device_name(device))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    for s in [int(x) for x in args.seeds.split(",") if x]:
        nums, ref_s, worst = program_numbers(cell, s, device)
        emit({"who": "program", "seed": s, "numbers": nums,
              "reference_s": ref_s, "worst_leaf_each_step": worst})
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t0 = time.perf_counter()
        nums = control.control_numbers(cell, s, device)
        emit({"who": "control", "seed": s, "numbers": nums,
              "seconds": time.perf_counter() - t0})
    for s in [int(x) for x in args.half_seeds.split(",") if x]:
        nums, ref_s, _ = half_batch(cell, s, device)
        emit({"who": "half_batch", "seed": s, "numbers": nums})
    for s in [int(x) for x in args.survey.split(",") if x]:
        emit({"who": "survey", "seed": s, **survey(cell, s, device)})
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
