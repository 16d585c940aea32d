"""One run of one cell of BENCHMARK.json on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up loads the program and the cell's frozen scene, draws the inputs
from the seed and runs the traffic's set-up units (which capture the
program's CUDA graphs); setup_s runs from the process's start to the end
of set-up.  The window then runs units back to back for --seconds (closed
loop: the next unit starts when the last one is synchronised): the rate
is every pixel-sample of the units finished over the whole window, the
95th percentile that of every unit's latency.  With --trace 1 a few more
units run under torch.profiler and the line carries the cell's per-layer
metrics (metrics/<name>.py) in place of the end-to-end ones.  Then the
program's state is freed and the plain reference (reference/) works out
the kept answers again; correct.py decides ``correct``.

The last line of standard output is the result's JSON; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key, "checks".  The run exits non-zero with no result
where there is no card, fewer cards than the cell asks for, no program,
or where jax, jaxlib, flax or the JAX package was loaded.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every build and kernel cache the program or torch may write, at fixed
# paths inside the checkout (the program's own kernels build into its
# build/nart_tpu_torch)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "bench", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "bench", "triton"))


def process_age_s():
    """Seconds since this process started (/proc's start time, in clock
    ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def power_limit_w(device_index):
    """nvidia-smi's power limit of the card, in watts (None where it gives
    none)."""
    import torch

    uuid = str(torch.cuda.get_device_properties(device_index).uuid)
    uuid = uuid if uuid.startswith("GPU-") else "GPU-" + uuid
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={uuid}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.strip()
        return float(out)
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def end_to_end(mode, units, samples_per_unit, window_s, latencies,
               setup_s):
    """The end-to-end metrics a mode computes, by name."""
    from benchmark import stats

    rate = stats.rate_m(units, samples_per_unit, window_s)
    p95 = 1e3 * stats.percentile(latencies, 95)
    return {"setup_s": setup_s, f"{mode}_Msamples_per_s": rate,
            ("render_ms_p95" if mode == "render" else "train_step_ms_p95"):
            p95}


def run_cell(cell, seed, seconds, traced, device, size=None, t0=None):
    """Run a cell once on `device` and return the result's dict (size:
    the CPU tests' smaller image; t0: a perf_counter reading to take
    set-up from, in place of the process's start)."""
    import torch

    from benchmark import cells, correct, spec, trace

    tr = cell.traffic
    prog = cells.Program(cell, seed, device, size)
    prog.set_up(tr["set_up_units"])
    setup_s = (process_age_s() if t0 is None
               else time.perf_counter() - t0)

    latencies = []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        a = time.perf_counter()
        prog.unit()
        b = time.perf_counter()
        latencies.append(b - a)
        if b >= deadline:
            break
    window_s = b - start
    prog.keep_last()
    values = end_to_end(prog.mode, len(latencies), prog.samples_per_unit,
                        window_s, latencies, setup_s)
    median = sorted(latencies)[len(latencies) // 2]
    print(f"# window: {len(latencies)} units of {prog.samples_per_unit} "
          f"samples in {window_s} s, median {median} s; set-up {setup_s} s",
          file=sys.stderr, flush=True)

    summary = None
    if traced:
        events, rounds = trace.profile_units(prog.unit, prog.spans,
                                             tr["traced_units"], device)
        summary = trace.summarize(
            events, prog.mode, tr["traced_units"], rounds, prog.lanes,
            {k: v for k, v in cell.config.get("kernel_ops_per_lane",
                                              {}).items() if k != "why"})
        every = sum(d for act, _, _, d in events if act == "device")
        print(f"# traced: {len(summary.device_ops)} device operations in "
              f"the window, {summary.busy_s} s busy of {summary.window_s} "
              f"s; {every * 1e-9} s of device time traced in all",
              file=sys.stderr, flush=True)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    answers = prog.answers()
    prog.close()
    del prog
    ref_answers = correct.reference_answers(cell, seed, answers, device,
                                            size)
    ok, checks = correct.verdict(
        correct.numbers(tr["mode"], answers, ref_answers))

    metrics = {}
    if summary is None:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w(device.index or 0)
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": ok, "attempted": len(latencies), "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import nojax, spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import nart_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program is not here ({e})", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0))
    bad = nojax.forbidden_modules()
    if bad:
        print(f"error: modules loaded that the benchmark forbids: {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
