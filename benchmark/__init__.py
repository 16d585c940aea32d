"""The benchmark of the PyTorch and CUDA port (nart_tpu_torch).

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) on the card:

    python3 benchmark/run.py --workload macbeth.train --seed 7 \
        --seconds 40 --trace 0

Everything the yardstick needs lives here and nowhere in the program:
the frozen scenes (scenes/) and the files made for them (assets.py,
envmap.py, exrfile.py), the configurations (configs/<name>.json),
the traffic mixes (traffic/<name>.json), the per-layer metric readers
(metrics/<name>.py), the trace reduction (trace.py), the table of peaks
and of each hand kernel's bytes (roofline.py), the clock arithmetic
(stats.py), each configuration's plain reference (reference/) and the
comparison that decides ``correct`` (correct.py).  Each configuration,
traffic mix and metric is found by its name in BENCHMARK.json, so a
later change adds a cell by adding files and entries.  Nothing here
imports jax or the JAX package; the program is driven through its public
entries only.
"""
