"""The round runner: a work-queue machine's rounds, k to each host check.

Counterpart of the device-side ``lax.while_loop`` in which the JAX package
runs a machine's rounds (``nart_tpu/integrators/path.py:974``,
``volume.py:570``) inside the one compiled program per chunk shape that
``render._trace_balanced_jit`` caches.  ``RoundRunner.run(core0)`` runs a
round function on a machine's carry until no lane is alive:

  * on a CUDA device, the runner's first call runs the chunk's first round
    eagerly on a side stream (so that what a round builds on first use --
    the kernels' library, cached tables -- is built outside a capture),
    then captures the next k rounds into one ``torch.cuda.CUDAGraph`` over
    a static copy of the carry.  The graph ends by copying its last
    round's carry back into that copy, so each replay's outputs are the
    next replay's inputs; between replays the host reads one device flag,
    "is any lane alive?".  A later call (the next chunk of a render)
    copies its own first carry in and replays the same graph.
  * on the CPU the same schedule runs eagerly, with no graph: k rounds,
    then the check.
  * ``graph=False, k=1`` is the per-round loop: one round per check,
    eagerly, on any device.

The round count is kept on the device: each round adds ``alive.any()`` of
its incoming carry, as the JAX carry counts its rounds, so the count stays
exact when the last k rounds run past the end.  A round in which no lane
is alive changes no field of the carry, pulls no work item and adds only
zeros to rows no item owns (the machines hold to this, and
tests/test_torch_rounds.py checks it), so such a dead round changes
nothing but costs what a live round costs: at most k - 1 of them run a
call.  ``max_rounds`` gates each round on the device count, which keeps
the volume's MAX_STEPS cut exact.

A failed capture or replay raises.  Whether the rounds run eagerly is
decided by the device, or by the caller's route (integrators/path.py
names the routes that never capture), never by an error.
"""

from __future__ import annotations

import gc
import time
from dataclasses import fields, is_dataclass, replace

import torch

from . import cluster_accel

# rounds per host check (k): from a chip sweep of k = 4, 8, 16 on macbeth
# at 1280x720 (PERF.md, section 6)
ROUNDS_PER_CHECK = 4


def carry_tensors(x):
    """The tensors of a carry in a fixed order: tuples and dataclasses
    (Paths, VolState, IsectList) walked field by field."""
    if torch.is_tensor(x):
        return [x]
    if is_dataclass(x):
        return [t for f in fields(x) for t in carry_tensors(getattr(x, f.name))]
    return [t for v in x for t in carry_tensors(v)]


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if is_dataclass(x):
        return replace(x, **{f.name: _clone(getattr(x, f.name))
                             for f in fields(x)})
    return tuple(_clone(v) for v in x)


def _copy_into(dst, src):
    for a, b in zip(carry_tensors(dst), carry_tensors(src), strict=True):
        a.copy_(b)


class RoundRunner:
    """Runs `round_fn(core) -> core'` from a first carry until no lane of
    ``core[0].alive`` is alive, k rounds to each host check (see the
    module's docstring).  round_fn may write the caller's buffers in place
    (the radiance rows); on a CUDA device with ``graph`` on, those writes
    are part of the graph.  One runner serves one chunk shape: every call's
    carry has the first call's shapes and dtypes."""

    def __init__(self, round_fn, k=None, max_rounds=None, graph=True):
        self.round_fn = round_fn
        self.k = ROUNDS_PER_CHECK if k is None else k
        self.max_rounds = max_rounds
        self.graph_on = graph
        self.carry = None  # the graph's static carry
        self.rounds = None  # () int64 on the device: live rounds of a call
        self.flag = None  # () bool on the device: is any lane alive?
        self.graph = None
        self.launches = {}  # traversal launches of one replay
        self.captures = 0
        self.capture_s = 0.0  # warm-up round excluded
        self.replays = 0
        self.rounds_run = 0  # rounds the device ran, live and dead

    def _round(self, core):
        """One round of core, gated by max_rounds and counted on the
        device."""
        alive = core[0].alive
        if self.max_rounds is not None:
            alive = alive & (self.rounds < self.max_rounds)
            core = (replace(core[0], alive=alive),) + tuple(core[1:])
        self.rounds.add_(alive.any())
        return self.round_fn(core)

    def _live(self, core):
        live = core[0].alive.any()
        if self.max_rounds is not None:
            live = live & (self.rounds < self.max_rounds)
        return live

    def run(self, core0):
        """Run the rounds from core0: returns (the last carry, the round
        count as a () int64 tensor on the carry's device).  On the graphed
        route the carry returned is the runner's static copy, which the
        next call overwrites."""
        dev = core0[0].alive.device
        if self.rounds is None:
            self.rounds = torch.zeros((), dtype=torch.int64, device=dev)
        self.rounds.zero_()
        if dev.type == "cuda" and self.graph_on:
            return self._run_graphed(core0), self.rounds
        core = core0
        while bool(self._live(core)):
            for _ in range(self.k):
                core = self._round(core)
            self.rounds_run += self.k
        return core, self.rounds

    def _run_graphed(self, core0):
        if self.carry is None:
            self.carry = _clone(core0)
            self.flag = torch.zeros((), dtype=torch.bool,
                                    device=self.rounds.device)
        else:
            _copy_into(self.carry, core0)
        self.flag.copy_(self._live(self.carry))
        if self.graph is None:
            if not bool(self.flag):
                return self.carry
            self._capture()
        while bool(self.flag):
            self.graph.replay()
            self.replays += 1
            self.rounds_run += self.k
            for name, n in self.launches.items():
                cluster_accel.launch_counts[name] += n
        return self.carry

    def _capture(self):
        dev = self.rounds.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the chunk's first round, eagerly: it builds what a round
            # builds on first use before anything is captured
            _copy_into(self.carry, self._round(self.carry))
            self.flag.copy_(self._live(self.carry))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.rounds_run += 1
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        cluster_accel.reset_captured_launches()
        # a graph that dies during a capture (cyclic garbage collected
        # then) is destroyed by a call the capture does not permit, which
        # invalidates it: collect now and not during the capture
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                core = self.carry
                for _ in range(self.k):
                    core = self._round(core)
                # the rounds' outputs live in the graph's pool: copy the
                # last into the static carry, and hold no reference to them
                _copy_into(self.carry, core)
                del core
                self.flag.copy_(self._live(self.carry))
        finally:
            if was_enabled:
                gc.enable()
        self.graph = graph
        self.launches = dict(cluster_accel.captured_launches)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
