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

``ReplayRunner`` runs a path replay (replay.py) on the same schedule: its
forward rounds as above, each handed the slot of the caller's per-round
store at which it writes its incoming carry (the device count before the
round), and its backward as one round function replayed once for each
live round, last to first, the slot counted down on the device: on the
card one captured CUDA graph replayed back to back with no host read, on
the CPU eagerly.  Its ``max_rounds`` is the store's capacity.

A failed capture or replay raises.  Whether the rounds run eagerly is
decided by the device, or by the caller's route (integrators/path.py
names the routes that never capture), never by an error.
"""

from __future__ import annotations

import gc
import time
from dataclasses import fields, is_dataclass, replace

import torch

from . import cuda_build

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


def rebuild(x, tensors):
    """x's structure (tuples, named tuples, dataclasses) with its tensors
    taken from the iterator `tensors` in carry_tensors' order; a None in x
    stands for a tensor (a structure kept without its tensors)."""
    if x is None or torch.is_tensor(x):
        return next(tensors)
    if is_dataclass(x):
        return replace(x, **{f.name: rebuild(getattr(x, f.name), tensors)
                             for f in fields(x)})
    vals = [rebuild(v, tensors) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def _clone(x):
    return rebuild(x, (t.clone() for t in carry_tensors(x)))


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
        self.launches = {}  # kernel launches of one replay
        self.captures = 0
        self.capture_s = 0.0  # warm-up round excluded
        self.replays = 0
        self.rounds_run = 0  # rounds the device ran, live and dead

    def _gate(self, core):
        """core with its lanes gated by max_rounds on the device count."""
        if self.max_rounds is None:
            return core
        alive = core[0].alive & (self.rounds < self.max_rounds)
        return (replace(core[0], alive=alive),) + tuple(core[1:])

    def _round(self, core):
        """One round of core, gated by max_rounds and counted on the
        device."""
        core = self._gate(core)
        self.rounds.add_(core[0].alive.any())
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
                cuda_build.launch_counts[name] += n
        return self.carry

    def _capture(self):
        def warm():
            _copy_into(self.carry, self._round(self.carry))
            self.flag.copy_(self._live(self.carry))

        def body():
            core = self.carry
            for _ in range(self.k):
                core = self._round(core)
            # the rounds' outputs live in the graph's pool: copy the last
            # into the static carry (the reference dies with this frame)
            _copy_into(self.carry, core)
            self.flag.copy_(self._live(self.carry))

        self.graph, self.launches, dt = _capture(self.rounds.device, warm,
                                                 body)
        self.rounds_run += 1  # warm's
        self.captures += 1
        self.capture_s += dt


def _capture(dev, warm, body):
    """warm() eagerly on a side stream (the first round, which builds what
    a round builds on first use before anything is captured), then body()
    captured into a new CUDA graph.  Returns (the graph, the kernel
    launches of one replay, capture + instantiate seconds)."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream(dev).wait_stream(side)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    cuda_build.reset_captured_launches()
    # a graph that dies during a capture (cyclic garbage collected then) is
    # destroyed by a call the capture does not permit, which invalidates
    # it: collect now and not during the capture
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            body()
    finally:
        if was_enabled:
            gc.enable()
    return graph, dict(cuda_build.captured_launches), \
        time.perf_counter() - t0


class ReplayRunner(RoundRunner):
    """The runner of a path replay (replay.ReplayMachine).

    Forward: RoundRunner's schedule with ``max_rounds`` the store's
    capacity (or the caller's own cut, if smaller), calling
    ``round_fn(core, slot)``: slot, a (1,) int64 tensor, is the device
    count before the round, so the live rounds write slots 0, 1, ... and a
    round past the end (or past the capacity) writes the first slot not
    live, which the store keeps spare.  ``cut`` counts the lanes still
    alive when the capacity ran out (the caller's "unfinished").

    Backward: ``run_backward(n)`` calls ``back_fn(slot)`` n times with slot
    = rounds - 1, rounds - 2, ..., 0, counted down on the device: on the
    card the first call runs the first of them eagerly on a side stream,
    captures one into a CUDA graph, and every call replays that graph back
    to back with no host read; on the CPU (or with ``graph`` off) the same
    rounds run eagerly."""

    def __init__(self, round_fn, back_fn, capacity, k=None, max_rounds=None,
                 graph=True):
        super().__init__(round_fn, k, capacity if max_rounds is None
                         else min(capacity, max_rounds), graph)
        self.back_fn = back_fn
        self.capacity = capacity
        self.cut = None  # () int64 on the device
        self.slot = None  # (1,) int64 on the device: the backward's round
        self.back_graph = None
        self.back_launches = {}
        self.back_rounds = 0  # backward rounds run (captures counts both
        # graphs, replays the forward's)

    def _round(self, core):
        self.cut.add_((core[0].alive & (self.rounds >= self.max_rounds)).sum())
        core = self._gate(core)
        slot = self.rounds.reshape(1).clone()
        self.rounds.add_(core[0].alive.any())
        return self.round_fn(core, slot)

    def run(self, core0):
        if self.cut is None:
            dev = core0[0].alive.device
            self.cut = torch.zeros((), dtype=torch.int64, device=dev)
            self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.cut.zero_()
        return super().run(core0)

    def _back_round(self):
        self.back_fn(self.slot)
        self.slot.sub_(1)

    def run_backward(self, n):
        """The backward over the last run's n live rounds (n read by the
        caller at the forward's end)."""
        self.slot.copy_(self.rounds - 1)
        if n > 0 and self.slot.device.type == "cuda" and self.graph_on:
            if self.back_graph is None:
                self.back_graph, self.back_launches, dt = _capture(
                    self.slot.device, self._back_round, self._back_round)
                self.captures += 1
                self.capture_s += dt
                self.back_rounds += 1
                n -= 1
            for _ in range(n):
                self.back_graph.replay()
                for name, c in self.back_launches.items():
                    cuda_build.launch_counts[name] += c
        else:
            for _ in range(n):
                self._back_round()
        self.back_rounds += n
