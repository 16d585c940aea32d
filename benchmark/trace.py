"""The traced slice of a run: a few units under torch.profiler, the
host's activity and the card's, reduced from the profiler's raw kineto
events (key_averages takes some 50 us an event, and a unit launches tens
of thousands of kernels).

The profiler records the card's activity only (recording every host
operation as well slowed a traced unit by some 80%).  The benchmark's
own spans (Spans) mark each unit ("bench.unit") and, inside it, the
phases on the host: the sample set-up ("bench.samples"), the call into
the program ("bench.entry"), the film's finalize ("bench.finalize") and
the synchronise ("bench.sync"), read from time.time_ns(), the clock the
profiler puts its events on.
The traced window runs from the first unit's start to the last unit's
end.  The card is busy where the union of its kernels, copies and memsets
covers the window; the rest is idle, and each idle gap is named by the
phase span open where it starts.  Times are kept in integer nanoseconds
of the profiler's clock (a float of seconds since the epoch would round
them to a quarter of a microsecond).
"""

import contextlib
import time
from dataclasses import dataclass, field

from torch.autograd import DeviceType

from . import roofline

UNIT = "bench.unit"
PHASES = ("bench.samples", "bench.entry", "bench.finalize", "bench.sync")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel name's characters kept in the breakdown


@dataclass
class Summary:
    """What the per-layer readers read (metrics/*.py).  mode: "render" or
    "train"; units: the units traced; rounds: the rounds the program
    reported for them (a train unit's forward rounds: its backward replays
    as many); lanes: the machine's work slots; ops: the configuration's
    operations a lane of each hand kernel (roofline.py); device_ops: (name,
    start ns, duration ns) of each kernel, copy and memset in the window;
    gaps: (phase, ns) of each idle gap."""
    mode: str
    units: int
    rounds: int
    lanes: int
    ops: dict = field(default_factory=dict)  # operations a lane (roofline)
    lo_ns: int = 0  # the window's start
    window_ns: int = 0
    busy_ns: int = 0
    device_ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)

    @property
    def window_s(self):
        return self.window_ns * 1e-9

    @property
    def busy_s(self):
        return self.busy_ns * 1e-9


def union_s(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals, lo, hi):
    """The gaps (start, end) in [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def _phase_at(t, phases):
    for name, a, b in phases:
        if a <= t < b:
            return name
    return "between phases"


def summarize(events, mode, units, rounds, lanes, lane_ops=None):
    """Summary of a traced slice from (activity, name, start ns, duration
    ns) tuples: the benchmark's spans ("user_annotation") and the card's
    operations ("device"); anything else is ignored."""
    spans = [(n, a, a + d) for act, n, a, d in events
             if act == "user_annotation"]
    unit_spans = [(a, b) for n, a, b in spans if n == UNIT]
    if not unit_spans:
        raise ValueError("the trace holds no unit span")
    lo = min(a for a, _ in unit_spans)
    hi = max(b for _, b in unit_spans)
    phases = sorted((s for s in spans if s[0] in PHASES),
                    key=lambda s: s[1])
    ops = [(n, a, d) for act, n, a, d in events
           if act == "device" and a < hi and a + d > lo]
    clipped = [(max(a, lo), min(a + d, hi)) for _, a, d in ops]
    s = Summary(mode=mode, units=units, rounds=rounds, lanes=lanes,
                ops=lane_ops or {},
                lo_ns=lo, window_ns=hi - lo, busy_ns=union_s(clipped),
                device_ops=ops)
    s.gaps = [(_phase_at(a, phases), b - a)
              for a, b in idle_gaps(clipped, lo, hi)]
    return s


def breakdown(s):
    """The trace's breakdown for the result line: the device operations
    that took most time, by name, and the longest idle gaps, by the phase
    open at each; at most TOP entries each."""
    by_name = {}
    for n, _, d in s.device_ops:
        key = n[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    gaps = sorted(s.gaps, key=lambda g: g[1], reverse=True)[:TOP]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in gaps]}


def clipped(s, ops):
    """(start, end) of (name, start, duration) ops, cut to the window."""
    hi = s.lo_ns + s.window_ns
    return [(max(a, s.lo_ns), min(a + d, hi)) for _, a, d in ops]


def hand_ops(s):
    """(name, seconds) of each hand-kernel launch in the window."""
    return [(n, d * 1e-9) for n, _, d in s.device_ops
            if roofline.is_hand(n)]


class Spans:
    """The benchmark's spans of one run: ("user_annotation", name, start
    ns, duration ns) while ``on``, nothing (a no-op) while off."""

    def __init__(self):
        self.on = False
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.events.append(("user_annotation", name, a,
                                time.time_ns() - a))


def profile_units(run_unit, spans, n, device):
    """Run run_unit() n times under torch.profiler (the card's activity),
    each in a "bench.unit" span of `spans`, and return (the events as
    summarize takes them, the rounds the units returned, summed)."""
    from torch.profiler import ProfilerActivity, profile

    def units():
        total = 0
        for _ in range(n):
            with spans(UNIT):
                total += run_unit()
        return total

    spans.on, spans.events = True, []
    try:
        if device.type != "cuda":  # the CPU tests: spans, no device
            return spans.events, units()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rounds = units()
    finally:
        spans.on = False
    raw = prof.profiler.kineto_results.events()
    return spans.events + kineto_events(raw), rounds


def kineto_events(raw):
    """("device", name, start ns, duration ns) of the card's operations
    among the profiler's raw events: kernels, copies and memsets (not its
    user annotations)."""
    cuda = DeviceType.CUDA
    return [("device", e.name(), e.start_ns(), e.duration_ns()) for e in raw
            if e.device_type() == cuda and not e.is_user_annotation()]
