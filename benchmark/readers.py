"""The arithmetic of the per-layer metrics, from a traced slice's
trace.Summary.  Each metrics/<name>.py file reads one of these for one
mode; a reader returns None where the summary holds nothing for it (the
other mode's units, no device operation, no round)."""

from . import roofline, trace


def _of(s, mode):
    return s.mode == mode and s.busy_ns > 0


def idle_pct(s, mode):
    """The window's share (%) in which no kernel, copy or memset ran."""
    if not _of(s, mode):
        return None
    return 100.0 * (1.0 - s.busy_ns / s.window_ns)


def rounds_per_step(s, mode):
    """The rounds the program reported, over the units traced."""
    if s.mode != mode or s.units == 0:
        return None
    return s.rounds / s.units


def device_ms_per_round(s, mode):
    """Busy device milliseconds over the rounds."""
    if not _of(s, mode) or s.rounds == 0:
        return None
    return s.busy_ns * 1e-6 / s.rounds


def kernels_per_round(s, mode):
    """Kernels, copies and memsets over the rounds."""
    if not _of(s, mode) or s.rounds == 0:
        return None
    return len(s.device_ops) / s.rounds


def hand_kernel_pct(s, mode):
    """The share (%) of the busy time the hand kernels' launches cover."""
    if not _of(s, mode):
        return None
    hand = [op for op in s.device_ops if roofline.is_hand(op[0])]
    return 100.0 * trace.union_s(trace.clipped(s, hand)) / s.busy_ns


def hand_kernels_roofline(s, mode):
    """The hand kernels' least times over their device times (%)."""
    if not _of(s, mode):
        return None
    return roofline.roofline_pct(trace.hand_ops(s), s.lanes, s.ops)
