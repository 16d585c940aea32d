"""The redesigned flight-step lane functions of nart_tpu_torch/csrc/vol_step.cu
against the first design's, built as host C++ (g++ -ffp-contract=off, the
host core's flags: vol_ops.host_walk, cuda_build.load_host_cu), on the CPU.

On testing.vol_lane_set's lanes (every branch of a step: dead lanes,
segments starting inside and outside the box, a missed box, a left segment
and medium, the null event at p_null = 0 and near the majorant, the bounce
limit) at k = 1 and 4, each lane walks through the redesign's flight_step
and step_back and through the first design's (namespace ref, the reference
kernels' own copy): V1's outputs (the state, died, esc, the segment
starts) and V2's (the cotangents, the rows and their cells, the partials)
must be the same bits, with one libm on both sides.  Skips, with its
reason, only where no host compiler is found.  (On the card chip_smoke.py's
phase 28 holds the kernels to each other and to the plain steps.)
"""

import shutil

import pytest
import torch

from nart_tpu_torch import cuda_build, testing, vol_ops

N = 16384
V1_NAMES = (*vol_ops.FIELDS, "died", "esc", "seg")
V2_NAMES = ("g_beta", "g_l", "rows", "idx", "p_sa", "p_ss", "p_le")


@pytest.fixture(scope="module")
def lanes():
    if shutil.which(cuda_build.cxx_path()) is None:
        pytest.skip(f"no host compiler ({cuda_build.cxx_path()}) to build "
                    "csrc/vol_step.cu's lane functions")
    return testing.vol_lane_set(N, 20, "cpu")


def _args(s):
    m = s["medium"]
    return [getattr(s["vs"], f).contiguous() for f in vol_ops.FIELDS] + [
        s["cells"], m.sigma_a, m.sigma_s, m.le, m.bounds_min, m.bounds_max,
        s["sigma_maj"], s["g_beta"], s["g_l"]]


def _walk(s, design, k):
    return vol_ops.host_walk(design, k, s["bounces"],
                             tuple(s["medium"].density.shape), *_args(s))


def _lanes_off(a, b):
    """The lanes (leading index) where a and b differ in any bit."""
    a, b = a.reshape(a.shape[0] if a.dim() else 1, -1), b.reshape(
        b.shape[0] if b.dim() else 1, -1)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).any(-1).sum())


@pytest.mark.parametrize("k", [1, 4])
def test_redesign_is_the_first_design(lanes, k):
    (ref1, ref2), (new1, new2) = _walk(lanes, 0, k), _walk(lanes, 1, k)
    off = {name: _lanes_off(a, b) for name, a, b in
           zip(V1_NAMES + V2_NAMES, (*new1, *new2), (*ref1, *ref2))}
    assert not any(off.values()), off
    # the walk took the branches the lane set is made for
    rows, idx = new2[2], new2[3]
    assert int(new1[-1]) > 0 and bool(new1[11].any()) and bool(
        new1[12].any())
    assert bool((rows != 0).any()) and int(idx.max()) > 0
    assert bool((new2[4] != 0).any()) and bool((new2[6] != 0).any())


def test_host_walk_counts_the_segment_starts(lanes):
    """k = 1: the starts are the lanes alive at a segment's start, an
    integer count whatever the libm."""
    vs = lanes["vs"]
    for design in (0, 1):
        (v1, _) = _walk(lanes, design, 1)
        assert int(v1[-1]) == int((vs.alive & vs.new_ray).sum())


def test_host_walk_refuses():
    s = testing.vol_lane_set(8, 1)
    with pytest.raises(ValueError, match="1 to 8"):
        _walk(s, 1, vol_ops.MAX_STEPS + 1)
