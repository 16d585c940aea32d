"""The benchmark's arithmetic on synthetic inputs: rates, percentiles,
the trace's busy union and idle gaps, the per-layer readers and the
roofline."""

import statistics

import pytest

from benchmark import readers, roofline, stats, trace

MS = 1_000_000  # ns


def test_rate_counts_every_sample_over_the_whole_window():
    assert stats.rate_m(10, 1_000_000, 2.0) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        stats.rate_m(1, 1, 0.0)


def test_percentile_is_the_inclusive_interpolation_of_every_value():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile(values, 95) == statistics.quantiles(
        values, n=100, method="inclusive")[94]
    assert stats.percentile([3.0], 95) == 3.0


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert trace.union_s(iv) == 30
    assert trace.idle_gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert trace.idle_gaps(iv, 2, 36) == [(20, 30)]
    assert trace.idle_gaps([], 0, 5) == [(0, 5)]


def _events():
    """Two units of 10 ms; the card busy 4 + 3 ms in the first and 5 ms in
    the second; hand kernels 2 ms of it."""
    ev = [("user_annotation", trace.UNIT, 0, 10 * MS),
          ("user_annotation", "bench.entry", 0, 8 * MS),
          ("user_annotation", "bench.sync", 8 * MS, 2 * MS),
          ("user_annotation", trace.UNIT, 10 * MS, 10 * MS),
          ("user_annotation", "bench.entry", 10 * MS, 9 * MS),
          ("user_annotation", "bench.sync", 19 * MS, MS),
          ("device", "void walk_kernel<4, true, false>(float const*)",
           1 * MS, 2 * MS),
          ("device", "void at::native::elementwise_kernel<128>(int)",
           3 * MS, 2 * MS),
          ("device", "Memcpy DtoH", 6 * MS, 3 * MS),
          ("device", "void at::native::elementwise_kernel<128>(int)",
           12 * MS, 5 * MS),
          ("cpu_op", "aten::add", 0, 30 * MS),  # ignored
          ("device", "late_kernel", 25 * MS, MS)]  # outside the window
    return ev


def test_summary_of_a_traced_slice():
    s = trace.summarize(_events(), "train", 2, 8, 65536)
    assert s.window_ns == 20 * MS
    assert s.busy_ns == 12 * MS
    assert len(s.device_ops) == 4
    # 0-1 and 5-6 ms in the first entry, 9-12 from its sync on, 17-20 in
    # the second entry
    assert s.gaps == [("bench.entry", MS), ("bench.entry", MS),
                      ("bench.sync", 3 * MS), ("bench.entry", 3 * MS)]
    b = trace.breakdown(s)
    assert b["device_ops"][0] == [
        "void at::native::elementwise_kernel<128>(int)", pytest.approx(7e-3)]
    assert b["idle_gaps"][:2] == [["bench.sync", pytest.approx(3e-3)],
                                  ["bench.entry", pytest.approx(3e-3)]]
    assert len(b["device_ops"]) <= trace.TOP


def test_readers():
    s = trace.summarize(_events(), "train", 2, 8, 65536)
    assert readers.idle_pct(s, "train") == pytest.approx(40.0)
    assert readers.idle_pct(s, "render") is None
    assert readers.rounds_per_step(s, "train") == 4.0
    assert readers.device_ms_per_round(s, "train") == pytest.approx(1.5)
    assert readers.kernels_per_round(s, "train") == pytest.approx(0.5)
    assert readers.hand_kernel_pct(s, "train") == pytest.approx(100 * 2 / 12)
    # an any-hit walk: twice the slots, 33 B a lane (no operations given)
    least = 2 * 33 * 65536 / roofline.PEAK_BYTES
    assert readers.hand_kernels_roofline(s, "train") == pytest.approx(
        100 * least / 2e-3)
    # with the configuration's operations a lane, the larger side
    ops = {"f32": {"walk_kernel.any": 3000.0}}
    s = trace.summarize(_events(), "train", 2, 8, 65536, ops)
    least = 2 * 3000.0 * 65536 / roofline.PEAK_F32
    assert least > 2 * 33 * 65536 / roofline.PEAK_BYTES
    assert readers.hand_kernels_roofline(s, "train") == pytest.approx(
        100 * least / 2e-3)
    idle = trace.summarize([e for e in _events() if e[0] != "device"],
                           "train", 2, 8, 1)
    assert readers.idle_pct(idle, "train") is None
    assert readers.hand_kernels_roofline(idle, "train") is None


def test_roofline_names_and_least_times():
    assert roofline.base_name(
        "void walk_kernel<4, true, false>(float const*, int)") == \
        "walk_kernel"
    assert roofline.base_name("lut_seg_kernel") == "lut_seg_kernel"
    # as the card's trace names them
    assert roofline.base_name(
        "void (anonymous namespace)::walk_kernel<4, false, false>(float "
        "const*, (anonymous namespace)::Accel)") == "walk_kernel"
    assert roofline.base_name("(anonymous namespace)::vol_steps_kernel(("
                              "anonymous namespace)::Args)") == \
        "vol_steps_kernel"
    assert roofline.base_name("void ns::vol_steps_kernel(Args)") == \
        "vol_steps_kernel"
    assert roofline.is_hand("void bsdf_f_bwd_kernel<Design<1, 1> >(Args)")
    assert not roofline.is_hand("void at::native::index_kernel(int)")
    # vol_steps_ref_kernel is a hand kernel with no count: time, no least
    assert roofline.is_hand("vol_steps_ref_kernel")
    assert roofline.least_s("vol_steps_ref_kernel", 1024) == 0.0
    n = 32768
    assert roofline.least_s("vol_steps_kernel", n) == pytest.approx(
        158 * n / 3.35e12)
    # the walk's family by its any-hit flag; lanes and operations by family
    closest = "void (anonymous namespace)::walk_kernel<4, false, false>(A)"
    anyhit = "void (anonymous namespace)::walk_kernel<4, true, false>(A)"
    assert roofline.family(closest) == "walk_kernel.closest"
    assert roofline.family(anyhit) == "walk_kernel.any"
    assert roofline.family("lut_seg_kernel") == "lut_seg_kernel"
    ops = {"f32": {"walk_kernel.closest": 2562.4},
           "f64": {"bsdf_f_bwd_kernel": 1321.4}}
    assert roofline.least_s(closest, n, ops) == pytest.approx(
        2562.4 * n / 67e12)
    assert roofline.least_s(anyhit, n, ops) == pytest.approx(
        2 * 33 * n / 3.35e12)
    assert roofline.least_s("bsdf_f_bwd_kernel", n, ops) == pytest.approx(
        1321.4 * n / 34e12)
    launches = [("vol_steps_kernel", 2 * 158 * n / 3.35e12),
                ("lut_sort_kernel", 1e-6)]
    pct = roofline.roofline_pct(launches, n)
    assert 0 < pct < 50
    assert roofline.roofline_pct([], n) is None
