"""The port's measuring layer on the CPU, tiny: nart_tpu_torch.bench,
bench_configs and bench_volume_grad run end to end and give their keys.
No time is asserted: a CPU run says nothing of the card."""

import math
import os

import pytest
import torch

from nart_tpu_torch import bench, bench_configs, bench_volume_grad, render
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

ROW_KEYS = {"config", "size", "spp", "fwd_s", "fwd_mrays_per_s",
            "fwd_spread_pct", "fwd_runs_s", "rays", "validated_by", "rounds",
            "peak_mib", "device"}


@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
def test_bench_line(mode):
    res = bench.run(8, 2, mode, device="cpu", repeats=1)
    assert set(bench.LINE_KEYS) <= set(res)
    assert math.isfinite(res["value"]) and res["value"] > 0.0
    assert res["unit"] == "Mrays/s" and res["device"] == "cpu"
    label = "fwd+bwd" if mode == "fwdbwd" else "fwd"
    # the metric names the scene that was rendered
    assert res["metric"] == (f"Mrays/s/chip {label} {res['scene']} "
                             "8x8@2spp")
    assert res["scene"] == ("glassSphere" if os.path.exists(bench.REF_SCENE)
                            else "simple_glass")
    # the anchor times glassSphere: no ratio for another scene
    for k in ("vs_baseline", "vs_fresh"):
        if res["scene"] == "glassSphere":
            assert math.isfinite(res[k]) and res[k] > 0.0
        else:
            assert res[k] is None
    assert set(res["runs"]) == ({"fwd", "fwdbwd"} if mode == "fwdbwd"
                                else {"fwd"})
    for r in res["runs"].values():
        assert len(r["seconds"]) == 1 and r["rays"] > 0 and r["rounds"] > 0


def test_fwdbwd_run_sums_the_chunks():
    """Two chunks of one sample give the gradient of one chunk of two."""
    _, scene = bench.bench_scene()
    params = render.RenderParams(image_width=8, image_height=8, spp=2,
                                 bounces=4)
    sess = render.RenderSession(scene, params, "cpu")
    samples = render.image_samples(8, 8, sess.total_w, 2, "cpu")
    rays1, rounds1, g1 = bench.fwdbwd_run(
        sess, samples, bench.rgb_cot(1, 64, "cpu"), chunk=1)
    rays2, _, g2 = bench.fwdbwd_run(sess, samples, bench.rgb_cot(2, 64, "cpu"))
    assert rays1 == rays2 and rounds1 > 0
    torch.testing.assert_close(g1["rho_d_const"], g2["rho_d_const"],
                               rtol=1e-4, atol=1e-6)


def test_bench_raises_without_a_card(monkeypatch):
    """No device named and no card: it raises, it never measures the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(8, 2, "fwd")


def test_config_row(monkeypatch):
    monkeypatch.setitem(bench_configs.CONFIGS, "5_volume", (
        "tests/golden/volume_blob.json", ("tests/golden",), 8, 8, 2, 4,
        {"integrator": "volume"}, "tests/test_golden.py::test_volume_golden"))
    (row,) = bench_configs.run_config("5_volume", device="cpu")
    assert set(row) == ROW_KEYS
    assert row["size"] == "8x8" and row["spp"] == 2 and row["rays"] > 0
    assert math.isfinite(row["fwd_mrays_per_s"]) and row["device"] == "cpu"


def test_missing_inputs_are_reported_not_run(monkeypatch, tmp_path):
    absent = str(tmp_path / "absent")
    monkeypatch.setattr(bench_configs, "CONFIGS", {"2_cornell": (
        "tests/golden/cornell.json", (absent,), 8, 8, 1, 2, {}, "")})

    def no_session(*a, **k):
        raise AssertionError("a config with missing inputs was run")

    monkeypatch.setattr(render, "RenderSession", no_session)
    assert bench_configs.main([]) == [{"config": "2_cornell", "missing": [
        os.path.join(absent, "input", "meshes", "plane.geo"),
        os.path.join(absent, "input", "meshes", "sphere.geo")]}]


def test_missing_scene_and_checkout_paths():
    """A scene absent as a whole is the one missing path; a file a golden
    names by an absolute path is read from beside the scene JSON."""
    assert bench_configs.missing_inputs("/nonexistent/s.json", "/x") == [
        "/nonexistent/s.json"]
    doc = bench_configs.scene_doc(os.path.join(
        bench_configs.REPO, "tests", "golden", "volume_blob.json"))
    assert doc["camera"]["medium"]["filePath"] == os.path.join(
        bench_configs.REPO, "tests", "golden", "blob.vol")


def test_volume_grad_routes():
    res = bench_volume_grad.run(8, 1, device="cpu")
    assert set(res) == {"lockstep", "balanced"}
    for route, r in res.items():
        assert r["s"] > 0.0 and math.isfinite(r["loss"]) and r["loss"] > 0.0
        for k in ("sigma_a", "sigma_s", "le", "density"):
            g = r["grads"]["medium"][k]
            assert bool(torch.isfinite(g).all()), (route, k)
        assert float(r["grads"]["medium"]["sigma_s"].abs().sum()) > 0.0
