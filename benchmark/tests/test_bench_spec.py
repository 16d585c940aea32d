"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name: a configuration, traffic mix or per-layer metric
added as a file is found without an edit of the harness."""

import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    assert len(json.dumps(bench)) < 64 * 1024


def test_bounds_and_run_length(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    # a full check of 24 cells fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert e2e[m["moves"]]


def test_every_named_file_is_found(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        cfg = spec.config(c["name"])
        for key in c["reduced"]:
            assert key in cfg
    for w in bench["workloads"]:
        spec.Cell(bench, w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_an_added_config_traffic_and_metric_are_found(tmp_path, bench):
    for d in ("configs", "traffic", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "new_scene.json").write_text(
        json.dumps({"scene": "x.json", "session": {"spp": 8}}))
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps({"mode": "render", "spp_per_unit": 2}))
    (tmp_path / "metrics" / "new_metric.render.py").write_text(
        "def read(summary):\n    return 42.0\n")
    added = dict(bench)
    added["configs"] = bench["configs"] + [
        {"name": "new_scene", "file": "benchmark/configs/new_scene.json"}]
    added["workloads"] = bench["workloads"] + [
        {"name": "new_scene.new_mix", "config": "new_scene",
         "traffic": "new_mix", "chips": 1, "why": "a test"}]
    added["per_layer"] = bench["per_layer"] + [
        {"name": "new_metric.render", "moves": "render_Msamples_per_s",
         "workloads": ["new_scene.new_mix"]}]
    cell = spec.Cell(added, "new_scene.new_mix", here=str(tmp_path))
    assert cell.config["session"]["spp"] == 8
    assert cell.traffic["spp_per_unit"] == 2
    assert [m["name"] for m in cell.per_layer] == ["new_metric.render"]
    assert spec.metric_reader("new_metric.render",
                              here=str(tmp_path))(None) == 42.0
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("absent_metric", here=str(tmp_path))
    with pytest.raises(KeyError):
        spec.Cell(added, "absent.cell", here=str(tmp_path))


def test_the_generated_env_map_is_the_same_every_time():
    """The maker of a configuration's missing map: the same texels from
    its seed every time, each a half float, a car park's dynamic range."""
    import numpy as np

    from benchmark import envmap

    a = envmap.garage(256, 128, 7)
    assert a.shape == (128, 256, 3) and a.dtype == np.float32
    assert np.array_equal(a, envmap.garage(256, 128, 7))
    assert not np.array_equal(a, envmap.garage(256, 128, 8))
    assert np.array_equal(a, a.astype(np.float16).astype(np.float32))
    assert a.min() > 0.0 and a.max() > 100 * np.median(a)


def test_an_exr_written_is_read_back(tmp_path):
    import numpy as np

    from benchmark import exrfile

    x = np.random.default_rng(3).uniform(0, 50, (9, 17, 3))
    exrfile.write_half_rgb(str(tmp_path / "x.exr"), x)
    got = exrfile.read(str(tmp_path / "x.exr"))
    assert np.array_equal(got, x.astype(np.float16).astype(np.float32))
