"""BENCHMARK.json and the files it names, each found by name: a cell's
configuration (configs/<name>.json), its traffic mix
(traffic/<name>.json) and the per-layer metric readers
(metrics/<name>.py)."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json_file(kind, name, here=HERE):
    path = os.path.join(here, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def config(name, here=HERE):
    """configs/<name>.json."""
    return _json_file("configs", name, here)


def traffic(name, here=HERE):
    """traffic/<name>.json."""
    return _json_file("traffic", name, here)


def _applies(metric, cell_name):
    return cell_name in metric.get("workloads", [cell_name])


class Cell:
    """One entry of BENCHMARK.json's workloads, with what it names: its
    configuration and traffic dicts, and the end-to-end and per-layer
    metric entries reported in it."""

    def __init__(self, bench, name, here=HERE):
        w = _named(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(w["chips"])
        self.config_name = w["config"]
        self.traffic_name = w["traffic"]
        cfg_entry = _named(bench["configs"], w["config"], "config")
        self.config = config(w["config"], here)
        self.config_file = cfg_entry["file"]
        self.traffic = traffic(w["traffic"], here)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]


def metric_reader(name, here=HERE):
    """metrics/<name>.py's ``read``: read(summary) -> a number, or None
    where the summary holds nothing for it to read."""
    path = os.path.join(here, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
