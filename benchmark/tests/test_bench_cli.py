"""The command as BENCHMARK.json names it: no result and a nonzero exit
without a card, or without the program beside the benchmark; on a card
(the gpu marker), one short run of a cell with its result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import spec

ARGS = ["--workload", "macbeth.render", "--seed", str(2 ** 31 + 7),
        "--seconds", "2", "--trace", "1"]


def _run(cwd):
    cmd = spec.load_benchmark()["command"]
    return subprocess.run([sys.executable] + cmd[1:] + ARGS, cwd=cwd,
                          capture_output=True, text=True, timeout=1200)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here: this checks the run without one")
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
