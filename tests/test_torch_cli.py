"""The CLI of nart_tpu_torch (cli.py) on the CPU: tests/test_cli.py's cases
on the port, the JAX flags it takes, and a two-process render.

The CLI runs in-process with ``--device cpu`` (on a machine with a card the
default is the card).  Its EXR must equal RenderSession.write_exr's; the
two gloo processes of ``--devices 2 --device cpu`` sum two partial films,
so their EXR equals one process's up to the half rounding of the EXR
(rtol 2^-10).
"""

import json
import os

import numpy as np
import pytest

from nart_tpu_torch import cli, exr, render
from nart_tpu_torch.cluster_accel import resolve_accel_kind
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

HERE = os.path.dirname(__file__)
VOLUME = os.path.join(HERE, "golden", "volume_blob.json")
MACBETH_DIR = os.path.join(HERE, "fixtures", "macbeth")
MACBETH = os.path.join(MACBETH_DIR, "macbeth.json")
SMALL = ["-w", "16", "-h", "16", "-s", "1", "--device", "cpu"]


def _session_image(scene, tmp_path, overrides, asset_root=None):
    """RenderSession.write_exr's image of the scene's first session."""
    (_, sess), = list(render.render_scene_file(
        scene, overrides, device="cpu", asset_root=asset_root))[:1]
    return exr.read(sess.write_exr(str(tmp_path / "session")))


def test_render_writes_exr(tmp_path):
    out = str(tmp_path / "img")
    assert cli.main([VOLUME, out] + SMALL) == 0
    img = exr.read(out + ".exr")
    assert img.shape == (16, 16, 4) and np.isfinite(img).all()
    want = _session_image(VOLUME, tmp_path, dict(image_width=16,
                                                 image_height=16, spp=1))
    np.testing.assert_array_equal(img, want)


def test_multi_session_naming(tmp_path):
    """A scene with 3 renderSessions writes _0/_1/_2 (main.cpp:44-49)."""
    with open(VOLUME) as f:
        doc = json.load(f)
    doc["renderSessions"] = [dict(doc["renderSessions"][0], spp=s)
                             for s in (1, 2, 3)]
    scene = str(tmp_path / "three.json")
    with open(scene, "w") as f:
        json.dump(doc, f)
    out = str(tmp_path / "many")
    assert cli.main([scene, out, "-w", "8", "-h", "8", "-o", "2",
                     "--platform", "cpu"]) == 0
    for i in range(3):
        assert os.path.exists(f"{out}_{i}.exr"), f"session {i} output missing"
    assert not os.path.exists(out + ".exr")


def test_flag_precedence_cli_over_json():
    p = render.resolve_params({"spp": 64, "imageWidth": 32}, {"spp": 4})
    assert p.spp == 4 and p.image_width == 32
    assert p.bounces == 10 and p.bucket_size == 16
    p = render.resolve_params({"rougheningFactor": 7.0}, {})
    assert p.roughening_factor == 1.0
    args = cli.build_parser().parse_args(
        ["s.json", "o", "-w", "8", "-h", "4", "-b", "8", "-s", "2", "-o", "3",
         "-f", "2", "-r", "0.5", "--wavefront", "regen", "--lanes", "64",
         "--sortRays", "--accel", "bvh"])
    assert cli._overrides(args) == dict(
        image_width=8, image_height=4, bucket_size=8, spp=2, bounces=3,
        filter_width=2.0, roughening_factor=0.5, accel="bvh",
        wavefront="regen", lanes=64, sort_rays=True)


def test_unknown_flag_errors():
    with pytest.raises(SystemExit):
        cli.main(["scene.json", "out", "--nonsense"])


def test_jax_flags_run_unchanged():
    """--accel pallas is the cluster kind; --platform cpu|gpu|cuda names
    the device; the multi-process flags parse."""
    args = cli.build_parser().parse_args(
        ["s.json", "o", "--accel", "pallas", "--platform", "gpu",
         "--coordinator", "h:1", "--numProcesses", "2", "--processId", "1",
         "--devices", "2", "--profile", "d", "--timing", "--assetRoot", "a"])
    accel = render.RenderParams(accel=cli._overrides(args)["accel"]).accel
    assert resolve_accel_kind(accel) == "cluster"
    assert cli._PLATFORMS[args.platform] == "cuda"
    assert (args.num_processes, args.process_id, args.devices) == (2, 1, 2)


def test_timing_and_profile(tmp_path, capsys):
    prof = str(tmp_path / "prof")
    out = str(tmp_path / "t")
    assert cli.main([VOLUME, out] + SMALL + ["--timing", "--profile",
                                             prof]) == 0
    err = capsys.readouterr().err
    for key in ("# load:", "# accel build:", "# render:", "Mrays/s",
                "# write:"):
        assert key in err, key
    assert os.path.exists(os.path.join(prof, "trace_rank0.json"))


def test_devices_without_cards_raises(tmp_path):
    """--devices 2 on the card needs two cards: no CPU path instead."""
    import torch

    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    with pytest.raises(RuntimeError):
        cli.main([VOLUME, str(tmp_path / "x"), "--devices", "2"])
    assert not os.path.exists(str(tmp_path / "x.exr"))


def test_two_processes_write_the_one_process_exr(tmp_path):
    """macbeth at 24x16, 1 spp (the cluster plain versions), one process
    and --devices 2 --device cpu (two gloo ranks, striped rows)."""
    args = ["-w", "24", "-h", "16", "-s", "1", "--device", "cpu",
            "--assetRoot", MACBETH_DIR]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert cli.main([MACBETH, one] + args) == 0
    assert cli.main([MACBETH, two] + args + ["--devices", "2"]) == 0
    a, b = exr.read(one + ".exr"), exr.read(two + ".exr")
    assert a.shape == (16, 24, 4) and a[..., :3].mean() > 0
    np.testing.assert_allclose(b, a, rtol=2.0**-10, atol=0)
