"""No host-built constant in a path round, and "pallas" is the cluster kind.

A tensor built on the host from a Python or numpy payload
(``torch.tensor([...], device=...)``) is, on the card, a blocking copy from
pageable memory that synchronises the stream.  The path round's lobes
(bxdf._vndf_sample, bxdf.specdiel_sample) and a distant light's sample make
their constant axes on the device; here every ``torch.tensor`` (and
``torch.as_tensor`` of a non-tensor) call is counted while the balanced
work queue runs, and none may fall inside a round (path.make_bounce's
per-round step).  The lobes' values are held against the JAX package in
tests/test_torch_shading.py.  CPU, 8x8 at 2 spp.
"""

import json

import numpy as np
import pytest
import torch

from nart_tpu_torch import render, testing
from nart_tpu_torch.integrators import path
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

W = H = 8
SPP = 2


@pytest.mark.parametrize("make", [
    lambda: testing.simple_scene(("lambert", "glass")), testing.distant_scene,
], ids=["disk", "disk+distant"])
def test_no_host_constant_inside_a_round(monkeypatch, make):
    scene = make()
    # 16 work slots for 288 items: many rounds, lanes respawning
    params = render.RenderParams(image_width=W, image_height=H, spp=SPP,
                                 bounces=6, lanes=16)
    sess = render.RenderSession(scene, params, "cpu")
    where = {"round": 0, "inside": False}
    calls = []  # the round each host-built tensor was made in (0: set-up)

    real_tensor, real_as_tensor = torch.tensor, torch.as_tensor

    def tensor(*a, **k):
        calls.append(where["round"] if where["inside"] else 0)
        return real_tensor(*a, **k)

    def as_tensor(data, *a, **k):
        if not torch.is_tensor(data):
            calls.append(where["round"] if where["inside"] else 0)
        return real_as_tensor(data, *a, **k)

    real_make_bounce = path.make_bounce

    def make_bounce(*a, **k):
        body = real_make_bounce(*a, **k)

        def counted(bounce, p):
            where["round"] += 1
            where["inside"] = True
            try:
                return body(bounce, p)
            finally:
                where["inside"] = False
        return counted

    monkeypatch.setattr(path, "make_bounce", make_bounce)
    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    img = sess.image()
    monkeypatch.undo()
    assert where["round"] >= 10, where
    assert calls.count(0) > 0  # the counter sees the set-up's tensors
    assert [r for r in calls if r] == [], calls
    assert bool(torch.isfinite(img).all())


def _film(params):
    return render.RenderSession(testing.simple_scene(("lambert", "glass")),
                                params, "cpu").render()


def test_pallas_accel_renders_the_cluster_film(tmp_path):
    """accel="pallas" (the JAX package's name of the cluster kernels) from
    RenderParams and from a session JSON renders the "cluster" film."""
    base = dict(image_width=W, image_height=H, spp=SPP)
    want = _film(render.RenderParams(accel="cluster", **base))
    assert torch.equal(_film(render.RenderParams(accel="pallas", **base)),
                       want)
    scene_json = tmp_path / "s.json"
    scene_json.write_text(json.dumps({"renderSessions": [
        {"imageWidth": W, "imageHeight": H, "spp": SPP, "accel": "pallas"}]}))
    (params,) = render.load_sessions(str(scene_json))
    assert params.accel == "pallas"
    assert torch.equal(_film(params), want)
    assert not np.isnan(want.numpy()).any()
