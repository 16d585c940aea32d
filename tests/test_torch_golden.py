"""The cornell golden on the port, on the CPU (slow: ~25 s on 8 threads,
over 2 minutes on one; chip_smoke.py phase 19 runs it on the card).

tests/golden/cornell.json names only plane.geo and sphere.geo, which
tests/fixtures/macbeth holds (copied from the reference), so the scene
loads without the reference checkout.  RenderSession at 64x64, 8 spp, 6
bounces against the reference renderer's cornell_64x64_8spp.exr with
test_cornell_golden's criteria (tests/test_golden.py _compare).
"""

import os

import pytest

from nart_tpu_torch import render
from nart_tpu_torch.scene import load_scene
from tests.test_golden import GOLDEN, _compare

MACBETH_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")


@pytest.mark.slow
def test_cornell_golden():
    scene = load_scene(os.path.join(GOLDEN, "cornell.json"),
                       asset_root=MACBETH_DIR)
    params = render.resolve_params(
        {}, dict(image_width=64, image_height=64, spp=8, bounces=6))
    sess = render.RenderSession(scene, params, "cpu")
    _compare(sess.image().numpy(),
             os.path.join(GOLDEN, "cornell_64x64_8spp.exr"),
             mean_tol=0.02, block_tol=0.1, block_frac=0.9)
