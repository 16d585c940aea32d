"""Checkpoint / resume of nart_tpu_torch.render (checkpoint.py), on the CPU.

A render saved every 2 of its 4 samples and resumed in a new session from
the file must give the film of an uninterrupted render bit for bit, in each
wavefront mode and for the volume integrator (tests/test_checkpoint.py's
cases, on the port).  The uninterrupted render chunks its samples by its
own rule (chunk_size), the checkpointed one by the checkpoint granularity:
the films must still be equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from nart_tpu_torch import checkpoint as ckpt
from nart_tpu_torch import render, testing
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401


def _params(**kw):
    return render.RenderParams(**{**dict(image_width=6, image_height=6,
                                         spp=4, bounces=3, filter_width=1.0),
                                  **kw})


CASES = {
    "balanced": (lambda: testing.simple_scene(("lambert",)), {}),
    "regen": (lambda: testing.simple_scene(("lambert",)),
              {"wavefront": "regen"}),
    "spp": (lambda: testing.simple_scene(("lambert",)), {"wavefront": "spp"}),
    "volume": (lambda: testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5)),
               {"integrator": "volume", "bounces": 8}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_bit_identical(case, tmp_path, capsys):
    make, kw = CASES[case]
    sc = make()
    p = _params(**kw)
    full = render.RenderSession(sc, p, "cpu").render()
    ck = str(tmp_path / "ck.npz")
    first = render.RenderSession(sc, p, "cpu")
    first.render(checkpoint_path=ck, checkpoint_every=2, progress=True)
    assert os.path.exists(ck)
    assert capsys.readouterr().err.endswith("100%\n")
    _, state, done = ckpt.load(ck, p)
    assert done == 2 and state.dtype == np.uint32
    again = render.RenderSession(sc, p, "cpu")
    resumed = again.render(checkpoint_path=ck, resume=True)
    assert torch.equal(full, resumed)
    assert again.stats["rays"] < first.stats["rays"]  # half the samples


def test_resume_from_a_path_without_the_suffix(tmp_path):
    """The ".npz" suffix is added once (checkpoint.file_of), for the save
    and for the check that a checkpoint exists: the resume finds the file
    and traces only the remaining samples."""
    sc = testing.simple_scene(("lambert",))
    p = _params()
    ck = str(tmp_path / "ck")
    first = render.RenderSession(sc, p, "cpu")
    first.render(checkpoint_path=ck, checkpoint_every=2)
    assert os.path.exists(ck + ".npz") and not os.path.exists(ck)
    assert ckpt.file_of(ck) == ck + ".npz" == ckpt.file_of(ck + ".npz")
    again = render.RenderSession(sc, p, "cpu")
    resumed = again.render(checkpoint_path=ck, resume=True)
    assert torch.equal(resumed, render.RenderSession(sc, p, "cpu").render())
    assert again.stats["rays"] < first.stats["rays"]


def test_checkpoint_param_mismatch(tmp_path):
    sc = testing.simple_scene(("lambert",))
    p = _params()
    ck = str(tmp_path / "ck.npz")
    render.RenderSession(sc, p, "cpu").render(checkpoint_path=ck,
                                              checkpoint_every=2)
    with pytest.raises(ValueError):
        ckpt.load(ck, dataclasses.replace(p, bounces=5))
    with pytest.raises(ValueError):
        render.RenderSession(sc, dataclasses.replace(p, wavefront="spp"),
                             "cpu").render(checkpoint_path=ck, resume=True)
    # spp may differ: a render resumes towards more samples
    film, _, done = ckpt.load(ck, dataclasses.replace(p, spp=8))
    assert done == 2 and film.shape == (8, 8, 5)


def test_file_fields(tmp_path):
    """The JAX package's keys: film, rng_state (uint32), spp_done, params
    (JSON of the dataclass), extra."""
    p = _params()
    path = str(tmp_path / "x.npz")
    ckpt.save(path, torch.ones((8, 8, 5)), torch.tensor([1, 2**32 - 1]), 3,
              p, extra={"note": 1})
    with np.load(path) as z:
        assert set(z.files) == {"film", "rng_state", "spp_done", "params",
                                "extra"}
        assert z["rng_state"].dtype == np.uint32
        assert z["rng_state"][1] == 2**32 - 1 and int(z["spp_done"]) == 3
        assert json.loads(str(z["params"])) == dataclasses.asdict(p)
        assert json.loads(str(z["extra"])) == {"note": 1}


def test_chunk_rule():
    """Checkpoint granularity wins, then spp_chunk, then min(spp, 32); the
    "spp" loop (and "regen" with the volume integrator) goes one sample at
    a time."""
    p = render.RenderParams(spp=100)
    assert render.chunk_size(p) == 32
    assert render.chunk_size(p, 8) == 8
    assert render.chunk_size(dataclasses.replace(p, spp=5)) == 5
    assert render.chunk_size(dataclasses.replace(p, spp_chunk=10)) == 10
    assert render.chunk_size(dataclasses.replace(p, spp_chunk=10), 4) == 4
    assert render.chunk_size(dataclasses.replace(p, spp=3), 8) == 3
    assert render.chunk_size(dataclasses.replace(p, wavefront="regen")) == 32
    assert render.chunk_size(dataclasses.replace(p, wavefront="spp"), 8) == 1
    assert render.chunk_size(dataclasses.replace(
        p, wavefront="regen", integrator="volume")) == 1
