"""Checkpoint / resume for long renders.

Counterpart of ``nart_tpu/checkpoint.py``.  The film's (contribution,
filterWeightSum) pair is a resumable sufficient statistic (render.h:18-21):
accumulation is associative, so a render checkpointed after k spp and
resumed for the remaining spp - k gives the same film as an uninterrupted
one; the per-pixel RNG states carry the stream position.

Format: an NPZ with the JAX package's keys: the raw film, the RNG states as
uint32, the spp done, the render parameters (JSON of the dataclass, checked
on resume) and an ``extra`` JSON dict.  A path without the ".npz" suffix
gets it (file_of), for the save, the load and RenderSession's check that a
checkpoint exists alike.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def file_of(path):
    """The file a checkpoint path names: the path with ".npz" appended
    where it lacks the suffix (as np.savez_compressed would write it)."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save(path, film, rng_state, spp_done, params, extra=None):
    np.savez_compressed(
        file_of(path),
        film=_numpy(film),
        rng_state=_numpy(rng_state).astype(np.uint32),
        spp_done=np.int64(spp_done),
        params=json.dumps(dataclasses.asdict(params)),
        extra=json.dumps(extra or {}),
    )


def load(path, params=None):
    """Returns (film, rng_state, spp_done) as numpy arrays and an int.  If
    params is given, every field but spp must equal the saved one, else
    ValueError."""
    with np.load(file_of(path), allow_pickle=False) as z:
        film = z["film"]
        state = z["rng_state"]
        spp_done = int(z["spp_done"])
        saved = json.loads(str(z["params"]))
    if params is not None:
        for k, v in dataclasses.asdict(params).items():
            if k != "spp" and saved.get(k) != v:
                raise ValueError(
                    f"checkpoint mismatch for {k!r}: {saved.get(k)!r} != {v!r}")
    return film, state, spp_done
