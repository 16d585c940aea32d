"""Film: Gaussian filter splatting.

Counterpart of ``nart_tpu/film.py`` (RenderSession::AddSample and the
filter table, reference src/core/render.cpp:23-70, 127-130; Gaussian(),
render.h:23-32).  The film is one (totalH, totalW, 5) buffer of
[r, g, b, a, filterWeightSum]; the lanes of a splat form the full row-major
render grid, so each filter tap is one shifted dense add.
"""

from __future__ import annotations

import numpy as np
import torch

FILTER_TABLE_RES = 64


def gaussian(width, x):
    """render.h:23-32 (sigma = width/3, hard zero at x >= width)."""
    sigma = width / 3.0
    g = (1.0 / np.sqrt(2.0 * np.pi * sigma * sigma)) * np.exp(
        -(x * x) / (2.0 * sigma * sigma))
    return np.where(x >= width, 0.0, g).astype(np.float32)


def filter_table(device=None):
    """64-entry table: Gaussian(width=63, x=i)  (render.cpp:127-130)."""
    i = np.arange(FILTER_TABLE_RES, dtype=np.float32)
    return torch.from_numpy(
        gaussian(np.float32(FILTER_TABLE_RES - 1), i)).to(device)


def _sample_window(jitter, filter_width, filter_bounds):
    """Per-lane sample position + tap bounds in window coords."""
    fw = float(np.float32(filter_width))
    sx = float(filter_bounds) + jitter[..., 0]
    sy = float(filter_bounds) + jitter[..., 1]
    return (sx, sy, torch.floor(sx - fw), torch.floor(sy - fw),
            torch.ceil(sx + fw), torch.ceil(sy + fw))


def _tap_weight(sx, sy, x0, y0, x1, y1, dx, dy, fw, table):
    """Weight of tap (dy, dx) for every lane (AddSample, render.cpp:23-70)."""
    fdx, fdy = float(dx), float(dy)
    mask = (fdx >= x0) & (fdx < x1) & (fdy >= y0) & (fdy < y1)
    dist = torch.sqrt((fdx + 0.5 - sx) ** 2 + (fdy + 0.5 - sy) ** 2)
    idx = ((dist / fw) * FILTER_TABLE_RES).to(torch.int64) & 0xFF  # u8 cast
    w = table[idx.clamp(max=FILTER_TABLE_RES - 1)]
    return w * mask.to(torch.float32)


def splat_windows(jitter, l_alpha, filter_width, table, render_w, render_h,
                  filter_bounds, real_mask=None):
    """Tap-weight + overlap-add splat of one sample per grid lane.

    Lane i is pixel (i % render_w, i // render_w); its sample sits at pixel +
    filter_bounds + jitter.  Returns the (render_h + K, render_w + K, 5)
    accumulator, K = 2 * filter_bounds + 1.  real_mask ((N,) bool) zeroes
    the weights of the lanes where it is False (a shard's filler lanes)."""
    fw = float(np.float32(filter_width))
    k = 2 * filter_bounds + 1
    sx, sy, x0, y0, x1, y1 = _sample_window(jitter, filter_width,
                                            filter_bounds)
    acc = torch.zeros((render_h + k, render_w + k, 5), dtype=torch.float32,
                      device=l_alpha.device)
    for dy in range(k):
        for dx in range(k):
            w = _tap_weight(sx, sy, x0, y0, x1, y1, dx, dy, fw, table)
            if real_mask is not None:
                w = torch.where(real_mask, w, 0.0)
            img = torch.cat([l_alpha * w[..., None], w[..., None]], dim=-1)
            acc[dy : dy + render_h, dx : dx + render_w] += img.reshape(
                render_h, render_w, 5)
    return acc


def splat_grid(film, jitter, l_alpha, filter_width, table, render_w,
               render_h, filter_bounds):
    """Splat (S, N, ...) per-sample radiance of grid lanes into the film,
    one sample at a time: the per-pixel accumulation order is (sample 0,
    sample 1, ...) however the spp axis is chunked across calls.  Taps off
    the film edge are dropped (render.cpp:192-193).  Updates ``film`` in
    place and returns it."""
    if l_alpha.dim() == 2:
        jitter = jitter[None]
        l_alpha = l_alpha[None]
    h_tot, w_tot, _ = film.shape
    for s_jitter, s_la in zip(jitter, l_alpha):
        acc = splat_windows(s_jitter, s_la, filter_width, table, render_w,
                            render_h, filter_bounds)
        hh = min(h_tot, acc.shape[0])
        ww = min(w_tot, acc.shape[1])
        film[:hh, :ww] += acc[:hh, :ww]
    return film


def finalize(film, image_width, image_height, filter_bounds):
    """Normalise and crop: contribution / filterWeightSum over the image
    window (render.cpp:208-228).  Returns (H, W, 4) RGBA."""
    fb = filter_bounds
    crop = film[fb : fb + image_height, fb : fb + image_width]
    return crop[..., :4] / crop[..., 4:5]

