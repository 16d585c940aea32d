"""Bit-exact Marsaglia Xorshift32 RNG streams over ray wavefronts.

Counterpart of ``nart_tpu/rng.py`` (reference rng.h: Xorshift32 13/17/5 with
a golden-ratio output scramble).  States are uint32 values held in int64
tensors: torch has no ``<<``, ``>>`` or comparisons for ``uint32`` on the
CPU, so every step works in int64 and masks with ``& 0xFFFFFFFF``.  32x32-bit
products are split into 16-bit halves (``mul32``) so that no intermediate
leaves the int64 range — signed wrap-around is never relied on.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MARSAGLIA_SEED = 2463534242
_SCRAMBLE_F = 0x9E3779BB  # float path (rng.h UniformFloat)
_SCRAMBLE_I = 0x9E3779B9  # int path (rng.h UniformInt32)
_INV_2_32 = 2.3283064365386963e-10  # 2**-32, exact in f32
_ONE_MINUS_EPS = 1.0 - 1.1920928955078125e-07  # exact in f32


def mul32(a, b: int):
    """(a * b) mod 2**32 for uint32 values a (int64 tensor) and constant b.

    a = a_hi * 2**16 + a_lo: a_lo * b < 2**48, and only the low 16 bits of
    a_hi * b survive the shift, so every intermediate stays below 2**63."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + (((a_hi * b) & 0xFFFF) << 16)) & MASK32


def seed(pixel_index):
    """RNG::Seed — state = seed + 2463534242 (uint32 wrap).  rng.h:10-13."""
    return (pixel_index.to(torch.int64) + _MARSAGLIA_SEED) & MASK32


def _xorshift(y):
    """One Xorshift32 step (13/17/5).  rng.h:24-27."""
    y = y ^ ((y << 13) & MASK32)
    y = y ^ (y >> 17)
    y = y ^ ((y << 5) & MASK32)
    return y


def next_float(y):
    """RNG::UniformFloat — returns (value, new_state).  rng.h:15-41.

    value = min(1 - eps, float32(state * 0x9E3779BB) * 2^-32).
    """
    y = _xorshift(y)
    scrambled = mul32(y, _SCRAMBLE_F)
    f = scrambled.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=_ONE_MINUS_EPS), y


def _umulhi_small(a, b):
    """High 32 bits of uint32 a * b for 0 <= b < 2**31 (a product below
    2**63: exact in int64).  b may be a tensor or an int."""
    return (a * b) >> 32


def next_int32(y, max_inclusive):
    """RNG::UniformInt32(max) — returns (value in [0, max], new_state).

    rng.h:43-56: multiply-high remap of the scrambled state onto [0, max+1).
    """
    y = _xorshift(y)
    scrambled = mul32(y, _SCRAMBLE_I)
    return _umulhi_small(scrambled, max_inclusive + 1), y


def masked_next_float(y, mask):
    """Draw a float only on lanes where ``mask``; other lanes keep state."""
    f, y_new = next_float(y)
    return f, torch.where(mask, y_new, y)

