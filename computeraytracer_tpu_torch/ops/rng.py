"""Counter-style TEA + pcg4d RNG (port of computeraytracer_tpu/ops/rng.py).

The state of a ray is four u32 words seeded from (pixel, sample) and
advanced by pcg4d on every draw, so every implementation that follows
the tracer's draw order reproduces the same stream bit for bit.

u32 words live in int64 tensors holding values in [0, 2^32): torch's
CPU uint32 has no add, shift or compare. Every add, multiply and left
shift is reduced with ``& 0xFFFFFFFF``; int64 multiplication wraps
modulo 2^64, which keeps the low 32 bits exact. Right shifts only ever
see reduced (non-negative) words.

Layouts: ``(..., 4)`` state (``seed_pixel``, ``pcg4d``, ``rand``,
``rand_masked``) and planar ``(4, R)`` state (the ``_p`` variants).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF

# TEA round constants ("GPU Random Numbers via the Tiny Encryption
# Algorithm").
_TEA_DELTA = 0x9E3779B9
_TEA_K0, _TEA_K1 = 0xA341316C, 0xC8013EA4
_TEA_K2, _TEA_K3 = 0xAD90777D, 0x7E95761E

_PCG_A, _PCG_C = 1664525, 1013904223


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor/array/int -> int64 tensor of u32 values."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK


def tea(val0, val1, rounds: int = 16) -> torch.Tensor:
    """TEA hash of two u32 words; returns u32 words (int64)."""
    v0 = as_u32(val0)
    v1 = as_u32(val1)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + _TEA_DELTA) & MASK
        v0 = (v0 + ((((v1 << 4) + _TEA_K0) ^ (v1 + s0)
                     ^ ((v1 >> 5) + _TEA_K1)) & MASK)) & MASK
        v1 = (v1 + ((((v0 << 4) + _TEA_K2) ^ (v0 + s0)
                     ^ ((v0 >> 5) + _TEA_K3)) & MASK)) & MASK
    return v0


def _seed_words(px, py, sample):
    px = as_u32(px)
    py = as_u32(py, px.device)
    sample = as_u32(sample, px.device)
    return [py, (px * 100) & MASK, sample.expand(px.shape),
            tea(px, (py * 100) & MASK)]


def seed_pixel(px, py, sample) -> torch.Tensor:
    """Initial (..., 4) state: (y, x*100, sample, tea(x, y*100))."""
    return torch.stack(_seed_words(px, py, sample), dim=-1)


def seed_pixel_p(px, py, sample) -> torch.Tensor:
    """seed_pixel in planar (4, R) layout."""
    return torch.stack(_seed_words(px, py, sample), dim=0)


def pcg4d_words(x, y, z, w):
    x = (x * _PCG_A + _PCG_C) & MASK
    y = (y * _PCG_A + _PCG_C) & MASK
    z = (z * _PCG_A + _PCG_C) & MASK
    w = (w * _PCG_A + _PCG_C) & MASK
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    return x, y, z, w


def pcg4d(seed: torch.Tensor) -> torch.Tensor:
    """One pcg4d advance of (..., 4) state, with the sequential
    component mixing of the reference."""
    return torch.stack(pcg4d_words(*seed.unbind(-1)), dim=-1)


def pcg4d_p(seed: torch.Tensor) -> torch.Tensor:
    """pcg4d on planar (4, R) state."""
    return torch.stack(pcg4d_words(*seed.unbind(0)), dim=0)


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """u32 word -> f32 in [0, 1) from the low 24 bits (exact)."""
    return (bits & 0x00FFFFFF).to(torch.float32) * (1.0 / 0x01000000)


def rand(seed):
    """Advance (..., 4) state and draw one uniform -> (u, new_seed)."""
    new_seed = pcg4d(seed)
    return to_unit_float(new_seed[..., 0]), new_seed


def rand_p(seed):
    """rand on planar (4, R) state -> (u (R,), new_seed (4, R))."""
    new_seed = pcg4d_p(seed)
    return to_unit_float(new_seed[0]), new_seed


def rand_masked(seed, mask):
    """Draw only on lanes where mask is True; other lanes keep their
    state and get u = 0. (..., 4) state, mask (...,)."""
    new_seed = pcg4d(seed)
    u = to_unit_float(new_seed[..., 0])
    return (torch.where(mask, u, 0.0),
            torch.where(mask[..., None], new_seed, seed))
