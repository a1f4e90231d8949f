"""Spectral sampling (port of computeraytracer_tpu/ops/spectrum.py).

Host part (NumPy, same float64 -> float32 steps as the JAX package, so
loaded tables are equal bit for bit): ``resample_spectrum`` and
``cie_1931_tables``.

Device part (torch): hero-wavelength sampling, the hero-expanded
spectra and CIE tables, the per-ray spectra lookup of the eager tracer
(``sample_spectrum``) and the Riemann spectral -> XYZ sum. The hero
gather ``gather_hero`` (``gather_hero_tables`` for the spectra and CIE
tables in one launch; ``HeroGatherFn``) is the column index
``table[:, hero]`` with the JAX package's scatter-free backward: fixed-
order column sums of the cotangent, not the scatter-add of an indexing
backward (kernels/setup.py; its kernels on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops.intersect import take
from computeraytracer_tpu_torch.utils import profiling

# ---------------------------------------------------------------------------
# Host-side (NumPy) preparation
# ---------------------------------------------------------------------------


def resample_spectrum(wavelengths, values, lambda_min=C.LAMBDA_MIN,
                      lambda_max=C.LAMBDA_MAX) -> np.ndarray:
    """Resample sparse (wavelength, value) pairs to a dense 1nm table:
    find-first wavelength >= lambda, then lerp from its predecessor."""
    wl = np.asarray(wavelengths, np.float64)
    vals = np.asarray(values, np.float64)
    n = int(lambda_max - lambda_min) + 1
    out = np.empty(n, np.float32)
    for i in range(n):
        lam = lambda_min + i
        idx = int(np.searchsorted(wl, lam, side="left"))
        if idx >= len(wl):
            out[i] = vals[-1]
            continue
        start_i = max(idx - 1, 0)
        end_i = min(idx, len(wl) - 1)
        s_lam, e_lam = wl[start_i], wl[end_i]
        s_val, e_val = vals[start_i], vals[end_i]
        if s_lam == e_lam:
            out[i] = s_val
        else:
            t = (lam - s_lam) / (e_lam - s_lam)
            out[i] = s_val + t * (e_val - s_val)
    return out


def _gauss_lobe(x, mu, s1, s2):
    sigma = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def cie_1931_tables(n: int = C.CIE_N, start_nm: float = 360.0) -> np.ndarray:
    """(3, 471) CIE 1931 x̄ȳz̄ at 1nm from 360nm (analytic fit of Wyman,
    Sloan & Shirley 2013)."""
    lam = start_nm + np.arange(n, dtype=np.float64)
    x = (1.056 * _gauss_lobe(lam, 599.8, 37.9, 31.0)
         + 0.362 * _gauss_lobe(lam, 442.0, 16.0, 26.7)
         - 0.065 * _gauss_lobe(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _gauss_lobe(lam, 568.8, 46.9, 40.5)
         + 0.286 * _gauss_lobe(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _gauss_lobe(lam, 437.0, 11.8, 36.0)
         + 0.681 * _gauss_lobe(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z]).astype(np.float32)


# ---------------------------------------------------------------------------
# Device-side (torch)
# ---------------------------------------------------------------------------


def sample_wavelengths(seed):
    """Hero-wavelength draw on (..., 4) state.

    One uniform picks the hero index in [0, 301); companions at +4/+8/+12
    wrap mod 301. Returns (lambdas (..., 4) int64, new_seed)."""
    u, seed = rng.rand(seed)
    hero = setup_k.hero_index(u)
    n = C.N_LAMBDA
    lam = torch.stack([hero, (hero + 4) % n, (hero + 8) % n,
                       (hero + 12) % n], dim=-1)
    return lam, seed


def sample_wavelengths_p(seed_p):
    """Hero draw on planar (4, R) state -> (hero (R,) int64, new_seed).
    The companions are folded into expand_hero_table's rolled rows."""
    u, seed_p = rng.rand_p(seed_p)
    return setup_k.hero_index(u), seed_p


def expand_hero_table(table: torch.Tensor) -> torch.Tensor:
    """(K, 301) -> (K*4, 301): row k*4+j is table[k] rolled left by 4j,
    so ``expand_hero_table(T)[:, hero]`` holds T[k, (hero + 4j) % 301]."""
    rows = [torch.roll(table, -4 * j, dims=1) for j in range(C.N_HERO)]
    return torch.stack(rows, dim=1).reshape(-1, table.shape[1])


def cie_window_exp(cie: torch.Tensor) -> torch.Tensor:
    """(3, 471) CIE tables -> hero-expanded (12, 301) 400-700nm window
    (the +40 offset into the 360nm-based tables, pre-sliced)."""
    return expand_hero_table(cie[:, C.CIE_OFFSET:C.CIE_OFFSET + C.N_LAMBDA])


class HeroGatherFn(torch.autograd.Function):
    """table_exp[:, hero] of one or two hero-expanded tables in one launch
    (the JAX package gathers the spectra and CIE tables together with
    ``gather_hero_planar``, tracer/pallas.py:726-731, and ``take_cols``'
    scatter-free VJP): forward ``setup.hero_gather_tables``, backward
    ``setup.hero_column_sums`` of each table that needs a gradient, the
    cotangent's column sums by hero in a fixed order, so two runs give
    bit-equal gradients. The plane of a table that needs none is marked
    non-differentiable, so autograd computes no cotangent for it. hero
    gets no gradient. With no gradient wanted (grad mode off, or no table
    that needs one) it records nothing.

        planes = HeroGatherFn.apply(hero, *tables)  # one plane a table
    """

    @classmethod
    def apply(cls, hero, *tables):
        # needs_input_grad ignores no_grad: decide here
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tables)):
            return setup_k.hero_gather_tables(tables, hero)
        return super().apply(hero, *tables)

    @staticmethod
    def forward(ctx, hero, *tables):
        ctx.save_for_backward(hero)
        ctx.n_cols = tables[0].shape[1]
        planes = setup_k.hero_gather_tables(tables, hero)
        ctx.mark_non_differentiable(*(
            p for p, need in zip(planes, ctx.needs_input_grad[1:])
            if not need))
        return planes

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        (hero,) = ctx.saved_tensors
        with profiling.annotate("gather.backward"):
            return (None, *(
                setup_k.hero_column_sums(g.contiguous(), hero, ctx.n_cols)
                if need else None
                for g, need in zip(grads, ctx.needs_input_grad[1:])))


def gather_hero(table_exp: torch.Tensor, hero: torch.Tensor) -> torch.Tensor:
    """(K, 301) hero-expanded table, hero (R,) -> (K, R): HeroGatherFn."""
    return HeroGatherFn.apply(hero, table_exp)[0]


def gather_hero_tables(tables, hero: torch.Tensor) -> tuple:
    """One or two hero-expanded (K_i, 301) tables, hero (R,) -> their
    (K_i, R) planes, gathered in one launch: HeroGatherFn."""
    return HeroGatherFn.apply(hero, *tables)


_XYZ_SCALE = (C.LAMBDA_MAX - C.LAMBDA_MIN) / (C.CIE_Y_INTEG * C.N_HERO)


def spectral_to_xyz_p(cie_p: torch.Tensor,
                      radiance_p: torch.Tensor) -> torch.Tensor:
    """Riemann spectral -> XYZ in planar layout.

    cie_p (12, R) = gather_hero(cie_window_exp(cie), hero); radiance_p
    (4, R) -> xyz (3, R), summed in the JAX package's order."""
    b = cie_p.reshape(3, C.N_HERO, -1)
    xyz = ((b[:, 0] * radiance_p[0] + b[:, 1] * radiance_p[1])
           + b[:, 2] * radiance_p[2]) + b[:, 3] * radiance_p[3]
    return xyz * _XYZ_SCALE


def sample_spectrum(spectra: torch.Tensor, index: torch.Tensor,
                    lambdas: torch.Tensor) -> torch.Tensor:
    """spectra (S, 301), index (...,) int, lambdas (..., 4) -> (..., 4),
    spectra[index, lambdas]. Its backward accumulates into spectra with
    ``index_add_`` (atomics on the card, so the summation order may vary
    between runs)."""
    flat = index.long()[..., None] * spectra.shape[1] + lambdas
    return take(spectra.reshape(-1), flat)


def spectral_to_xyz(cie: torch.Tensor, radiance: torch.Tensor,
                    lambdas: torch.Tensor) -> torch.Tensor:
    """radiance (..., 4) at lambdas (..., 4) -> (..., 3) XYZ."""
    window = cie[:, C.CIE_OFFSET:C.CIE_OFFSET + C.N_LAMBDA]  # (3, 301)
    bars = window[:, lambdas]  # (3, ..., 4)
    xyz = ((bars[..., 0] * radiance[..., 0] + bars[..., 1] * radiance[..., 1])
           + bars[..., 2] * radiance[..., 2]) + bars[..., 3] * radiance[..., 3]
    return torch.movedim(xyz, 0, -1) * _XYZ_SCALE
