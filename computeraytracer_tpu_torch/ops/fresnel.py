"""Unpolarized Fresnel reflectance and reflect/refract (port of
computeraytracer_tpu/ops/fresnel.py): (Rs^2 + Rp^2) / 2 with the eta swap
on cosi > 0 and total internal reflection -> 1; reflect and refract with
the WGSL built-ins' semantics (refract returns 0 on TIR)."""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch.ops.intersect import (dot, maximum,
                                                      minimum, safe_sqrt)


def fresnel_s(ray_dir, normal, eta1: float, eta2: float):
    """Unpolarized Fresnel reflectance for unit ray_dir, normal (..., 3)."""
    cosi = minimum(maximum(dot(ray_dir, normal), -1.0), 1.0)
    eta = torch.where(cosi > 0.0, eta2 / eta1, eta1 / eta2)
    sint2 = eta * eta * (1.0 - cosi * cosi)
    tir = sint2 > 1.0
    cost = safe_sqrt(1.0 - sint2)
    cosi_a = cosi.abs()
    rs = (eta1 * cosi_a - eta2 * cost) / (eta1 * cosi_a + eta2 * cost)
    rp = (eta2 * cosi_a - eta1 * cost) / (eta2 * cosi_a + eta1 * cost)
    return torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def reflect(incident, normal):
    """WGSL reflect: i - 2 dot(n, i) n."""
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def refract(incident, normal, eta):
    """WGSL refract, the zero vector on total internal reflection; eta
    (...,) is the ratio eta_i / eta_t."""
    ndoti = dot(normal, incident)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    tir = k < 0.0
    out = (eta[..., None] * incident
           - (eta * ndoti + safe_sqrt(k))[..., None] * normal)
    return torch.where(tir[..., None], 0.0, out)
