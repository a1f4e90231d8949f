"""Sampling routines (port of computeraytracer_tpu/ops/sampling.py):
the MIS power heuristic, cosine-weighted hemisphere directions, uniform
light selection, points on rectangular area lights and the light's
solid-angle pdf.

The NaN guards of the JAX package are kept: the ratio form of the power
heuristic and the pdf clip at 1e16. ``abs`` at exactly 0 has gradient 0
in torch and 1 in JAX (``cosine_hemisphere``'s ``z_minor`` takes no
gradient; ``light_solid_angle_pdf``'s |cos| is floored at 1e-5 first).
"""

from __future__ import annotations

import math

import torch

from computeraytracer_tpu_torch.ops.intersect import (cross, dot, maximum,
                                                      minimum,
                                                      safe_normalize,
                                                      safe_sqrt)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Power heuristic (beta = 2) in the ratio form 1 / (1 + (g/f)^2):
    its backward stays finite for any finite ratio, where the textbook
    form's squared denominator underflows to 0 for pdfs below ~1e-10."""
    f = nf * f_pdf
    g = ng * g_pdf
    r = g / maximum(f, 1e-12)
    return 1.0 / (1.0 + r * r)


def cosine_hemisphere(normal, u, v):
    """Cosine-weighted direction about normal (..., 3) from two uniforms.

    Returns (direction (..., 3), pdf (...,)), pdf = cos(theta) / pi."""
    r = safe_sqrt(u)
    theta = 2.0 * math.pi * v
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = safe_sqrt(1.0 - u)
    z_minor = normal[..., 2].abs() < 0.999
    up = torch.where(
        z_minor[..., None],
        normal.new_tensor([0.0, 0.0, 1.0]),
        normal.new_tensor([1.0, 0.0, 0.0]),
    )
    tangent = safe_normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    direction = (tangent * x[..., None] + bitangent * y[..., None]
                 + normal * z[..., None])
    pdf = z / math.pi
    return direction, pdf


def pick_light(u, n_lights: int):
    """Uniform light index from one uniform (int64)."""
    idx = (u * float(n_lights)).to(torch.int64)
    return idx.clamp(0, n_lights - 1)


def point_on_light(origin, edge1, edge2, u, v):
    """Uniform point on a rectangular area light."""
    return origin + u[..., None] * edge1 + v[..., None] * edge2


def light_solid_angle_pdf(edge1, edge2, n_lights, normal_at_light,
                          ray_direction, light_position, ray_origin):
    """Solid-angle pdf of sampling the point hit on an area light:
    (1/area) / (|cos| / d^2) / n_lights with |cos| floored at 1e-5,
    clipped to [0, 1e16] so that masked lanes on degenerate geometry stay
    finite (pdf^2 must not overflow inside the power heuristic)."""
    area = safe_sqrt(dot(edge1, edge1)) * safe_sqrt(dot(edge2, edge2))
    abs_cos = maximum(dot(normal_at_light, -ray_direction).abs(), 1e-5)
    delta = light_position - ray_origin
    dist2 = dot(delta, delta)
    geometric = abs_cos / maximum(dist2, 1e-12)
    pdf = (1.0 / maximum(area, 1e-12)) / geometric / float(n_lights)
    return minimum(maximum(pdf, 0.0), 1e16)
