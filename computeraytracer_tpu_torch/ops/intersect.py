"""Watertight ray/triangle test (port of the triangle part of
computeraytracer_tpu/ops/intersect.py).

Triangles store VERTICES (v0, v1, v2), not edges: watertightness along a
shared edge needs both triangles to test bitwise-identical endpoints.
The inside test is the shear-constant edge-function test of Woop,
Benthin and Wald (2013, "Watertight Ray/Triangle Intersection"), with
both orientations accepted; t comes from the plane test that patches
use, in the megakernel's op order.

Every edge function is a difference of two SEPARATELY rounded products.
Eager torch rounds each op on its own, and the CUDA kernels are built
with ``--fmad=false``; an FMA would round the first product once with
the subtraction and break the exact negation between the two triangles
of a shared edge, letting rays fall through it.

All functions take 3-tuples of broadcastable tensors (component planes)
and never take a square root except through ``ops/camera.py:sqrt``.
"""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch.ops.camera import sqrt


def _sel3(k, v):
    """Component k (an int tensor in {0, 1, 2}) of a 3-tuple of tensors."""
    return torch.where(k == 0, v[0], torch.where(k == 1, v[1], v[2]))


def watertight_setup(o3, d3):
    """Per-ray constants of the watertight test: kz is the axis of the
    direction's largest magnitude, kx and ky the cyclic others; sx and sy
    shear the triangle into ray space. Returns (kx, ky, kz, sx, sy, okx,
    oky, okz)."""
    ax, ay, az = d3[0].abs(), d3[1].abs(), d3[2].abs()
    kz = torch.where((ax >= ay) & (ax >= az), 0,
                     torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    dkz = _sel3(kz, d3)
    safe = torch.where(dkz == 0.0, 1.0, dkz)  # dkz == 0 only for null rays
    sx = _sel3(kx, d3) / safe
    sy = _sel3(ky, d3) / safe
    return (kx, ky, kz, sx, sy, _sel3(kx, o3), _sel3(ky, o3), _sel3(kz, o3))


def watertight_inside(setup, v0, v1, v2):
    """True where the sheared ray passes through triangle (v0, v1, v2).

    A shared edge evaluates the same f32 edge function with opposite
    sign in its two triangles, so with both signs accepted one of them
    always passes; an edge function of exactly 0 is accepted by both."""
    kx, ky, kz, sx, sy, okx, oky, okz = setup

    def shear2(v):
        pkx = _sel3(kx, v) - okx
        pky = _sel3(ky, v) - oky
        pkz = _sel3(kz, v) - okz
        return pkx - sx * pkz, pky - sy * pkz

    ax_, ay_ = shear2(v0)
    bx_, by_ = shear2(v1)
    cx_, cy_ = shear2(v2)
    u = cx_ * by_ - cy_ * bx_
    v = ax_ * cy_ - ay_ * cx_
    w = bx_ * ay_ - by_ * ax_
    pos = (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    neg = (u <= 0.0) & (v <= 0.0) & (w <= 0.0)
    det = u + v + w
    return (pos | neg) & (det != 0.0)


def unit_normal(v0, v1, v2):
    """Unit plane normal of a triangle, cross(v1 - v0, v2 - v0) over its
    length floored at 1e-30 (the megakernel's per-primitive constant)."""
    e1 = (v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2])
    e2 = (v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2])
    n = (e1[1] * e2[2] - e1[2] * e2[1],
         e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0])
    n_len2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    inv_len = 1.0 / sqrt(torch.clamp(n_len2, min=1e-30))
    return (n[0] * inv_len, n[1] * inv_len, n[2] * inv_len)


def plane_t(n0, p0, o3, d3):
    """Plane hit distance along d from o for the plane through p0 with
    unit normal n0. Returns (t, flip, grazing): flip where the normal
    faces along the ray, grazing where |n0.d| < 1e-4 (t is then a
    placeholder)."""
    ndotd = n0[0] * d3[0] + n0[1] * d3[1] + n0[2] * d3[2]
    flip = ndotd > 0.0
    grazing = torch.where(flip, -ndotd, ndotd).abs() < 1e-4
    num = (n0[0] * (p0[0] - o3[0]) + n0[1] * (p0[1] - o3[1])
           + n0[2] * (p0[2] - o3[2]))
    return num / torch.where(grazing, 1.0, ndotd), flip, grazing


def triangle_candidates(o3, d3, v0, v1, v2):
    """Watertight ray/triangle test: (t, valid), range and exclusion not
    yet applied."""
    t, _, grazing = plane_t(unit_normal(v0, v1, v2), v0, o3, d3)
    inside = watertight_inside(watertight_setup(o3, d3), v0, v1, v2)
    return t, ~grazing & inside
