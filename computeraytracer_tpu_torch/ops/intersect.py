"""Ray/primitive intersection (port of computeraytracer_tpu/ops/intersect.py).

Two layouts:
- component tuples (``watertight_setup``, ``watertight_inside``,
  ``unit_normal``, ``plane_t``, ``triangle_candidates_c``), which the
  plain kernel versions use;
- ``(..., 3)`` tensors broadcast over rays x primitives
  (``patch_candidates``, ``sphere_candidates``, ``triangle_candidates``,
  ``scene_candidates``, ``shading_normal``, ``intersect_brute``), which
  the eager tracer (``tracer/xla.py``) and the BVH traversal use, with
  the JAX signatures. Every guard of the JAX package is kept (the double
  ``where`` of ``safe_sqrt`` and ``safe_normalize``), so gradients stay
  finite on masked lanes; ``jnp.maximum`` with a constant is
  ``torch.maximum`` with a tensor operand, which splits the gradient at
  a tie as JAX does (``clamp`` would not). Dot products are summed left
  to right, component by component.

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

from typing import NamedTuple

import torch

from computeraytracer_tpu_torch.ops.camera import sqrt

T_MIN = 0.001
INF = float("inf")
NO_INDEX = -1  # stands in for the reference's MAX_U32_VALUE

CAT_PATCH = 0
CAT_SPHERE = 1
CAT_TRIANGLE = 2


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (leading dims = ray batch)."""

    hit: torch.Tensor          # bool
    t: torch.Tensor            # f32
    index: torch.Tensor        # int global primitive index (-1 if miss)
    position: torch.Tensor     # (..., 3)
    normal: torch.Tensor       # (..., 3) flipped toward the ray
    emission: torch.Tensor     # int spectrum index
    reflectance: torch.Tensor
    material: torch.Tensor     # int


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along the first axis for an integer index tensor of
    any shape; negative indices wrap, as in JAX. Through index_select,
    whose backward is index_add_ (atomics on the card): advanced
    indexing's backward sorts the indices and walks each row's duplicates
    serially, which is slow when a million rays gather a few rows."""
    idx = idx.long()
    flat = torch.where(idx < 0, idx + table.shape[0], idx).reshape(-1)
    return table.index_select(0, flat).reshape(idx.shape + table.shape[1:])


def row_sums(idx, g, n_rows: int, block: int):
    """(n_rows, k) sums of the rows of g (R, k) that share an index of idx
    (R,), in a fixed order: within each block of ``block`` consecutive
    rays in ray order, then over the blocks in order. A sort groups the
    (index, block) keys and two segment sums add them up, so a row that
    most rays hit (a wall, the light, the row that misses gather) is
    summed in parallel over its blocks; a per-duplicate scatter
    (``index_put_`` with accumulate) walks such a row serially, and
    ``index_add_`` on the card uses atomics, whose order changes from run
    to run."""
    n_blocks = -(-idx.shape[0] // block)
    blk = torch.arange(idx.shape[0], device=idx.device) // block
    key = idx * n_blocks + blk
    order = torch.argsort(key, stable=True)
    keys, lengths = torch.unique_consecutive(key[order], return_counts=True)
    partial = torch.segment_reduce(g[order], "sum", lengths=lengths, axis=0)
    rows, lengths = torch.unique_consecutive(keys // n_blocks,
                                             return_counts=True)
    out = g.new_zeros((n_rows, g.shape[1]))
    out[rows] = torch.segment_reduce(partial, "sum", lengths=lengths, axis=0)
    return out


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c) for a constant c: at a tie the gradient is split
    in half, as in JAX."""
    return torch.maximum(x, x.new_full((), c))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.minimum(x, c) for a constant c (ties split as in JAX)."""
    return torch.minimum(x, x.new_full((), c))


def dot(a, b):
    """Sum of a * b over the last axis of size 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    """Cross product over the last axis (separately rounded products)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def safe_normalize(v, eps=1e-20):
    """v / |v| with NaN-free gradients at v ~= 0: the sum of squares is
    replaced by 1 below eps before the root (the double-where guard).
    For |v| >= 1e-10 the result is v / |v| bit for bit."""
    s = dot(v, v)
    s = torch.where(s < eps, 1.0, s)
    return v / sqrt(s)[..., None]


def safe_sqrt(x, eps=0.0):
    """sqrt with a NaN-free gradient for x <= 0 (value eps there)."""
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), eps)


def patch_candidates(o, d, origin, edge1, edge2):
    """Ray-vs-patch t for broadcast shapes; returns (t, valid).

    o, d: (..., 3); origin/edge1/edge2: broadcastable to (..., 3)."""
    n = safe_normalize(cross(edge1, edge2))
    ndotd = dot(n, d)
    # flip toward the ray; after the flip ndotd <= 0
    n = torch.where(ndotd[..., None] > 0, -n, n)
    ndotd = torch.where(ndotd > 0, -ndotd, ndotd)
    grazing = ndotd.abs() < 1e-4
    safe_ndotd = torch.where(grazing, 1.0, ndotd)
    t = dot(n, origin - o) / safe_ndotd
    p = o + t[..., None] * d
    m = p - origin
    u = dot(m, edge1) / maximum(dot(edge1, edge1), 1e-12)
    v = dot(m, edge2) / maximum(dot(edge2, edge2), 1e-12)
    valid = (~grazing) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return t, valid


def sphere_candidates(o, d, center, radius, t_min, t_max):
    """Ray-vs-sphere t with near-then-far root selection; (t, valid)."""
    co = o - center
    a = dot(d, d)
    b = 2.0 * dot(d, co)
    c = dot(co, co) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc > 0.0
    sq = safe_sqrt(disc)
    # guard the 2a denominator for degenerate (zero-direction) rays
    denom = torch.where(a > 1e-12, 2.0 * a, 1.0)
    t_near = (-b - sq) / denom
    t_far = (-b + sq) / denom
    has_root = has_root & (a > 1e-12)
    near_ok = (t_near >= t_min) & (t_near <= t_max)
    t = torch.where(near_ok, t_near, t_far)
    valid = has_root & (t >= t_min) & (t <= t_max)
    return t, valid


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


def triangle_candidates_c(o3, d3, v0, v1, v2):
    """Watertight ray/triangle test on component tuples: (t, valid),
    range and exclusion not yet applied."""
    t, _, grazing = plane_t(unit_normal(v0, v1, v2), v0, o3, d3)
    inside = watertight_inside(watertight_setup(o3, d3), v0, v1, v2)
    return t, ~grazing & inside


def _comps(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def triangle_candidates(o, d, v0, v1, v2):
    """Watertight ray/triangle test on (..., 3) tensors; (t, valid).

    v0/v1/v2 are VERTICES (the category-2 convention). d should be unit
    length: the |n.d| < 1e-4 grazing cutoff compares a unit normal with
    d."""
    return triangle_candidates_c(_comps(o), _comps(d), _comps(v0),
                                 _comps(v1), _comps(v2))


def scene_candidates(o, d, prims, t_min=T_MIN):
    """All-primitive candidate ts for rays o, d of shape (..., 3).

    Returns (t (..., P), valid (..., P)); exclusion not yet applied (the
    sphere root selection needs the t range, so it is applied here)."""
    ob = o[..., None, :]
    db = d[..., None, :]
    t_p, ok_p = patch_candidates(ob, db, prims.data1, prims.data2,
                                 prims.data3)
    t_s, ok_s = sphere_candidates(ob, db, prims.data1, prims.data2[..., 0],
                                  t_min, INF)
    t_t, ok_t = triangle_candidates(ob, db, prims.data1, prims.data2,
                                    prims.data3)
    cat = prims.category
    t = torch.where(cat == CAT_PATCH, t_p,
                    torch.where(cat == CAT_SPHERE, t_s, t_t))
    ok = torch.where(cat == CAT_PATCH, ok_p,
                     torch.where(cat == CAT_SPHERE, ok_s, ok_t))
    return t, ok & (t >= t_min)


def shading_normal(prims, idx, o, d, position):
    """Geometric normal of primitive idx at position, flipped toward -d
    (spheres keep the outward normal)."""
    cat = take(prims.category, idx)
    d1 = take(prims.data1, idx)
    d2 = take(prims.data2, idx)
    d3 = take(prims.data3, idx)
    # patches store edges in data2/3; triangles store vertices
    is_tri = (cat == CAT_TRIANGLE)[..., None]
    e1 = torch.where(is_tri, d2 - d1, d2)
    e2 = torch.where(is_tri, d3 - d1, d3)
    n_flat = cross(e1, e2)
    n_sph = position - d1
    n = safe_normalize(torch.where((cat == CAT_SPHERE)[..., None], n_sph,
                                   n_flat))
    flip = (dot(n, d) > 0) & (cat != CAT_SPHERE)
    return torch.where(flip[..., None], -n, n)


def hit_record(prims, winner, hit, t_hit, o, d) -> Hit:
    """The Hit of primitive rows winner (...,) at distance t_hit where
    hit, gathered and recomputed differentiably."""
    t_safe = torch.where(hit, t_hit, 0.0)
    position = o + t_safe[..., None] * d
    return Hit(
        hit=hit,
        t=t_safe,
        index=torch.where(hit, take(prims.index, winner).long(), NO_INDEX),
        position=position,
        normal=shading_normal(prims, winner, o, d, position),
        emission=take(prims.emission, winner).long(),
        reflectance=take(prims.reflectance, winner).long(),
        material=take(prims.material, winner),
    )


def intersect_brute(o, d, exclude, prims, t_min=T_MIN) -> Hit:
    """Closest hit over all primitives by linear scan.

    o, d: (..., 3); exclude: (...,) primitive index (-1 = none). The LAST
    primitive wins exact-t ties, as in the reference's in-order scan (the
    Cornell light is coplanar with the ceiling and packed after it):
    argmin, which returns the first minimum, runs over the reversed
    primitive axis."""
    t, ok = scene_candidates(o, d, prims, t_min)
    ok = ok & (prims.index != exclude[..., None])
    t_masked = torch.where(ok, t, INF)
    n_prims = t_masked.shape[-1]
    winner = (n_prims - 1) - torch.argmin(t_masked.flip(-1), dim=-1)
    t_hit = torch.gather(t_masked, -1, winner[..., None])[..., 0]
    return hit_record(prims, winner, torch.isfinite(t_hit), t_hit, o, d)
