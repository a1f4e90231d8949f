"""Pinhole camera (port of computeraytracer_tpu/ops/camera.py).

Keeps the reference camera model and its quirks:
- right-handed basis from eye/lookat/up;
- ``focalLength`` is a vertical FOV in radians
  (viewport_height = 2*tan(f/2));
- the sub-pixel jitter uses stratum (sample % 16) plus one uniform in
  BOTH s and t (the same stratum on both axes), and t runs from the
  bottom: t = (H - py + jitter) / H.

Square roots go through ``sqrt`` below: torch's CPU ``sqrt`` is not
correctly rounded, and ray directions must match the JAX package's to
the last bit where they can. For the same reason the camera basis
rounds as the JAX package's does: ``jnp.cross`` and ``jnp.linalg.norm``
are jitted, and XLA contracts their products into fused multiply-adds
(a1*b2 - a2*b1 as fma(a1, b2, -(a2*b1)); the squared norm as
fma(v2, v2, fma(v1, v1, v0*v0))), which ``_fma`` rounds once as they
do. (The tangent of the half fov is each framework's own: torch's CPU
``tan`` and XLA's differ in the last bit at a few percent of arguments.)
"""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.ops import rng


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device.

    On the CPU the root is taken in float64 and rounded once to f32,
    which is exact; CUDA's f32 sqrt is IEEE-exact already."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _fma(a, b, c):
    """a * b + c of f32 tensors, rounded once to f32 (a fused
    multiply-add). The product is exact in float64; the sum is rounded to
    float64 by round-to-odd (TwoSum's error picks the odd neighbour),
    after which rounding to f32 is the single rounding of the exact
    value. Differentiable in a, b and c."""
    p = a.double() * b.double()
    s = p + c.double()
    with torch.no_grad():
        back = s - p
        err = (p - (s - back)) + (c.double() - back)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
        bump = torch.where((err != 0) & even, torch.nextafter(s, toward) - s,
                           torch.zeros_like(s))
    return (s + bump).float()


def _cross(a, b):
    return torch.stack([_fma(a[1], b[2], -(a[2] * b[1])),
                        _fma(a[2], b[0], -(a[0] * b[2])),
                        _fma(a[0], b[1], -(a[1] * b[0]))])


def _norm(v):
    return sqrt(_fma(v[2], v[2], _fma(v[1], v[1], v[0] * v[0])))


def _normalize(v):
    return v / _norm(v)


def camera_basis(eye, lookat, up):
    """Returns (u, v, w), each (3,)."""
    w = _normalize(eye - lookat)
    u = _normalize(_cross(up, w))
    v = _cross(w, u)
    return u, v, w


def _aspect(width, height, device):
    """width / height as an f32 0-dim tensor on device, divided there: a
    host tensor copied to the card would make the host wait for it."""
    f32 = dict(dtype=torch.float32, device=device)
    return torch.full((), float(width), **f32) / torch.full((), float(height),
                                                            **f32)


def film_frame(eye, lookat, up, fov, width, height):
    """(lower_left, horizontal, vertical) film-plane frame: a film point
    (s, t) maps to direction lower_left + s*horizontal + t*vertical - eye."""
    u, v, w = camera_basis(eye, lookat, up)
    viewport_h = 2.0 * torch.tan(fov / 2.0)
    viewport_w = _aspect(width, height, fov.device) * viewport_h
    horizontal = viewport_w * u
    vertical = viewport_h * v
    lower_left = eye - horizontal / 2.0 - vertical / 2.0 - w
    return lower_left, horizontal, vertical


def _jitter(sample, us, ut, stratified):
    if not stratified:
        return us, ut
    stratum = float(int(sample) % C.GRID_SIZE)
    inv_grid = 1.0 / C.GRID_SIZE
    return (stratum + us) * inv_grid, (stratum + ut) * inv_grid


def _film_st(width, height, px, py, js, jt):
    # divided by 0-dim tensors on the pixels' device: on the card, torch
    # divides by a Python number as a product with its rounded reciprocal,
    # which is not the JAX package's (or the CPU's) correctly rounded
    # division
    f32 = dict(dtype=torch.float32, device=px.device)
    s = (px.to(torch.float32) + js) / torch.full((), float(width), **f32)
    t = ((float(height) - py.to(torch.float32) + jt)
         / torch.full((), float(height), **f32))
    return s, t


def film_coords(width, height, px, py, sample, seed, stratified=True):
    """Jittered film coordinates (s, t) for pixels px, py (...,) on
    (..., 4) state. Two draws, s then t. Returns (s, t, new_seed)."""
    us, seed = rng.rand(seed)
    ut, seed = rng.rand(seed)
    js, jt = _jitter(sample, us, ut, stratified)
    s, t = _film_st(width, height, px, py, js, jt)
    return s, t, seed


def film_ray(eye, lower_left, horizontal, vertical, s, t):
    """Ray through film point (s, t) -> (o (..., 3), d (..., 3))."""
    d = (lower_left + s[..., None] * horizontal + t[..., None] * vertical
         - eye)
    d = d / sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                 + d[..., 2] * d[..., 2])[..., None]
    return eye.expand(d.shape), d


def world_to_film(eye, lookat, up, fov, width, height, x):
    """Project world points x (..., 3) back to film coordinates (s, t).

    The inverse of film_ray up to normalization: the warped-area
    reparameterization (ops/warp.py) expresses the screen-space velocity
    of a surface point with it. Points at or behind the eye give finite
    values (their depth is floored at 1e-6); callers mask those lanes."""
    u, v, w = camera_basis(eye, lookat, up)
    viewport_h = 2.0 * torch.tan(fov / 2.0)
    viewport_w = _aspect(width, height, fov.device) * viewport_h
    dirv = x - eye
    nw = -w
    denom = (dirv[..., 0] * nw[0] + dirv[..., 1] * nw[1]
             + dirv[..., 2] * nw[2])
    denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
    dn = dirv / denom[..., None]
    s = ((dn[..., 0] * u[0] + dn[..., 1] * u[1] + dn[..., 2] * u[2])
         + viewport_w / 2.0) / viewport_w
    t = ((dn[..., 0] * v[0] + dn[..., 1] * v[1] + dn[..., 2] * v[2])
         + viewport_h / 2.0) / viewport_h
    return s, t


def camera_rays(eye, lookat, up, fov, width, height, px, py, sample, seed):
    """Jittered primary rays for pixels px, py (...,) on (..., 4) state.
    Returns (origins (..., 3), directions (..., 3), new_seed)."""
    frame = film_frame(eye, lookat, up, fov, width, height)
    s, t, seed = film_coords(width, height, px, py, sample, seed)
    o, d = film_ray(eye, *frame, s, t)
    return o, d, seed


def camera_rays_p(eye, lookat, up, fov, width, height, px, py, sample,
                  seed_p, stratified: bool = True):
    """camera_rays in planar layout: px, py (R,), seed_p (4, R) ->
    (origins (3, R), directions (3, R), new_seed (4, R)), in the JAX
    package's op order."""
    lower_left, horizontal, vertical = film_frame(eye, lookat, up, fov,
                                                 width, height)
    us, seed_p = rng.rand_p(seed_p)
    ut, seed_p = rng.rand_p(seed_p)
    js, jt = _jitter(sample, us, ut, stratified)
    s, t = _film_st(width, height, px, py, js, jt)
    d = (lower_left[:, None] + s[None, :] * horizontal[:, None]
         + t[None, :] * vertical[:, None] - eye[:, None])     # (3, R)
    norm = sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = d / norm
    o = eye[:, None].expand(d.shape)
    return o, d, seed_p
