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
the last bit where they can.
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


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _normalize(v):
    return v / sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def camera_basis(eye, lookat, up):
    """Returns (u, v, w), each (3,)."""
    w = _normalize(eye - lookat)
    u = _normalize(_cross(up, w))
    v = _cross(w, u)
    return u, v, w


def film_frame(eye, lookat, up, fov, width, height):
    """(lower_left, horizontal, vertical) film-plane frame: a film point
    (s, t) maps to direction lower_left + s*horizontal + t*vertical - eye."""
    u, v, w = camera_basis(eye, lookat, up)
    aspect = torch.tensor(width, dtype=torch.float32) / float(height)
    viewport_h = 2.0 * torch.tan(fov / 2.0)
    viewport_w = aspect.to(fov.device) * viewport_h
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
    s = (px.to(torch.float32) + js) / float(width)
    t = (float(height) - py.to(torch.float32) + jt) / float(height)
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
