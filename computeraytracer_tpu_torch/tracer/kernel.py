"""Megakernel tracer: the port of the non-mesh, ``backward="pallas"``
part of computeraytracer_tpu/tracer/pallas.py.

Camera ray generation, hero-wavelength sampling, the per-ray spectra
planes and the CIE conversion run as torch ops; the trace itself is one
call of ``kernels.megakernel.TraceFn`` per sample (the CUDA kernels for
a scene on the card, their plain torch versions for a scene on the CPU).

One layout is ported: the planar (k, R) path the kernel consumes, with
pixels in ``tile_coords`` row-major order. ``render_sample`` is its
(H, W, 3) transpose; the JAX package documents the two layouts as
bit-identical.

Differentiation: ``TraceFn``'s backward is the backward megakernel
(replay plus reverse adjoint sweep), which returns cotangents for the
primitive table, the per-ray spectra planes and the rays; autograd
carries them on through ``pack_prims``, the hero gather and the camera
to every scene leaf (geometry, spectra, camera). A render with no tensor
that requires grad launches only the forward kernel.
"""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops import spectrum as spec

SceneStatic = mk.SceneStatic


def tile_coords(width: int, tile_h: int, y0: int, device=None):
    """Pixel coordinates (px, py) of film rows [y0, y0+tile_h), row-major,
    as int64 tensors."""
    ys = y0 + torch.arange(tile_h, dtype=torch.int64, device=device)
    xs = torch.arange(width, dtype=torch.int64, device=device)
    py = ys[:, None].expand(tile_h, width).reshape(-1)
    px = xs[None, :].expand(tile_h, width).reshape(-1)
    return px, py


def camera_planes(scene, width: int, height: int, px, py, sample):
    """Per-ray setup for pixels px, py (R,) at a 1-based sample index:
    seeds, jittered camera rays and the hero-wavelength draw.

    Returns (o (3, R), d (3, R), hero (R,), seed (4, R))."""
    seed = rng.seed_pixel_p(px, py, sample)
    cam = scene.camera
    o, d, seed = cam_ops.camera_rays_p(cam.eye, cam.lookat, cam.up, cam.fov,
                                       width, height, px, py, sample, seed)
    hero, seed = spec.sample_wavelengths_p(seed)
    return o, d, hero, seed


def kernel_inputs(scene, o, d, hero, seed):
    """The forward kernel's operands: (prims (P, 12), rays (6, R),
    seeds (4, R), spect (S*4, R)), every spectrum at each ray's hero
    wavelengths."""
    spect = spec.gather_hero(spec.expand_hero_table(scene.spectra), hero)
    return (mk.pack_prims(scene), torch.cat([o, d], dim=0).contiguous(),
            seed.contiguous(), spect.contiguous())


def trace_radiance(scene, o, d, hero, seed, max_depth: int,
                   rr_start: int = 1, static: SceneStatic | None = None):
    """Planar path trace: o, d (3, R), hero (R,), seed (4, R) ->
    spectral radiance (4, R) at the hero wavelengths; differentiable with
    respect to the scene's geometry and spectra and to o, d."""
    if static is None:
        static = SceneStatic.from_scene(scene)
    return mk.TraceFn.apply(static, int(max_depth), int(rr_start),
                            *kernel_inputs(scene, o, d, hero, seed))


def render_pixels_planar(scene, width: int, height: int, px, py, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None):
    """Pixels px, py (R,) at a 1-based sample index -> XYZ (3, R)."""
    o, d, hero, seed = camera_planes(scene, width, height, px, py, sample)
    radiance = trace_radiance(scene, o, d, hero, seed, max_depth, rr_start,
                              static)
    cie_p = spec.gather_hero(spec.cie_window_exp(scene.cie), hero)
    return spec.spectral_to_xyz_p(cie_p, radiance)


def render_sample_planar(scene, width: int, height: int, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None):
    """One sample of the whole film -> XYZ (3, height, width)."""
    px, py = tile_coords(width, height, 0, scene.device)
    xyz = render_pixels_planar(scene, width, height, px, py, sample,
                               max_depth, rr_start, static)
    return xyz.reshape(3, height, width)


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None):
    """One sample of the whole film -> XYZ (height, width, 3)."""
    return render_sample_planar(scene, width, height, sample, max_depth,
                                rr_start, static).permute(1, 2, 0)


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1):
    """Sum of samples first_sample .. first_sample+spp-1 -> XYZ (H, W, 3),
    accumulated in sample order."""
    static = SceneStatic.from_scene(scene)
    accum = torch.zeros((3, height, width), dtype=torch.float32,
                        device=scene.device)
    for s in range(first_sample, first_sample + spp):
        accum = accum + render_sample_planar(scene, width, height, s,
                                             max_depth, rr_start, static)
    return accum.permute(1, 2, 0).contiguous()
