"""Megakernel tracer: the port of computeraytracer_tpu/tracer/pallas.py.

Camera ray generation, hero-wavelength sampling, the per-ray spectra
planes and the CIE conversion run as torch ops; the trace itself is one
kernel call per sample (the CUDA kernels for a scene on the card, their
plain torch versions for a scene on the CPU).

One layout is ported: the planar (k, R) path the kernel consumes, with
pixels in ``tile_coords`` row-major order. ``render_sample`` is its
(H, W, 3) transpose; the JAX package documents the two layouts as
bit-identical. Mesh scenes keep row-major order too: the JAX package's
block order (``_block_order``) is a culling order for its per-tile BVH
walk and changes no pixel's value.

Differentiation, by the ``backward`` knob (the JAX package's values):
- ``"pallas"`` (default): ``kernels.megakernel.TraceFn``, whose backward
  is the retrace kernel (replay plus reverse adjoint sweep);
- ``"pallas_taped"``: ``TraceTapedFn``. Under grad the taped forward
  writes every bounce's input carry and the tape-fed kernel sweeps it
  without a replay; with no input needing grad, the untaped forward runs;
- ``"replay"``: ``MeshTraceFn``. Under grad the winner-taped forward
  keeps each bounce's closest-hit and shadow winners, and the backward is
  torch autograd of the guided replay (tracer/replay.py). Scenes with
  mesh parts take this route whatever ``"pallas"`` or ``"pallas_taped"``
  asks for: the backward kernels have no chunk-BVH walk. (The JAX
  package's ``_resolve`` reroutes only ``"pallas"``; its own error text
  says mesh scenes route there automatically.)
- ``"none"``: the forward alone, with no autograd Function;
- ``"xla"`` (the eager tracer) raises NotImplementedError naming slice 6.
Autograd carries the cotangents of the primitive table, the spectra
planes and the rays on through ``pack_prims``, the hero gather and the
camera to every scene leaf (geometry, spectra, camera).

Mesh scenes (mesh parts or triangle rows) render through the forward
kernel's mesh mode, the in-kernel chunk-BVH walk. Triangle rows without a
mesh part keep ``TraceFn`` / ``TraceTapedFn``, whose kernels scan them in
their mesh mode. A mesh part's chunk BVH is packed from a plan fixed on
the initial geometry (``mesh_plans``, as ``kernels/meshpack.py``
``plan_scene_mesh`` makes them), so its boxes follow the live vertices.
``wavefront=None`` resolves to the in-kernel mode
(``MESH_WAVEFRONT_DEFAULT``); ``wavefront=True`` raises for mesh scenes
and is ignored for the others, as in the JAX package.
"""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops import spectrum as spec

SceneStatic = mk.SceneStatic

# What trace_radiance(wavefront=None) resolves to for mesh scenes. The
# JAX package defaults to its binned wavefront (five TPU kernels that are
# not ported yet, slice 5); its tests specify the wavefront bit-identical
# to the in-kernel bounce loop, so the port renders mesh scenes in-kernel.
MESH_WAVEFRONT_DEFAULT = False

BACKWARDS = ("pallas", "pallas_taped", "none", "xla", "replay")


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


def kernel_inputs(scene, o, d, hero, seed, static: SceneStatic | None = None):
    """The forward kernel's operands: (prims (P, 12), rays (6, R),
    seeds (4, R), spect (S*4, R)), every spectrum at each ray's hero
    wavelengths; prims holds the static's unrolled rows."""
    spect = spec.gather_hero(spec.expand_hero_table(scene.spectra), hero)
    return (mk.pack_prims(scene, static),
            torch.cat([o, d], dim=0).contiguous(), seed.contiguous(),
            spect.contiguous())


def mesh_packs_for(scene, static: SceneStatic, mesh_plans=None):
    """Chunk BVH packing (kernels/meshpack.py) of every mesh part, on the
    scene's device, under mesh_plans (one per part) when given."""
    plans = mesh_plans if mesh_plans is not None else (None,) * len(
        static.mesh_parts)
    return tuple(meshpack.pack_scene_mesh(scene, part, plan)
                 for part, plan in zip(static.mesh_parts, plans))


def _resolve(scene, static, backward, wavefront, mesh_packs, mesh_plans):
    """Resolve the dispatch knobs and the mesh arrays shared by every
    entry point -> (static, backward, mesh_arrays)."""
    if backward not in BACKWARDS:
        raise ValueError(f"unknown backward {backward!r}; expected one of "
                         f"{BACKWARDS}")
    if backward == "xla":
        raise NotImplementedError(
            "backward='xla' runs the eager tracer, which arrives with slice "
            "6 of the port (after the mesh slices)")
    if static is None:
        static = SceneStatic.from_scene(scene)
    if wavefront is None:
        wavefront = MESH_WAVEFRONT_DEFAULT
    if wavefront and static.mesh_parts:
        raise NotImplementedError(
            "wavefront=True (the binned wavefront of mesh scenes, kernels "
            "2 and 5-8) arrives with slice 5 of the port; wavefront=None "
            "renders mesh scenes in-kernel")
    mesh_arrays = ()
    if static.mesh_parts:
        if mesh_packs is None:
            mesh_packs = mesh_packs_for(scene, static, mesh_plans)
        mesh_arrays = tuple(a for pack in mesh_packs for a in pack.arrays)
        if backward in ("pallas", "pallas_taped"):
            backward = "replay"
    return static, backward, mesh_arrays


def _dispatch(static, max_depth, rr_start, backward, prims, rays, seeds,
              spect, mesh_arrays, cats):
    """One trace of prepared kernel operands -> radiance (4, R). prims is
    the full table for "replay", else the static's unrolled rows."""
    args = (static, int(max_depth), int(rr_start), prims, rays, seeds, spect)
    if backward == "replay":
        return mk.MeshTraceFn.apply(*args, cats, *mesh_arrays)
    if backward == "pallas":
        return mk.TraceFn.apply(*args)
    if backward == "pallas_taped":
        return mk.TraceTapedFn.apply(*args)
    with torch.no_grad():  # "none": the forward alone
        return mk.forward(*args, *mesh_arrays)


def trace_radiance(scene, o, d, hero, seed, max_depth: int,
                   rr_start: int = 1, static: SceneStatic | None = None,
                   backward: str = "pallas", mesh_packs=None,
                   wavefront: bool | None = None, mesh_plans=None):
    """Planar path trace: o, d (3, R), hero (R,), seed (4, R) ->
    spectral radiance (4, R) at the hero wavelengths; differentiable with
    respect to the scene's geometry and spectra and to o, d."""
    static, backward, mesh_arrays = _resolve(scene, static, backward,
                                             wavefront, mesh_packs,
                                             mesh_plans)
    inputs = kernel_inputs(scene, o, d, hero, seed,
                           None if backward == "replay" else static)
    return _dispatch(static, max_depth, rr_start, backward, *inputs,
                     mesh_arrays, scene.primitives.category)


def render_pixels_planar(scene, width: int, height: int, px, py, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None,
                         backward: str = "pallas", mesh_packs=None,
                         wavefront: bool | None = None, mesh_plans=None):
    """Pixels px, py (R,) at a 1-based sample index -> XYZ (3, R)."""
    o, d, hero, seed = camera_planes(scene, width, height, px, py, sample)
    radiance = trace_radiance(scene, o, d, hero, seed, max_depth, rr_start,
                              static, backward, mesh_packs, wavefront,
                              mesh_plans)
    cie_p = spec.gather_hero(spec.cie_window_exp(scene.cie), hero)
    return spec.spectral_to_xyz_p(cie_p, radiance)


def render_sample_planar(scene, width: int, height: int, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None,
                         backward: str = "pallas", mesh_packs=None,
                         wavefront: bool | None = None, mesh_plans=None):
    """One sample of the whole film -> XYZ (3, height, width)."""
    px, py = tile_coords(width, height, 0, scene.device)
    xyz = render_pixels_planar(scene, width, height, px, py, sample,
                               max_depth, rr_start, static, backward,
                               mesh_packs, wavefront, mesh_plans)
    return xyz.reshape(3, height, width)


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None,
                  backward: str = "pallas", mesh_packs=None,
                  wavefront: bool | None = None, mesh_plans=None):
    """One sample of the whole film -> XYZ (height, width, 3)."""
    return render_sample_planar(scene, width, height, sample, max_depth,
                                rr_start, static, backward, mesh_packs,
                                wavefront, mesh_plans).permute(1, 2, 0)


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, backward: str = "pallas"):
    """Sum of samples first_sample .. first_sample+spp-1 -> XYZ (H, W, 3),
    accumulated in sample order. Mesh packs are built once."""
    static = SceneStatic.from_scene(scene)
    packs = mesh_packs_for(scene, static) if static.mesh_parts else None
    accum = torch.zeros((3, height, width), dtype=torch.float32,
                        device=scene.device)
    for s in range(first_sample, first_sample + spp):
        accum = accum + render_sample_planar(scene, width, height, s,
                                             max_depth, rr_start, static,
                                             backward, packs)
    return accum.permute(1, 2, 0).contiguous()
