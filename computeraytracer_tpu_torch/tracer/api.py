"""User-facing render API (port of computeraytracer_tpu/tracer/api.py).

``render(scene, config)`` returns the accumulated and mean XYZ and the
tonemapped sRGB image; progressive refinement is spp accumulation with
the reference's 1-based sample counter. The scene's device decides where
it runs; the loaders put it on the card unless asked for the CPU.

``kernel="pallas"`` (the port's default) traces through the forward
kernel, one launch per sample (mesh scenes in its mesh mode);
``kernel="xla"`` (the JAX package's default) through the eager torch
tracer, ``tracer/xla.py``, brute force. Both compute the same image.
"""

from __future__ import annotations

from typing import Optional

import torch

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.ops import color
from computeraytracer_tpu_torch.tracer import kernel as kernel_tracer
from computeraytracer_tpu_torch.tracer import xla as xla_tracer
from computeraytracer_tpu_torch.utils import profiling

KERNELS = ("pallas", "xla")


def _require_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")


def render_sample(scene, width, height, sample, max_depth=8, rr_start=1,
                  kernel: str = "pallas"):
    """One progressive sample -> XYZ (H, W, 3)."""
    _require_kernel(kernel)
    if kernel == "xla":
        return xla_tracer.render_sample(scene, width, height, sample,
                                        max_depth, rr_start)
    return kernel_tracer.render_sample(scene, width, height, sample,
                                       max_depth, rr_start)


def _band_accumulate(scene, static, packs, y0, tile_h, cfg: RenderConfig):
    """Accumulate cfg.spp samples for film rows [y0, y0+tile_h)."""
    px, py = kernel_tracer.tile_coords(cfg.width, tile_h, y0, scene.device)
    if cfg.kernel == "xla":
        accum = torch.zeros((tile_h * cfg.width, 3), dtype=torch.float32,
                            device=scene.device)
        for s in range(cfg.first_sample, cfg.first_sample + cfg.spp):
            accum = accum + xla_tracer.render_pixels(
                scene, cfg.width, cfg.height, px, py, s, cfg.max_depth,
                cfg.rr_start)
        return accum.reshape(tile_h, cfg.width, 3)
    accum = torch.zeros((3, tile_h * cfg.width), dtype=torch.float32,
                        device=scene.device)
    for s in range(cfg.first_sample, cfg.first_sample + cfg.spp):
        accum = accum + kernel_tracer.render_pixels_planar(
            scene, cfg.width, cfg.height, px, py, s, cfg.max_depth,
            cfg.rr_start, static, mesh_packs=packs)
    return accum.T.reshape(tile_h, cfg.width, 3)


def _render_accumulate_chunked(scene, cfg: RenderConfig):
    """Row-band chunked accumulation: peak live memory scales with
    ray_chunk instead of width*height."""
    rows = max(1, cfg.ray_chunk // cfg.width)
    static = packs = None
    if cfg.kernel == "pallas":
        static = kernel_tracer.SceneStatic.from_scene(scene)
        packs = (kernel_tracer.mesh_packs_for(scene, static)
                 if static.mesh_parts else None)
    bands = [_band_accumulate(scene, static, packs, y0,
                              min(rows, cfg.height - y0), cfg)
             for y0 in range(0, cfg.height, rows)]
    return torch.cat(bands, dim=0)


def render(scene, cfg: Optional[RenderConfig] = None, **overrides):
    """Render a scene. Returns dict with accum_xyz, mean_xyz, srgb and
    samples (the 1-based sample counter after the render)."""
    cfg = (cfg or RenderConfig()).replace(**overrides)
    _require_kernel(cfg.kernel)
    with profiling.annotate("render"):
        if cfg.ray_chunk and cfg.ray_chunk > 0:
            accum = _render_accumulate_chunked(scene, cfg)
        elif cfg.kernel == "xla":
            accum = xla_tracer.render_accumulate(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample)
        else:
            accum = kernel_tracer.render_accumulate(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample)
        # the reference divides the never-cleared accumulator by the
        # sample counter
        total = cfg.first_sample + cfg.spp - 1
        with profiling.annotate("finish"):
            mean = accum / float(total)
            srgb = color.xyz_to_srgb(mean)
    return {
        "accum_xyz": accum,
        "mean_xyz": mean,
        "srgb": srgb,
        "samples": total,
    }
