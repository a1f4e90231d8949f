"""User-facing render API (port of computeraytracer_tpu/tracer/api.py).

``render(scene, config)`` returns the accumulated and mean XYZ and the
tonemapped sRGB image; progressive refinement is spp accumulation with
the reference's 1-based sample counter. The scene's device decides where
it runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.ops import color
from computeraytracer_tpu_torch.tracer import kernel as kernel_tracer


def _require_kernel(kernel: str) -> None:
    if kernel == "xla":
        raise NotImplementedError(
            "kernel='xla' (the eager tracer) is not ported yet; use "
            "kernel='pallas'")
    if kernel != "pallas":
        raise ValueError(f"unknown kernel {kernel!r}")


def render_sample(scene, width, height, sample, max_depth=8, rr_start=1,
                  kernel: str = "pallas"):
    """One progressive sample -> XYZ (H, W, 3)."""
    _require_kernel(kernel)
    return kernel_tracer.render_sample(scene, width, height, sample,
                                       max_depth, rr_start)


def _band_accumulate(scene, static, y0, tile_h, cfg: RenderConfig):
    """Accumulate cfg.spp samples for film rows [y0, y0+tile_h)."""
    px, py = kernel_tracer.tile_coords(cfg.width, tile_h, y0, scene.device)
    accum = torch.zeros((3, tile_h * cfg.width), dtype=torch.float32,
                        device=scene.device)
    for s in range(cfg.first_sample, cfg.first_sample + cfg.spp):
        accum = accum + kernel_tracer.render_pixels_planar(
            scene, cfg.width, cfg.height, px, py, s, cfg.max_depth,
            cfg.rr_start, static)
    return accum.T.reshape(tile_h, cfg.width, 3)


def _render_accumulate_chunked(scene, cfg: RenderConfig):
    """Row-band chunked accumulation: peak live memory scales with
    ray_chunk instead of width*height."""
    rows = max(1, cfg.ray_chunk // cfg.width)
    static = kernel_tracer.SceneStatic.from_scene(scene)
    bands = [_band_accumulate(scene, static, y0,
                              min(rows, cfg.height - y0), cfg)
             for y0 in range(0, cfg.height, rows)]
    return torch.cat(bands, dim=0)


def render(scene, cfg: Optional[RenderConfig] = None, **overrides):
    """Render a scene. Returns dict with accum_xyz, mean_xyz, srgb and
    samples (the 1-based sample counter after the render)."""
    cfg = (cfg or RenderConfig()).replace(**overrides)
    _require_kernel(cfg.kernel)
    if cfg.ray_chunk and cfg.ray_chunk > 0:
        accum = _render_accumulate_chunked(scene, cfg)
    else:
        accum = kernel_tracer.render_accumulate(
            scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
            cfg.rr_start, cfg.first_sample)
    # the reference divides the never-cleared accumulator by the sample
    # counter
    total = cfg.first_sample + cfg.spp - 1
    mean = accum / float(total)
    return {
        "accum_xyz": accum,
        "mean_xyz": mean,
        "srgb": color.xyz_to_srgb(mean),
        "samples": total,
    }
