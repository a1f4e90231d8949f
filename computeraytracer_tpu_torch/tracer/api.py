"""User-facing render API (port of computeraytracer_tpu/tracer/api.py).

``render(scene, config)`` returns the accumulated and mean XYZ and the
tonemapped sRGB image; progressive refinement is spp accumulation with
the reference's 1-based sample counter. The scene's device decides where
it runs; the loaders put it on the card unless asked for the CPU.

``kernel="pallas"`` (the port's default) traces through the forward
kernel, one launch per sample (mesh scenes in its mesh mode);
``kernel="xla"`` (the JAX package's default) through the eager torch
tracer, ``tracer/xla.py``, brute force. Both compute the same image.
This module is the one place that reads ``kernel``: every render and
loss sums its samples through ``accumulate`` (a pixel set, never graphed)
or ``_frame_sum`` (whole frames: ``render_accumulate``'s and ``render``'s),
each of which calls one tracer's loop over samples.
"""

from __future__ import annotations

from typing import Optional

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.tracer import kernel as kernel_tracer
from computeraytracer_tpu_torch.tracer import xla as xla_tracer
from computeraytracer_tpu_torch.utils import profiling

KERNELS = ("pallas", "xla")


def require_kernel(kernel: str) -> None:
    """Raise ValueError unless kernel is one of KERNELS."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")


def render_sample(scene, width, height, sample, max_depth=8, rr_start=1,
                  kernel: str = "pallas"):
    """One progressive sample -> XYZ (H, W, 3)."""
    require_kernel(kernel)
    if kernel == "xla":
        return xla_tracer.render_sample(scene, width, height, sample,
                                        max_depth, rr_start)
    return kernel_tracer.render_sample(scene, width, height, sample,
                                       max_depth, rr_start)


def accumulate(scene, width: int, height: int, spp: int, max_depth: int = 8,
               rr_start: int = 1, first_sample: int = 1,
               kernel: str = "pallas", px=None, py=None,
               chunk: int | None = None, backward: str = "pallas",
               static=None, mesh_plans=None, use_remat: bool = True,
               bvh=None, vis_grads=False):
    """Sum of samples first_sample .. first_sample+spp-1 over the pixels
    px, py (R,), the whole film row-major when None -> XYZ (R, 3),
    contiguous, accumulated in sample order and differentiable: the one
    loop over samples of the tracer kernel names
    (``tracer.kernel.accumulate_pixels``, ``tracer.xla.accumulate_pixels``),
    in bands of chunk rays when given. The kernel path takes backward,
    static and mesh_plans; the eager tracer use_remat, bvh and vis_grads.
    Never graphed: ``_frame_sum`` serves whole frames."""
    require_kernel(kernel)
    if kernel == "xla":
        return xla_tracer.accumulate_pixels(
            scene, width, height, px, py, first_sample, spp, max_depth,
            rr_start, use_remat, bvh, vis_grads, chunk)
    _, xyz = kernel_tracer.accumulate_pixels(
        scene, width, height, px, py, first_sample, spp, max_depth, rr_start,
        static, backward, mesh_plans, chunk=chunk)
    return xyz.T.contiguous()


def _frame_sum(scene, width: int, height: int, spp: int, max_depth: int,
               rr_start: int, first_sample: int, kernel: str, bvh=None):
    """The whole film's sum of samples first_sample .. in the tracer's own
    layout: the kernel path's XYZ (3, R) row-major
    (``tracer.kernel.accumulate_frame``, replayed as a CUDA graph where it
    can, and then the graph's own buffer) or the eager tracer's (H, W, 3),
    through bvh when given (the kernel path walks its own)."""
    require_kernel(kernel)
    if kernel == "xla":
        return xla_tracer.render_accumulate(scene, width, height, spp,
                                            max_depth, rr_start,
                                            first_sample, bvh)
    return kernel_tracer.accumulate_frame(scene, width, height, spp,
                                          max_depth, rr_start, first_sample)


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, kernel: str = "pallas",
                      bvh=None):
    """The whole film's sum of samples first_sample .. -> XYZ (H, W, 3), a
    tensor of its own (``_frame_sum``'s, a planar sum copied once)."""
    xyz = _frame_sum(scene, width, height, spp, max_depth, rr_start,
                     first_sample, kernel, bvh)
    if xyz.dim() == 2:
        return xyz.view(3, height, width).permute(1, 2, 0).contiguous()
    return xyz


def render(scene, cfg: Optional[RenderConfig] = None, **overrides):
    """Render a scene. Returns dict with accum_xyz, mean_xyz, srgb and
    samples (the 1-based sample counter after the render), each image a
    new (H, W, 3) tensor of its own. ray_chunk renders the film in bands of
    whole rows, at most ray_chunk rays each (at least one row), so that a
    sample's live memory scales with it. The frame's sum is finished by
    ``kernels.setup.finish_frame``: on the card one launch that reads the
    kernel path's planar sum (the frame graph's own buffer, where it
    replays) or an (H, W, 3) one."""
    cfg = (cfg or RenderConfig()).replace(**overrides)
    with profiling.annotate("render"):
        if cfg.ray_chunk and cfg.ray_chunk > 0:
            rows = max(1, cfg.ray_chunk // cfg.width)
            xyz = accumulate(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample, cfg.kernel,
                chunk=rows * cfg.width).view(cfg.height, cfg.width, 3)
        else:
            xyz = _frame_sum(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample, cfg.kernel)
        # the reference divides the never-cleared accumulator by the
        # sample counter
        total = cfg.first_sample + cfg.spp - 1
        with profiling.annotate("finish"):
            accum, mean, srgb = setup_k.finish_frame(xyz, total, cfg.width,
                                                     cfg.height)
    return {
        "accum_xyz": accum,
        "mean_xyz": mean,
        "srgb": srgb,
        "samples": total,
    }
