"""Gradient-based scene optimization (port of
computeraytracer_tpu/train/optimize.py).

Pixel gradients flow through the path tracer to primitive geometry
(``primitives.data1/2/3``) and material spectra, with detached sampling
(common random numbers). With ``kernel="xla"`` the trace is the eager
tracer (``tracer/xla.py``) under torch autograd, each bounce
recomputed in the backward when ``use_remat`` (the default, as in the
JAX package; the kernel path ignores it). With ``kernel="pallas"`` the
megakernel's autograd Function
(``kernels.megakernel.TraceFn``, ``TraceTapedFn`` with
``backward="pallas_taped"``, or for scenes with mesh parts
``MeshTraceFn``, the guided replay) carries them through the trace, torch
autograd through the camera, the hero gathers and the CIE conversion.
A mesh part's chunk BVH is planned once on the initial geometry
(``make_loss_fn``), and its boxes follow the trained vertices.

A scene is split into (params, static scene); the loss renders the scene
from merged params and compares it to a target in XYZ. Visibility
gradients (``vis_grads``, ops/warp.py) render through the eager tracer
(``kernel="xla"``). With ``mesh`` (a (dp, sp) DeviceMesh over the whole
world, parallel/mesh.py) the render is sharded
(``parallel.render_sharded``): every rank computes the same loss over the
whole film, and the trainable leaves pass through
``render_sharded.replicated``, so that their gradient sums every rank's
rays, as JAX transposes shard_map's psum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch

from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.parallel import render_sharded
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kernel_tracer
from computeraytracer_tpu_torch.utils import profiling

# Leaves of Scene that may be trained.
GEOMETRY_LEAVES = ("data1", "data2", "data3")
TRAINABLE = ("spectra",) + GEOMETRY_LEAVES


def split_scene(scene, trainable: Iterable[str] = ("spectra",)):
    """Split a Scene into (params dict, static scene).

    trainable: subset of {"spectra", "data1", "data2", "data3"}.
    """
    params = {}
    for name in tuple(trainable):
        if name == "spectra":
            params[name] = scene.spectra
        elif name in GEOMETRY_LEAVES:
            params[name] = getattr(scene.primitives, name)
        else:
            raise ValueError(f"not trainable: {name}")
    return params, scene


def merge_scene(static_scene, params):
    """Re-insert trainable leaves into the scene."""
    scene = static_scene
    if "spectra" in params:
        scene = dataclasses.replace(scene, spectra=params["spectra"])
    geom = {k: v for k, v in params.items() if k in GEOMETRY_LEAVES}
    if geom:
        scene = dataclasses.replace(
            scene, primitives=dataclasses.replace(scene.primitives, **geom))
    return scene


def render_mean_xyz(scene, width, height, spp, max_depth, rr_start=1,
                    first_sample=1, mesh=None, use_remat=True,
                    kernel: str = "pallas", kernel_static=None,
                    kernel_plans=None, vis_grads: bool = False,
                    backward: str = "pallas"):
    """Mean XYZ (H, W, 3) over spp samples, accumulated in sample order;
    differentiable with respect to the scene's tensors. kernel="xla"
    renders through the eager tracer (use_remat: each bounce recomputed
    in the backward); kernel="pallas" through the kernel path, whose
    backward is the backward knob's (tracer/kernel.py). kernel_plans: one
    meshpack.MeshPlan per mesh part of kernel_static, fixed on the
    initial geometry; the packs are built under them from the live
    vertices (planned from this scene when None). The samples are summed
    by ``tracer.api.accumulate`` over the whole film. vis_grads
    (kernel="xla" only) turns on the warped-area visibility gradients of
    ``tracer.xla.render_pixels``; its image is the unstratified render's.
    With kernel="pallas" it raises: the kernel path's screen warp is
    ``tracer.kernel.render_sample(vis_grads=("screen",))``. mesh (a
    DeviceMesh, parallel/mesh.py) renders through
    ``parallel.render_sharded.render_accumulate_sharded``; every rank
    returns the whole image. The JAX package's sharded path drops
    vis_grads, so here it raises with a mesh."""
    if vis_grads and kernel != "xla":
        raise ValueError(
            "vis_grads renders through the eager tracer: pass kernel='xla' "
            "(the screen warp around the kernels is "
            "tracer.kernel.render_sample(vis_grads=('screen',)))")
    if mesh is not None:
        if vis_grads:
            raise ValueError("vis_grads has no sharded path: pass mesh=None")
        accum = render_sharded.render_accumulate_sharded(
            scene, width, height, spp, mesh, max_depth, rr_start,
            int(first_sample), use_remat, kernel=kernel,
            static=kernel_static, backward=backward,
            mesh_plans=kernel_plans)
        return accum / float(spp)
    xyz = api.accumulate(scene, width, height, spp, max_depth, rr_start,
                         int(first_sample), kernel, backward=backward,
                         static=kernel_static, mesh_plans=kernel_plans,
                         use_remat=use_remat, vis_grads=vis_grads)
    return xyz.view(height, width, 3) / float(spp)


def make_loss_fn(static_scene, width, height, spp, max_depth,
                 rr_start: int = 1, mesh=None, use_remat=True,
                 kernel: str = "pallas", backward: str = "pallas"):
    """L2 loss in XYZ between the rendered mean and a target image. With
    mesh the render is sharded and every rank returns the same loss, the
    mean over the whole film; its gradient by params is the whole one on
    every rank (render_sharded.replicated sums the ranks' parts)."""
    api.require_kernel(kernel)
    kernel_static = kernel_plans = None
    if kernel == "pallas":
        kernel_static = kernel_tracer.SceneStatic.from_scene(static_scene)
        # Morton order and tree structure pinned to the INITIAL geometry;
        # the boxes re-derive from the live parameters at every render
        kernel_plans = tuple(meshpack.plan_scene_mesh(static_scene, part)
                             for part in kernel_static.mesh_parts)

    def loss_fn(params, target, first_sample):
        if mesh is not None:
            params = render_sharded.replicated(params)
        scene = merge_scene(static_scene, params)
        img = render_mean_xyz(scene, width, height, spp, max_depth,
                              rr_start, first_sample, mesh, use_remat,
                              kernel=kernel,
                              kernel_static=kernel_static,
                              kernel_plans=kernel_plans,
                              backward=backward)
        return torch.mean((img - target) ** 2)

    return loss_fn


def make_train_step(static_scene, optimizer, width, height, spp, max_depth,
                    rr_start: int = 1, mesh=None, kernel: str = "pallas",
                    spectra_rows=None, backward: str = "pallas"):
    """(params, target, first_sample) -> loss: one optimizer step on the
    leaf tensors in ``params`` (the tensors ``optimizer`` updates).

    spectra_rows: optional sequence of spectra ROW indices to train; the
    other rows are frozen. The mask applies to the update, not to the
    gradient, so Adam's moments still see every row. After the step,
    spectra are clamped to be >= 0: they are physically nonnegative, and
    Adam walks a row with ~zero gradient a full -lr per step, which makes
    a negative extinction blow Beer-Lambert up."""
    loss_fn = make_loss_fn(static_scene, width, height, spp, max_depth,
                           rr_start, mesh, kernel=kernel, backward=backward)
    frozen = None
    if spectra_rows is not None:
        frozen = torch.ones(static_scene.spectra.shape[0], dtype=torch.bool,
                            device=static_scene.device)
        frozen[[int(r) for r in spectra_rows]] = False

    def step(params, target, first_sample):
        with profiling.annotate("train.step"):
            optimizer.zero_grad(set_to_none=True)
            with profiling.annotate("train.loss"):
                loss = loss_fn(params, target, first_sample)
            with profiling.annotate("train.backward"):
                loss.backward()
            with profiling.annotate("train.optimizer"), torch.no_grad():
                keep = None
                if frozen is not None and "spectra" in params:
                    keep = params["spectra"][frozen].clone()
                optimizer.step()
                if keep is not None:
                    params["spectra"][frozen] = keep
                if "spectra" in params:
                    params["spectra"].clamp_(min=0.0)
            return loss.detach()

    return step


def cosine_decay(steps: int):
    """optax.cosine_decay_schedule's factor at update count c (the first
    update at c = 0): 0.5 * (1 + cos(pi * min(c, steps) / steps))."""
    steps = max(1, int(steps))
    return lambda c: 0.5 * (1.0 + math.cos(math.pi * min(c, steps) / steps))


def optimize_config(scene, target, width, height, cfg,
                    trainable=("spectra",), mesh=None, kernel="pallas",
                    callback=None, backward: str = "pallas"):
    """Run `optimize` from a config.TrainConfig (cfg.render supplies
    max_depth and rr_start)."""
    return optimize(
        scene, target, width, height, trainable=trainable,
        steps=cfg.steps, learning_rate=cfg.learning_rate,
        spp=cfg.spp_per_step, max_depth=cfg.render.max_depth,
        rr_start=cfg.render.rr_start, mesh=mesh,
        checkpoint_dir=cfg.checkpoint_dir,
        checkpoint_every=cfg.checkpoint_every, callback=callback,
        kernel=kernel, backward=backward)


def optimize(scene, target, width, height, *, trainable=("spectra",),
             steps=50, learning_rate=0.05, spp=4, max_depth=4,
             rr_start: int = 1, mesh=None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 25, callback=None,
             fresh_samples: bool = False, kernel: str = "pallas",
             lr_schedule: Optional[str] = None, spectra_rows=None,
             backward: str = "pallas"):
    """Run the material/geometry optimization loop with Adam.

    fresh_samples=False (default) uses the SAME sample set every step
    (common random numbers): the loss is a deterministic function of the
    parameters. fresh_samples=True advances the sample counter every
    step. lr_schedule="cosine" decays the learning rate to 0 over
    `steps`. With checkpoint_dir, the run resumes from the latest saved
    step and saves every checkpoint_every steps and at the end.
    kernel="xla" differentiates the eager tracer (each bounce
    recomputed in the backward). With kernel="pallas", backward is the
    trace's backward: "pallas" (the retrace kernel) or "pallas_taped"
    (the tape-fed pair); a scene with mesh parts takes the guided replay
    either way. Returns (scene, losses)."""
    api.require_kernel(kernel)
    if lr_schedule not in (None, "cosine"):
        raise ValueError(f"unknown lr_schedule: {lr_schedule!r}")
    params0, static_scene = split_scene(scene, trainable)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)

    start_step = 0
    ckpt = None
    if checkpoint_dir is not None:
        from computeraytracer_tpu_torch.train import checkpoint as ckpt_mod
        ckpt = ckpt_mod.Checkpointer(checkpoint_dir)
        restored = ckpt.restore_latest(map_location=scene.device)
        if restored is not None:
            saved, state, start_step = restored
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            optimizer.load_state_dict(state["adam"])
    # The schedule is a function of the step count, as optax's is of the
    # update count: a resumed run takes this run's learning rate and
    # schedule at its restored step, whatever the saved run used.
    for group in optimizer.param_groups:
        group["lr"] = group["initial_lr"] = learning_rate
    scheduler = None
    if lr_schedule == "cosine":
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, cosine_decay(steps), last_epoch=start_step - 1)
    step_fn = make_train_step(static_scene, optimizer, width, height, spp,
                              max_depth, rr_start, mesh, kernel=kernel,
                              spectra_rows=spectra_rows, backward=backward)

    def opt_state():
        return {"adam": optimizer.state_dict()}

    losses = []
    for i in range(start_step, steps):
        first_sample = 1 + i * spp if fresh_samples else 1
        loss = float(step_fn(params, target, first_sample))
        if scheduler is not None:
            scheduler.step()
        losses.append(loss)
        if callback is not None:
            callback(i, loss, params)
        if ckpt is not None and (i + 1) % checkpoint_every == 0:
            ckpt.save(i + 1, params, opt_state())
    if ckpt is not None:
        ckpt.save(steps, params, opt_state())
    return merge_scene(static_scene,
                       {k: v.detach() for k, v in params.items()}), losses
