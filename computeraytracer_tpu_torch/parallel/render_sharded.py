"""Sharded rendering: film rows over 'dp', samples over 'sp' (port of
computeraytracer_tpu/parallel/render_sharded.py).

Each rank renders its own film-row tile for its own slice of the sample
set, with the scene replicated on every rank. Seeds derive from global
pixel coordinates and the global sample index, and the port's kernels
give each ray the same value whatever its neighbours, so a rank's tile is
the single-process render of those pixels and samples bit for bit. The
tiles meet in one all-reduce (sum) over the world of an (H, W, 3) buffer
that holds the rank's rows and zeros elsewhere: exact zeros change no
bit, so with dp only the image is the single-process render's, and with
sp = 2 it is the sum of the two sample halves.

Everything is differentiable. The all-reduce's backward is the identity
(every rank holds the same upstream gradient of the same loss), so each
rank's parameters get only its own rays' part; ``replicated`` wraps the
parameters so that their gradients are summed over the world in the
backward, once, with one all-reduce: the transpose of shard_map's
replicated input in the JAX package. (The differentiable
``torch.distributed.nn.functional.all_reduce`` all-reduces in its
backward too, which would count each gradient sp times.)

The JAX package's per-shard block order (``_block_order``) is a culling
order of its TPU mesh walk; row-major tiles give the same image.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from computeraytracer_tpu_torch.parallel.mesh import DP_AXIS, SP_AXIS
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import xla as xla_tracer

# When a list, every all-reduce of this module appends
# {"what": "image" | "grads", "bytes": n, "ms": host ms}, the device
# synchronised around the call (for measurement only; None: no log).
allreduce_log = None


def _all_reduce(t: torch.Tensor, what: str) -> None:
    """In-place sum of t over every rank of the world."""
    if allreduce_log is None:
        dist.all_reduce(t)
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    allreduce_log.append({"what": what,
                          "bytes": t.numel() * t.element_size(),
                          "ms": (time.perf_counter() - t0) * 1e3})


class _SumOverWorld(torch.autograd.Function):
    """Forward: the sum of x over every rank. Backward: the identity."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(out, "image")
        return out

    @staticmethod
    def backward(ctx, g):
        return g


class _Replicated(torch.autograd.Function):
    """Forward: the tensors as they are. Backward: their gradients summed
    over every rank, all of them in one all-reduce."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(flat, "grads")
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        return tuple(out)


def replicated(params: dict) -> dict:
    """params (name -> tensor), each rank's copy of the same value, as
    tensors whose gradient is the sum of every rank's: wrap the trainable
    leaves with it before a sharded render."""
    names = sorted(params)
    return dict(zip(names, _Replicated.apply(*(params[k] for k in names))))


def render_accumulate_sharded(scene, width: int, height: int, spp: int,
                              mesh, max_depth: int = 8, rr_start: int = 1,
                              first_sample: int = 1, use_remat: bool = True,
                              bvh=None, kernel: str = "pallas", static=None,
                              backward: str = "pallas", mesh_plans=None):
    """Accumulated XYZ (H, W, 3) over spp samples, sharded over `mesh`
    (a (dp, sp) DeviceMesh over the whole world, parallel.mesh.make_mesh);
    every rank returns the whole image.

    height must divide by dp, spp by sp. Rank (dpi, spi) renders rows
    [dpi*tile_h, (dpi+1)*tile_h) for samples first_sample + spi*local_spp
    + k, k < local_spp, in order, through ``tracer.api.accumulate``:
    kernel="pallas" the kernel path (its backward by the backward knob,
    the packs under mesh_plans), kernel="xla" the eager tracer, with bvh
    when given."""
    api.require_kernel(kernel)
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; the image is "
                         "summed over the whole world")
    if mesh.device_type != scene.device.type:
        raise ValueError(f"a {mesh.device_type} mesh and a scene on "
                         f"{scene.device}")
    names = mesh.mesh_dim_names
    dp = mesh.size(names.index(DP_AXIS))
    sp = mesh.size(names.index(SP_AXIS))
    if height % dp != 0:
        raise ValueError(f"height {height} not divisible by dp={dp}")
    if spp % sp != 0:
        raise ValueError(f"spp {spp} not divisible by sp={sp}")
    tile_h = height // dp
    local_spp = spp // sp
    y0 = mesh.get_local_rank(DP_AXIS) * tile_h
    s0 = first_sample + mesh.get_local_rank(SP_AXIS) * local_spp
    px, py = xla_tracer.tile_coords(width, tile_h, y0, scene.device)
    tile = api.accumulate(scene, width, height, local_spp, max_depth,
                          rr_start, s0, kernel, px, py, backward=backward,
                          static=static, mesh_plans=mesh_plans,
                          use_remat=use_remat, bvh=bvh)
    full = F.pad(tile.reshape(tile_h, width, 3),
                 (0, 0, 0, 0, y0, height - y0 - tile_h))
    return _SumOverWorld.apply(full)
