"""The (dp, sp) device mesh of sharded rendering (port of
computeraytracer_tpu/parallel/mesh.py).

The film plane (rows) is the data-parallel axis and samples per pixel
the second axis. In torch one process drives one device, so the mesh is
over the ranks of the process group, laid out row-major: rank
``dpi * sp + spi`` holds coordinate ``(dpi, spi)``, as the JAX package
reshapes its device list.
"""

from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DP_AXIS = "dp"  # film-plane rows
SP_AXIS = "sp"  # samples per pixel


def default_shape(n: int) -> tuple[int, int]:
    """(dp, sp) of n ranks: sp = 2 when n is even and above 1, else 1."""
    sp = 2 if n % 2 == 0 and n > 1 else 1
    return n // sp, sp


def make_mesh(shape: Optional[tuple] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """(dp, sp) DeviceMesh over every rank of the running process group.

    shape defaults to ``default_shape(world size)``; device_type to the
    device that ``distributed.initialize`` chose ("cuda" unless the
    caller asked for the CPU). The group must be running: see
    ``distributed.initialize``."""
    from computeraytracer_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a running process group: call "
            "parallel.distributed.initialize first")
    n = dist.get_world_size()
    shape = default_shape(n) if shape is None else tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return init_device_mesh(device_type or distributed.device_type(), shape,
                            mesh_dim_names=(DP_AXIS, SP_AXIS))


def pad_to_multiple(x: int, m: int) -> int:
    return m * math.ceil(x / m)
