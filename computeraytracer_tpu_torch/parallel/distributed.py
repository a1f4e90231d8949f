"""Process-group start-up and the global mesh (port of
computeraytracer_tpu/parallel/distributed.py).

Scaling past one device means:

1. every rank calls :func:`initialize`, a thin, idempotent wrapper over
   ``torch.distributed.init_process_group`` that does nothing in a plain
   single-process run;
2. :func:`global_mesh` builds one (dp, sp) mesh over every rank, film
   rows over dp and samples over sp;
3. ``parallel.render_sharded`` renders each rank's tile and sums the
   tiles with one all-reduce; the gradient of a sharded loss sums each
   parameter's gradient with one more.

On the card the backend is NCCL, one rank per device. Gloo is used only
where the caller asks for it: on the CPU, and for ranks that share one
card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from computeraytracer_tpu_torch.parallel import mesh as mesh_mod

# The device the running group's tensors live on, as initialize chose it.
_device_type = "cuda"


def device_type() -> str:
    """"cuda" or "cpu": the device of the group that initialize started
    ("cuda" when it started none)."""
    return _device_type


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, *,
               device_type: str = "cuda",
               local_rank: Optional[int] = None) -> bool:
    """Idempotent process-group start-up. Returns True if a process group
    was (or already had been) started.

    Explicit arguments come first, then torchrun's environment
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). With
    neither, a plain single-process run is left untouched and False is
    returned. coordinator_address is "host:port" (TCP) or an init URL
    ("tcp://...", "file://..."). backend defaults to "nccl" for
    device_type "cuda" and "gloo" for "cpu"; with "cuda", each rank sets
    its device to local_rank (default: LOCAL_RANK, else the rank) and
    raises when there is no card.
    """
    global _device_type
    if dist.is_initialized():
        return True
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend needs device_type='cuda'")

    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    env_coord = f"{addr}:{port}" if addr and port else None
    env_nproc = os.environ.get("WORLD_SIZE")
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not (explicit or (env_coord and env_nproc)):
        return False  # single process: nothing to do
    coord = coordinator_address or env_coord
    nproc = (num_processes if num_processes is not None
             else int(env_nproc) if env_nproc else None)
    if coord is None or nproc is None:
        raise ValueError(
            "multi-process init needs both a coordinator address and a "
            f"process count (got coordinator_address={coord!r}, "
            f"num_processes={nproc!r}); set both arguments or MASTER_ADDR + "
            "MASTER_PORT + WORLD_SIZE")
    pid = (process_id if process_id is not None
           else int(os.environ.get("RANK", "0")))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {pid}: device_type='cuda' but no CUDA device is "
                "available (pass device_type='cpu' for the CPU)")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", pid))
        torch.cuda.set_device(local_rank)
    init_method = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nproc, rank=pid)
    _device_type = device_type
    return True


def shutdown() -> None:
    """Destroy the process group, if one is running."""
    global _device_type
    if dist.is_initialized():
        dist.destroy_process_group()
    _device_type = "cuda"


def global_mesh(sp: Optional[int] = None):
    """(dp, sp) mesh over every rank; sp defaults to 2 when the world
    size is even and above 1, else 1 (as mesh.make_mesh)."""
    if sp is None:
        return mesh_mod.make_mesh()
    return mesh_mod.make_mesh((dist.get_world_size() // sp, sp))
