"""Mesh casts of the binned wavefront: plain torch versions and CUDA
wrappers (port of computeraytracer_tpu/kernels/binned.py).

What lives here is the seeded chunk-BVH walk, ``build_walk_kernel``
(binned.py:640): the exact closest mesh hit of each ray over every mesh
part, starting from a seed. The wavefront (``tracer.kernel
.wavefront_forward``) casts every ray through it, the main cast of each
bounce and each light's shadow cast.

- ``walk_reference``: the plain torch version, the brute-force scan of
  every packed triangle of each part (``megakernel._scan_mesh_part``)
  from the seed under the mesh tie rule.
- ``walk``: the wrapper, ``rays (6, R) f32, seed_f (4, R) f32 [t,
  n.xyz], seed_i (2, R) i32 [idx, exclude], *mesh_arrays -> (out_f
  (4, R) f32 [t, n.xyz], out_i (1, R) i32 [idx])``. CPU tensors run
  ``walk_reference``; CUDA tensors launch ``csrc/walk.cu``.

Seeds: t = -inf marks an inactive lane, which comes back unchanged (the
encoding of binned.py:866 ``walk_compact``; the JAX ``walk_full``
fallback, binned.py:803-817, seeds inactive rays with their stale winner
and can return real hits there). A finite t with idx -1 bounds the cast:
only hits at t <= bound are taken.
"""

from __future__ import annotations

import ctypes
import math

import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import intersect as isect

# Launches of the walk kernel, counted where the wrapper launches it.
launches_walk = 0


def walk_reference(static: mk.SceneStatic, rays: torch.Tensor,
                   seed_f: torch.Tensor, seed_i: torch.Tensor, *mesh_arrays):
    """Plain torch seeded walk -> (out_f (4, R), out_i (1, R)): for each
    active lane (seed t > -inf), the closest hit over every mesh part that
    beats the seed (t < best, or t == best and a higher id), skipping the
    triangle seed_i[1]; the seed where none does. Inactive lanes return
    their seed. Only the active lanes are scanned."""
    out_f = seed_f.clone()
    out_i = seed_i[0:1].clone()
    lanes = torch.nonzero(seed_f[0] > -math.inf)[:, 0]
    o = tuple(rays[c, lanes] for c in range(3))
    d = tuple(rays[3 + c, lanes] for c in range(3))
    exclude = seed_i[1, lanes].to(torch.int64)
    wt = isect.watertight_setup(o, d)
    best_t = seed_f[0, lanes]
    best_i = seed_i[0, lanes].to(torch.int64)
    nrm = tuple(seed_f[1 + c, lanes] for c in range(3))
    zero = torch.zeros_like(best_t)
    pos = (zero, zero, zero)  # not an output
    for k in range(len(static.mesh_parts)):
        best_t, best_i, pos, nrm = mk._scan_mesh_part(
            mesh_arrays[mk.ARRAYS_PER_PART * k], o, d, exclude, wt, best_t,
            best_i, pos, nrm)
    out_f[:, lanes] = torch.stack([best_t, *nrm])
    out_i[0, lanes] = best_i.to(torch.int32)
    return out_f, out_i


def walk(static: mk.SceneStatic, rays: torch.Tensor, seed_f: torch.Tensor,
         seed_i: torch.Tensor, *mesh_arrays,
         work: torch.Tensor | None = None):
    """Seeded walk over every mesh part -> (out_f (4, R) f32 [t, n.xyz],
    out_i (1, R) i32 [idx]), the contract of ``walk_reference``.

    CPU tensors run ``walk_reference``; CUDA tensors launch the kernel of
    csrc/walk.cu, built at first use; a failed build or launch raises.
    ``work``, a zeroed (4,) int64 CUDA tensor, selects the build that also
    adds its casts (active lanes), box tests, triangle plane tests and
    triangle inside tests to it."""
    global launches_walk
    if not static.mesh_parts:
        raise ValueError("the walk casts against mesh parts; the scene has "
                         "none")
    R = rays.shape[-1] if rays.dim() == 2 else -1
    dev = rays.device
    for name, t, shape, dtype in (
            ("rays", rays, (6, R), torch.float32),
            ("seed_f", seed_f, (4, R), torch.float32),
            ("seed_i", seed_i, (2, R), torch.int32)):
        mk._check_tensor(name, t, shape, dtype, dev)
    mk._check_parts(static, mesh_arrays, dev)
    if work is not None:
        mk._check_tensor("work", work, (4,), torch.int64, dev)
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("work counts are taken on the card: the plain "
                             "version counts nothing")
        return walk_reference(static, rays, seed_f, seed_i, *mesh_arrays)
    mk._require_cuda(dev)
    fn = mk._fn("walk", "walk")
    out_f = torch.empty((4, R), dtype=torch.float32, device=dev)
    out_i = torch.empty((1, R), dtype=torch.int32, device=dev)
    ptrs, info = mk._part_tables(static, mesh_arrays)
    mk._launch("walk", fn, dev, rays.data_ptr(), seed_f.data_ptr(),
               seed_i.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), R,
               len(static.mesh_parts), ctypes.addressof(ptrs),
               ctypes.addressof(info),
               None if work is None else work.data_ptr())
    launches_walk += 1
    return out_f, out_i
