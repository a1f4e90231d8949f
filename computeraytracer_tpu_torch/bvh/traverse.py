"""Stackless BVH traversal, masked over a ray batch (port of
computeraytracer_tpu/bvh/traverse.py).

Every ray carries one int of traversal state, its current node in DFS
order. One loop step gathers that node's box and fixed-width leaf for all
rays at once; the loop runs until the slowest ray escapes. The JAX
package's ``lax.while_loop`` condition (any ray still walking) is a host
read here, made every ``CHECK_EVERY`` steps: a ray that has escaped no
longer changes, so the extra steps are no-ops. At a check, when at most
half the rays still walk, the walking ones are compacted into a smaller
batch (the same arithmetic per ray, so the same winners). ``step_log``,
when a list, gets each cast's number of loop steps.

The loop runs under no_grad on detached values: which primitive wins is
a decision, not a function of the geometry. The winner's t, position and
normal are then recomputed differentiably, so gradients flow to the
geometry; the BVH itself is rebuilt on the host when vertices move.

Ties: the closest-hit accept is ``t < t_best``, exact ties broken toward
the HIGHER primitive id, the order-free form of the reference's in-order
scan with strict rejection (``ops.intersect.intersect_brute``'s
last-wins rule).
"""

from __future__ import annotations

import dataclasses

import torch

from computeraytracer_tpu_torch.bvh import builder
from computeraytracer_tpu_torch.ops import intersect as isect

T_MIN = isect.T_MIN
INF = isect.INF

# Loop steps between host reads of "is any ray still walking".
CHECK_EVERY = 16

# A list to log each cast's loop steps into, or None.
step_log = None


def _leaf_candidates(o, d, prims, pid, t_min):
    """Candidate t for gathered primitive rows pid (..., K); (t, valid)."""
    safe = pid.clamp(min=0)
    cat = isect.take(prims.category, safe)
    d1 = isect.take(prims.data1, safe)
    d2 = isect.take(prims.data2, safe)
    d3 = isect.take(prims.data3, safe)
    ob = o[..., None, :]
    db = d[..., None, :]
    t_p, ok_p = isect.patch_candidates(ob, db, d1, d2, d3)
    t_s, ok_s = isect.sphere_candidates(ob, db, d1, d2[..., 0], t_min, INF)
    t_t, ok_t = isect.triangle_candidates(ob, db, d1, d2, d3)
    t = torch.where(cat == isect.CAT_PATCH, t_p,
                    torch.where(cat == isect.CAT_SPHERE, t_s, t_t))
    ok = torch.where(cat == isect.CAT_PATCH, ok_p,
                     torch.where(cat == isect.CAT_SPHERE, ok_s, ok_t))
    return t, ok & (t >= t_min) & (pid >= 0)


def _step(bvh, prims, o, d, inv_d, exclude, node, t_best, idx_best, t_min):
    """One traversal step of every ray -> (node, t_best, idx_best)."""
    n_nodes = bvh.bbox_min.shape[0]
    active = node < n_nodes
    nidx = node.clamp(max=n_nodes - 1)
    t0 = (bvh.bbox_min[nidx] - o) * inv_d
    t1 = (bvh.bbox_max[nidx] - o) * inv_d
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    # pad the interval by 4 ulp (Ize 2013): shared mesh edges lie exactly
    # on node box faces, and an unpadded slab can cull an edge-grazing ray
    # before it reaches the one triangle whose watertight test accepts it
    pad = 4 * 2.0 ** -23
    t_exit = t_exit + t_exit.abs() * pad
    t_enter = t_enter - t_enter.abs() * pad
    hit_box = (active & (t_enter <= t_exit) & (t_exit >= t_min)
               & (t_enter <= t_best))

    pid = bvh.leaf_prims[nidx]            # (R, K)
    is_leaf = pid[:, 0] >= 0
    t_c, ok = _leaf_candidates(o, d, prims, pid, t_min)
    ok = ok & (hit_box & is_leaf)[:, None] & (pid != exclude[:, None])

    # fold the K slots; ties go to the higher primitive id
    for j in range(pid.shape[-1]):
        tj = t_c[:, j]
        pj = pid[:, j].long()
        better = ok[:, j] & ((tj < t_best) | ((tj == t_best)
                                              & (pj > idx_best)))
        t_best = torch.where(better, tj, t_best)
        idx_best = torch.where(better, pj, idx_best)

    descend = hit_box & ~is_leaf
    node = torch.where(active,
                       torch.where(descend, node + 1,
                                   bvh.miss[nidx].long()), node)
    return node, t_best, idx_best


def _detached(prims):
    return dataclasses.replace(prims, **{
        f.name: getattr(prims, f.name).detach()
        for f in dataclasses.fields(prims)})


@torch.no_grad()
def _walk(o, d, exclude, prims, bvh, t_min):
    """Winning primitive ids (R,) (-1 for a miss) of rays o, d (R, 3)."""
    n_nodes = bvh.bbox_min.shape[0]
    # slab test: 1/d with the sign of d kept, so the +-inf side of each
    # slab lands right for axis-parallel rays
    tiny = d.abs() < 1e-12
    sign = torch.where(d < 0.0, -1.0, 1.0)
    inv_d = torch.where(tiny, sign * 1e30, 1.0 / torch.where(tiny, 1.0, d))

    n = o.shape[0]
    rays = torch.arange(n, device=o.device)
    node = torch.zeros(n, dtype=torch.int64, device=o.device)
    t_best = torch.full((n,), INF, device=o.device)
    idx_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    out_idx = idx_best.clone()
    exclude = exclude.long()
    steps = 0
    while True:
        if steps % CHECK_EVERY == 0:
            walking = node < n_nodes
            n_walking = int(walking.sum())
            if n_walking == 0:
                break
            if n_walking <= node.shape[0] // 2:
                out_idx[rays] = idx_best
                keep = torch.nonzero(walking).reshape(-1)
                rays, o, d, inv_d, exclude, node, t_best, idx_best = (
                    x[keep] for x in (rays, o, d, inv_d, exclude, node,
                                      t_best, idx_best))
        node, t_best, idx_best = _step(bvh, prims, o, d, inv_d, exclude,
                                       node, t_best, idx_best, t_min)
        steps += 1
    out_idx[rays] = idx_best
    if step_log is not None:
        step_log.append(steps)
    return out_idx


def intersect_bvh(o, d, exclude, prims, bvh, t_min=T_MIN) -> isect.Hit:
    """Closest hit through the skip-link BVH; the contract of
    ``ops.intersect.intersect_brute``.

    o, d: (..., 3); exclude: (...,) int (-1 = none); bvh: BVHArrays (NumPy
    or tensors)."""
    batch = o.shape[:-1]
    bvh = builder.to_device(bvh, o.device)
    idx_best = _walk(o.detach().reshape(-1, 3), d.detach().reshape(-1, 3),
                     exclude.reshape(-1), _detached(prims), bvh,
                     t_min).reshape(batch)

    # differentiable recompute of the winner's hit record
    hit = idx_best >= 0
    winner = idx_best.clamp(min=0)
    t_re, _ = _leaf_candidates(o, d, prims, winner[..., None], t_min)
    return isect.hit_record(prims, winner, hit, t_re[..., 0], o, d)
