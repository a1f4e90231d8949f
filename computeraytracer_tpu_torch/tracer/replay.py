"""Guided replay: the backward of scenes with mesh parts (port of
computeraytracer_tpu/tracer/replay.py).

The forward kernel cannot be differentiated through its chunk-BVH walk,
so the winner-taped forward (``kernels.megakernel.forward_winners``,
``build_forward(taped=True)``) records each bounce's closest-hit winner
and each light's shadow winner. This module re-runs the same bounce
(``kernels.megakernel._bounce``) with every ray cast replaced by
``hit_from_index``: gather the winner's row of the FULL (P, 12) primitive
table and recompute only its intersection. The winner is locally
constant in the geometry, so torch autograd of the replay is the path
tracer's gradient with respect to every vertex, edge, radius and
spectrum, at O(rays * depth) cost whatever the triangle count.

It is plain torch on purpose, on the card as on the CPU: in the JAX
package the replay is XLA outside any Pallas kernel. Each bounce is one
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so
autograd keeps the carries between bounces and recomputes one bounce at
a time. The row gather's backward sums each row's cotangents in a fixed
order (``_row_sums``), not with atomics, so two runs give bit-equal
gradients.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops.camera import sqrt


# Rays per block of the first level of _row_sums.
SUM_BLOCK = 4096


def _row_sums(idx, g, n_rows):
    """``ops.intersect.row_sums`` in blocks of SUM_BLOCK rays: a fixed
    order, so two runs give bit-equal sums."""
    return isect.row_sums(idx, g, n_rows, SUM_BLOCK)


class _GatherRows(torch.autograd.Function):
    """table[idx] for a (P, k) table and (R,) int64 indices, whose
    backward sums the rows' cotangents into the table in a fixed order
    (``_row_sums``): two runs give bit-equal gradients."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _row_sums(idx, g, ctx.n_rows), None


def hit_from_index(prims_full, cats, idx, o, d):
    """Recompute the winner's intersection from its taped index.

    prims_full (P, 12) f32, the full primitive table (mesh triangles
    included); cats (P,) integer category per row; idx (R,) taped winner
    (-1 = miss); o, d 3-tuples of (R,) planes. Returns the hit dict of
    ``_scan_primitives`` ({hit, t, idx, pos, nrm}, misses zeroed as the
    scan leaves them), with the scans' formulas in their op order, so a
    winner's t, pos and nrm are the forward's bit for bit. The inside
    tests are not run again: the tape says the winner was valid.

    Every masked operand stays finite (a miss gathers row 0; the plane
    and sphere branches are both evaluated for every lane), so a zero
    cotangent never meets an infinite local derivative."""
    flat = idx.reshape(-1).clamp(min=0).to(torch.int64)
    rows = _GatherRows.apply(prims_full, flat)
    cat = cats.to(torch.int64)[flat]
    p = lambda c: rows[:, c]
    p0 = (p(0), p(1), p(2))
    # patches store edges in columns 3-8, triangles vertices: a
    # triangle's edges in the op order of its plane test
    is_tri = cat == 2
    e1 = tuple(torch.where(is_tri, p(3 + i) - p(i), p(3 + i))
               for i in range(3))
    e2 = tuple(torch.where(is_tri, p(6 + i) - p(i), p(6 + i))
               for i in range(3))

    # plane winner (patch or triangle): the plane test of the scans
    n_raw = mk._vcross(e1, e2)
    n_len2 = n_raw[0] * n_raw[0] + n_raw[1] * n_raw[1] + n_raw[2] * n_raw[2]
    inv_len = 1.0 / sqrt(torch.clamp(n_len2, min=1e-30))
    n0 = (n_raw[0] * inv_len, n_raw[1] * inv_len, n_raw[2] * inv_len)
    ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
    flip = ndotd > 0.0
    grazing = torch.abs(torch.where(flip, -ndotd, ndotd)) < 1e-4
    num = (n0[0] * (p0[0] - o[0]) + n0[1] * (p0[1] - o[1])
           + n0[2] * (p0[2] - o[2]))
    t_pl = num / torch.where(grazing, 1.0, ndotd)
    sgn = torch.where(flip, -1.0, 1.0)
    n_pl = (sgn * n0[0], sgn * n0[1], sgn * n0[2])

    # sphere winner, radius in column 3. A winning far root implies that
    # the near one is below T_MIN (a near root past the running best
    # never validates), so the winner's t is the near root when it is
    # admissible, else the far one.
    radius = p(3)
    co = mk._vsub(o, p0)
    a = mk._vdot(d, d)
    b = 2.0 * mk._vdot(d, co)
    c2 = mk._vdot(co, co) - radius * radius
    disc = b * b - 4.0 * a * c2
    sq = sqrt(torch.where(disc > 0.0, disc, 1.0))
    denom = torch.where(a > 1e-12, 2.0 * a, 1.0)
    t_near = (-b - sq) / denom
    t_far = (-b + sq) / denom
    t_sp = torch.where(t_near >= mk.T_MIN, t_near, t_far)

    is_sphere = cat == 1
    t = torch.where(is_sphere, t_sp, t_pl)
    pos = mk._vadd(o, mk._vscale(t, d))
    n_sp = mk._vnormalize(mk._vsub(pos, p0))
    nrm = mk._vwhere(is_sphere, n_sp, n_pl)

    miss = idx < 0
    zero = torch.zeros_like(t)
    return {"hit": ~miss, "t": torch.where(miss, torch.inf, t),
            "idx": idx.to(torch.int64),
            "pos": mk._vwhere(miss, (zero, zero, zero), pos),
            "nrm": mk._vwhere(miss, (zero, zero, zero), nrm)}


def _flatten(state):
    o, d, L, beta, last_pdf, eta_scale = state["diff"]
    seed, exclude, specular, in_trans, active = state["nondiff"]
    return (*o, *d, *L, *beta, last_pdf, eta_scale, *seed, exclude,
            specular, in_trans, active)


def _unflatten(planes):
    return {"diff": (planes[0:3], planes[3:6], planes[6:10], planes[10:14],
                     planes[14], planes[15]),
            "nondiff": (planes[16:20], planes[20], planes[21], planes[22],
                        planes[23])}


def trace_replay(static, cats, prims_full, rays, seeds, spect, tape_idx,
                 tape_sh, max_depth: int, rr_start: int):
    """Re-run the bounce loop guided by the winner tape -> radiance
    (4, R), differentiable with respect to prims_full (P, 12), rays
    (6, R) and spect (S*4, R).

    seeds (4, R) int64 u32 values; tape_idx (max_depth+1, R) and tape_sh
    (max_depth+1, n_lights, R), as ``forward_winners`` writes them. A
    bounce in which no ray is alive is the identity and is skipped."""
    prims_u = mk._unrolled(static, prims_full)
    # parts only: their ranges bind materials and spectra; every ray
    # cast goes through the taped winners
    mesh = tuple((part, ()) for part in static.mesh_parts)

    def step(depth, t_idx, t_sh, prims_full, prims_u, spect, *planes):
        def scan_fn(tag, so, sd, sexcl):
            idx = t_idx if tag == "main" else t_sh[tag[1]]
            return hit_from_index(prims_full, cats, idx, so, sd)

        out = mk._bounce(static, prims_u, spect, _unflatten(planes), depth,
                         max_depth, rr_start, mesh, scan_fn)
        return _flatten(out)

    planes = _flatten(mk._init_state(rays, seeds))
    for depth in range(int(max_depth) + 1):
        if not bool(planes[23].any()):
            break
        planes = checkpoint(step, depth, tape_idx[depth], tape_sh[depth],
                            prims_full, prims_u, spect, *planes,
                            use_reentrant=False, preserve_rng_state=False)
    return torch.stack(planes[6:10])
