"""Path-tracing megakernels: plain torch versions and CUDA wrappers.

Port of computeraytracer_tpu/kernels/megakernel.py ``build_forward``
(plain, mesh, ``taped="full"`` and ``taped=True`` modes),
``build_backward`` and ``build_backward_from_tape``. What lives here:

- ``SceneStatic.from_scene`` and ``pack_prims``: the scene structure
  (uniform triangle runs of at least ``mesh_min`` triangles become
  ``MeshPart``s, traced through the chunk BVH of ``kernels/meshpack.py``)
  and the (P, 12) table of the unrolled primitive rows.
- ``forward_reference``: the plain torch version of the forward. It ports
  ``make_bounce`` and the bounce loop of ``build_forward``, vectorised
  over the ray axis of (k, R) planes with ``torch.where`` masks, in the
  JAX package's op order. Mesh parts are scanned brute force in blocks of
  triangles (``_scan_mesh_part``): the mesh tie rule does not depend on
  the order in which triangles are tested.
- ``forward``: the wrapper with the TPU kernel's contract
  ``prims (P, 12) f32, rays (6, R) f32, seeds (4, R) u32 values,
  spect (S*4, R) f32, *mesh_arrays -> radiance (4, R) f32``, where
  mesh_arrays is (tri_rows, chunk_bbox, node_bbox, node_meta) per mesh
  part. CPU tensors run ``forward_reference``; CUDA tensors launch the
  hand-written kernel in ``csrc/megakernel_fwd.cu``. There is no other
  route.
- ``forward_refill_reference``, ``trips_from_tape`` and
  ``schedule_efficiency``: the plain model of the schedules on which the
  CUDA forward traces a scene without mesh parts (``csrc/forward.cuh``:
  persistent warps that refill their dead lanes one by one, or, for the
  taped forward without triangle rows, in groups of ``GROUP`` lanes), and
  the bounce loop's SIMT efficiency of rays in lockstep groups from a
  tape; the tests hold the model bit-equal to ``forward_reference`` and
  ``forward_taped_reference``, and the card's counting builds
  (``forward(..., trips=)``, ``forward_taped(..., trips=)``) against the
  tape.
- ``forward_taped_reference`` / ``forward_taped``: the forward that also
  returns the ``taped="full"`` tape, every bounce's input carry (the
  kernel ``megakernel_fwd_taped``); ``tape_to_jax`` turns it into the JAX
  package's three tape arrays.
- ``backward_reference`` / ``backward``: the retrace backward
  (``build_backward``, ``csrc/megakernel_bwd.cu``), ``... , dL (4, R) ->
  d_prims (P, 12), d_rays (6, R), d_spect (S*4, R)``.
- ``backward_from_tape_reference`` / ``backward_from_tape``: the
  tape-fed backward (``build_backward_from_tape``,
  ``csrc/megakernel_bwd_tape.cu``), ``prims, spect, tape_f, tape_i, dL
  -> d_prims, d_rays, d_spect``.
- ``forward_winners_reference`` / ``forward_winners``: the forward that
  also returns each bounce's closest-hit and shadow winners
  (``build_forward(taped=True)``, the kernel ``megakernel_fwd_winners``),
  the tape of the guided replay (tracer/replay.py).
- ``shade_step_reference`` / ``shade_step``: one bounce of the wavefront
  with the mesh winner given and NEE deferred (``build_shade_step``,
  ``csrc/shade_step.cu``; the plain version is ``_bounce(defer_nee=
  True)``). ``tracer/kernel.py`` ``wavefront_forward`` launches it once
  per bounce, with the binned casts of ``kernels/binned.py`` in between.
- ``TraceFn``, ``TraceTapedFn`` and ``MeshTraceFn``: the autograd
  Functions, analogues of the JAX package's ``tracer/pallas.py``
  ``_call_with_vjp``, ``_call_taped`` and ``_mesh_call``; the guided
  replay's forward and backward (``_replay_forward``,
  ``_replay_backward``) also serve the wavefront's Function.

Triangle rows (category 2) are differentiated by the backward kernels,
which scan them in their mesh mode and carry a triangle's cotangent into
its three vertices. Mesh parts are differentiated only through the guided
replay (``MeshTraceFn``); the full tape, the backward wrappers and the
first two Functions raise for them before any launch.

Seeds are int64 tensors holding u32 values (ops/rng.py); the kernel gets
an int32 tensor with the same bit pattern, and the tape holds them so.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import _build
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops.camera import sqrt
from computeraytracer_tpu_torch.utils import profiling

T_MIN = 0.001
ETA1, ETA2 = 1.0, 1.5
ARRAYS_PER_PART = 4  # tri_rows, chunk_bbox, node_bbox, node_meta
# Work counters of every counting build (csrc/bounce.cuh W_*): casts, box
# tests, triangle plane tests, triangle inside tests and, where a build
# traverses mesh parts (the mesh forward and the walk), its chunk scans,
# the lanes that ran them and the inside tests that any order of those
# scans needs; zero elsewhere.
WORK_KINDS = 7
# Sections of the reverse sweep's timed build (csrc/reverse.cuh T_*), in
# clock64() cycles summed over warps: the tape reads, the recompute's
# scans, the rest of the recompute, the adjoint, the d_spect traffic, the
# d_prims fold, and the rest (scene load, d_rays, the block's partial row
# and the wait for its slowest warp).
SWEEP_SECTIONS = ("tape_read", "scans", "recompute_rest", "adjoint",
                  "d_spect", "fold", "other")

# Bounds of the CUDA kernels' shared-memory tables (csrc/bounce.cuh): the
# unrolled rows, lights and mesh parts.
MAX_PRIMS = 256
MAX_LIGHTS = 64
MAX_SPECTRA = 1024
MAX_PARTS = 8

# Rays x triangles per block of the plain mesh scan (_scan_mesh_part).
MESH_BLOCK = 1 << 22

# Kernel launches, counted by each wrapper where it launches its kernel
# (CPU calls launch nothing and do not count): the forward in its plain
# mode and in its mesh mode, the taped forward, the retrace backward, the
# tape-fed backward, the winner-taped forward and the wavefront's shade
# step (the mesh casts' kernels count in kernels/binned.py).
launches = 0
launches_mesh = 0
launches_taped = 0
launches_bwd = 0
launches_bwd_tape = 0
launches_winners = 0
launches_shade = 0

MESH_PARTS_REPLAY = ("scenes with mesh parts differentiate through the "
                     "guided replay (MeshTraceFn, backward='replay', to "
                     "which the tracer routes them): the full tape and "
                     "the backward kernels cover unrolled rows only")


class MeshPart(NamedTuple):
    """A contiguous run of uniform-material triangles traced through the
    chunk BVH (kernels/meshpack.py) instead of the unrolled scan."""

    start: int             # first primitive row of the run
    count: int             # number of triangles
    n_chunks: int          # ceil(count / 128)
    material: int
    emission_idx: int
    reflectance_idx: int


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Non-differentiable scene structure (hashable).

    rows lists the original primitive id of each unrolled slot; the other
    tuples are aligned with it (categories: 0 patch, 1 sphere, 2 tri).
    Large uniform triangle runs are mesh_parts instead.
    """

    rows: tuple
    categories: tuple
    materials: tuple
    emission_idx: tuple
    reflectance_idx: tuple
    light_rows: tuple
    n_spectra: int
    mesh_parts: tuple = ()

    @property
    def mesh_mode(self) -> bool:
        """Whether the forward runs in mesh mode: mesh parts or triangle
        rows."""
        return bool(self.mesh_parts) or 2 in self.categories

    @classmethod
    def from_scene(cls, scene, mesh_min: int = 256) -> "SceneStatic":
        """Maximal runs of at least mesh_min non-light triangles with the
        same material and spectra become mesh parts; every other row is
        scanned in order (the JAX package's SceneStatic.from_scene)."""
        p = scene.primitives
        cat = [int(c) for c in p.category.tolist()]
        mat = [int(m) for m in p.material.tolist()]
        emi = [int(e) for e in p.emission.tolist()]
        ref = [int(r) for r in p.reflectance.tolist()]
        n = len(cat)
        parts = []
        in_mesh = [False] * n
        i = 0
        while i < n:
            if cat[i] == 2 and mat[i] != C.LIGHT:
                j = i
                while (j < n and cat[j] == 2 and mat[j] == mat[i]
                       and emi[j] == emi[i] and ref[j] == ref[i]):
                    j += 1
                if j - i >= mesh_min:
                    parts.append(MeshPart(
                        start=i, count=j - i,
                        n_chunks=-(-(j - i) // meshpack.TRIS_PER_CHUNK),
                        material=mat[i], emission_idx=emi[i],
                        reflectance_idx=ref[i]))
                    in_mesh[i:j] = [True] * (j - i)
                i = j
            else:
                i += 1
        rows = tuple(r for r in range(n) if not in_mesh[r])
        return cls(
            rows=rows,
            categories=tuple(cat[r] for r in rows),
            materials=tuple(mat[r] for r in rows),
            emission_idx=tuple(emi[r] for r in rows),
            reflectance_idx=tuple(ref[r] for r in rows),
            light_rows=tuple(int(x) for x in scene.lights.prim_index.tolist()),
            n_spectra=int(scene.spectra.shape[0]),
            mesh_parts=tuple(parts),
        )


def pack_prims(scene, static: SceneStatic | None = None) -> torch.Tensor:
    """(P, 12) f32: [origin/center/v0, edge1/radius/v1, edge2/v2, pad];
    sphere rows carry the radius at column 3. With a static that has mesh
    parts, only its unrolled rows (the mesh geometry travels in the
    packs of kernels/meshpack.py); the row gather is differentiable."""
    p = scene.primitives
    full = torch.cat([p.data1, p.data2, p.data3, torch.zeros_like(p.data1)],
                     dim=-1)
    if static is not None:
        full = _unrolled(static, full)
    return full.contiguous()


def _unrolled(static: SceneStatic, prims_full: torch.Tensor) -> torch.Tensor:
    """The static's unrolled rows of a full (P, 12) table (the table
    itself when every row is unrolled)."""
    if len(static.rows) == prims_full.shape[0]:
        return prims_full
    return prims_full[torch.tensor(static.rows, dtype=torch.int64,
                                   device=prims_full.device)]


# ---------------------------------------------------------------------------
# plain torch version: vec3 = 3-tuple of (R,) planes
# ---------------------------------------------------------------------------


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _vscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _vnormalize(a):
    s = _vdot(a, a)
    s = torch.where(s < 1e-20, 1.0, s)
    return _vscale(1.0 / sqrt(s), a)


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _rand_masked(seed, mask):
    new = rng.pcg4d_words(*seed)
    u = torch.where(mask, rng.to_unit_float(new[0]), 0.0)
    return u, tuple(torch.where(mask, n, o) for n, o in zip(new, seed))


def _patch_frame(row):
    """Per-patch constants of the plane test, in the JAX op order."""
    e1 = (row[3], row[4], row[5])
    e2 = (row[6], row[7], row[8])
    n_raw = _vcross(e1, e2)
    n_len2 = n_raw[0] * n_raw[0] + n_raw[1] * n_raw[1] + n_raw[2] * n_raw[2]
    inv_len = 1.0 / sqrt(torch.clamp(n_len2, min=1e-30))
    n0 = (n_raw[0] * inv_len, n_raw[1] * inv_len, n_raw[2] * inv_len)
    inv_e1 = 1.0 / torch.clamp(
        e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2], min=1e-12)
    inv_e2 = 1.0 / torch.clamp(
        e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2], min=1e-12)
    return e1, e2, n0, inv_e1, inv_e2


def _scan_primitives(static, prims, o, d, exclude, mesh=()):
    """In-order closest-hit scan: ``t <= best`` lets the LAST hit win
    ties (the coplanar ceiling light depends on it). Triangle rows take
    the watertight test; then each mesh part of ``mesh`` ((part, arrays)
    pairs) is scanned under the mesh tie rule."""
    shape = o[0].shape
    dev = o[0].device
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_t = torch.full(shape, math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full(shape, -1, dtype=torch.int64, device=dev)
    pos = (zero, zero, zero)
    nrm = (zero, zero, zero)
    d_dot_d = _vdot(d, d)
    wt = (isect.watertight_setup(o, d)
          if mesh or 2 in static.categories else None)
    for slot, (i, cat) in enumerate(zip(static.rows, static.categories)):
        row = prims[slot]
        not_excluded = exclude != i
        if cat == 2:
            v0 = (row[0], row[1], row[2])
            v1 = (row[3], row[4], row[5])
            v2 = (row[6], row[7], row[8])
            n0 = isect.unit_normal(v0, v1, v2)
            t, flip, grazing = isect.plane_t(n0, v0, o, d)
            p = _vadd(o, _vscale(t, d))
            valid = (not_excluded & ~grazing
                     & isect.watertight_inside(wt, v0, v1, v2)
                     & (t >= T_MIN) & (t <= best_t))
            sgn = torch.where(flip, -1.0, 1.0)
            n_eff = (sgn * n0[0], sgn * n0[1], sgn * n0[2])
        elif cat == 0:
            p0 = (row[0], row[1], row[2])
            e1, e2, n0, inv_e1, inv_e2 = _patch_frame(row)
            ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
            flip = ndotd > 0.0
            ndotd_f = torch.where(flip, -ndotd, ndotd)
            grazing = torch.abs(ndotd_f) < 1e-4
            num = (n0[0] * (p0[0] - o[0]) + n0[1] * (p0[1] - o[1])
                   + n0[2] * (p0[2] - o[2]))
            t = num / torch.where(grazing, 1.0, ndotd)
            p = _vadd(o, _vscale(t, d))
            m = _vsub(p, p0)
            u = _vdot(m, e1) * inv_e1
            v = _vdot(m, e2) * inv_e2
            inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
            valid = (not_excluded & ~grazing & inside
                     & (t >= T_MIN) & (t <= best_t))
            sgn = torch.where(flip, -1.0, 1.0)
            n_eff = (sgn * n0[0], sgn * n0[1], sgn * n0[2])
        elif cat == 1:
            cx = (row[0], row[1], row[2])
            radius = row[3]
            co = _vsub(o, cx)
            a = d_dot_d
            b = 2.0 * _vdot(d, co)
            c2 = _vdot(co, co) - radius * radius
            disc = b * b - 4.0 * a * c2
            has_root = disc > 0.0
            sq = sqrt(torch.where(has_root, disc, 1.0))
            denom = torch.where(a > 1e-12, 2.0 * a, 1.0)
            t_near = (-b - sq) / denom
            t_far = (-b + sq) / denom
            near_ok = (t_near >= T_MIN) & (t_near <= best_t)
            t = torch.where(near_ok, t_near, t_far)
            valid = (not_excluded & has_root & (a > 1e-12)
                     & (t >= T_MIN) & (t <= best_t))
            p = _vadd(o, _vscale(t, d))
            n_eff = _vnormalize(_vsub(p, cx))
        else:
            raise ValueError(f"unknown primitive category {cat}")
        best_t = torch.where(valid, t, best_t)
        best_i = torch.where(valid, i, best_i)
        pos = _vwhere(valid, p, pos)
        nrm = _vwhere(valid, n_eff, nrm)
    for _, arrays in mesh:  # the plain scan needs only tri_rows
        best_t, best_i, pos, nrm = _scan_mesh_part(
            arrays[0], o, d, exclude, wt, best_t, best_i, pos, nrm)
    return {"t": best_t, "idx": best_i, "pos": pos, "nrm": nrm,
            "hit": best_i >= 0}


def _scan_mesh_part(tri_rows, o, d, exclude, wt, best_t, best_i, pos, nrm):
    """Closest hit against every packed triangle of one mesh part, in
    blocks of triangles: the plain version of the kernels' chunk-BVH
    traversal (megakernel.py:337 _scan_mesh_part). A triangle wins when
    ``t < best`` or ``t == best`` with a higher id; that rule picks the
    least (t, -id) whatever the order of the tests, so a block reduces to
    its own winner and folds into the running best. Padding triangles
    (id -1) never win."""
    tri = tri_rows.reshape(-1, meshpack.LANES_PER_TRI)
    R = o[0].shape[0]
    block = max(1, MESH_BLOCK // max(R, 1))
    col = lambda x: x[:, None]
    oc, dc = tuple(map(col, o)), tuple(map(col, d))
    wtc = tuple(map(col, wt))
    ex = col(exclude)
    for a in range(0, tri.shape[0], block):
        blk = tri[a:a + block]
        w = lambda k: blk[:, k][None, :]
        v0, v1, v2 = (w(0), w(1), w(2)), (w(3), w(4), w(5)), (w(6), w(7), w(8))
        n0 = (w(10), w(11), w(12))
        tid = blk[:, 9].to(torch.int64)[None, :]
        t, flip, grazing = isect.plane_t(n0, v0, oc, dc)
        valid = ((ex != tid) & (tid >= 0) & ~grazing
                 & isect.watertight_inside(wtc, v0, v1, v2) & (t >= T_MIN))
        tv = torch.where(valid, t, math.inf)
        t_blk = tv.amin(dim=1)
        cand = valid & (tv == t_blk[:, None])
        id_blk = torch.where(cand, tid, -1).amax(dim=1)
        better = (id_blk >= 0) & ((t_blk < best_t)
                                  | ((t_blk == best_t) & (id_blk > best_i)))
        j = (cand & (tid == id_blk[:, None])).to(torch.int8).argmax(dim=1)
        sgn = torch.where(flip.gather(1, j[:, None])[:, 0], -1.0, 1.0)
        n_w = tuple(sgn * blk[:, 10 + c][j] for c in range(3))
        p = _vadd(o, _vscale(t_blk, d))
        best_t = torch.where(better, t_blk, best_t)
        best_i = torch.where(better, id_blk, best_i)
        pos = _vwhere(better, p, pos)
        nrm = _vwhere(better, n_w, nrm)
    return best_t, best_i, pos, nrm


def _bounce(static, prims, spect, state, depth, max_depth, rr_start,
            mesh=(), scan_fn=None, defer_nee=False):
    """One bounce of make_bounce over all lanes (JAX op order); mesh is
    the (part, arrays) pairs of the scene's mesh parts.

    scan_fn(tag, o, d, exclude) -> hit dict replaces every ray cast (tag
    "main" or ("nee", light ordinal)); by default each is the full
    closest-hit scan. The guided replay (tracer/replay.py) substitutes a
    taped-winner recompute, and then only the parts of ``mesh`` are read.

    Returns {"diff", "nondiff", "aux"}; aux = (hit_idx (R,), sh_idx per
    light), int64: the winners the replay reads. hit_idx is the closest
    hit where the ray entered the bounce alive; sh_idx[l] the shadow
    winner where the bounce is a diffuse scatter that picked light l;
    every other entry is -1.

    defer_nee (make_bounce's, megakernel.py:633-679, the shade step's):
    NEE is not added to L. aux gains the hit position and, per light,
    (ldir, t_su, contrib, lsel): the shadow ray's direction, the t of its
    scan's winner, the contribution ``(brdf * (l_emis * scale)) * beta``
    (the op order of the L update, so that adding it later gives the same
    bits) and whether the bounce picked the light; contrib is 0 where the
    scan found the light occluded."""
    if scan_fn is None:
        def scan_fn(tag, so, sd, sexcl):
            return _scan_primitives(static, prims, so, sd, sexcl, mesh)
    S = static.n_spectra
    n_lights = len(static.light_rows)
    lslot = {lr: static.rows.index(lr) for lr in static.light_rows}
    R = spect.shape[1]

    def gets(r):
        return tuple(spect[r * 4 + j] for j in range(4))

    def light_pdf(l_row, n_at_light, ray_dir, l_pos, r_origin):
        row = prims[lslot[l_row]]
        e1 = (row[3], row[4], row[5])
        e2 = (row[6], row[7], row[8])
        area = sqrt(torch.clamp(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2],
                                min=1e-30)) * sqrt(torch.clamp(
            e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2], min=1e-30))
        abs_cos = torch.clamp(torch.abs(-_vdot(n_at_light, ray_dir)),
                              min=1e-5)
        diff = _vsub(l_pos, r_origin)
        dist2 = _vdot(diff, diff)
        geo = abs_cos / torch.clamp(dist2, min=1e-12)
        pdf = (1.0 / torch.clamp(area, min=1e-12)) / geo / float(n_lights)
        return torch.clamp(pdf, 0.0, 1e16)

    def power_heuristic(f, g):
        r = g / torch.clamp(f, min=1e-12)
        return 1.0 / (1.0 + r * r)

    o, d, L, beta, last_pdf, eta_scale = state["diff"]
    seed, exclude, specular, in_trans, active = state["nondiff"]
    dev = o[0].device
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    inv_pi = 1.0 / math.pi

    hit = scan_fn("main", o, d, exclude)
    hit_aux = torch.where(active, hit["idx"], -1)
    lane_hit = active & hit["hit"]
    active = lane_hit
    exclude = torch.where(lane_hit, hit["idx"], exclude)
    idx = hit["idx"]

    false = torch.zeros((R,), dtype=torch.bool, device=dev)
    mat_light, mat_diffuse, mat_glass, mat_mirror = false, false, false, false
    for i, m in zip(static.rows, static.materials):
        sel = idx == i
        if m == C.LIGHT:
            mat_light = mat_light | sel
        elif m == C.DIFFUSE:
            mat_diffuse = mat_diffuse | sel
        elif m == C.GLASS:
            mat_glass = mat_glass | sel
        elif m == C.MIRROR:
            mat_mirror = mat_mirror | sel
    part_sels = []
    for part, _ in mesh:  # mesh parts are never lights
        sel = (idx >= part.start) & (idx < part.start + part.count)
        part_sels.append(sel)
        if part.material == C.DIFFUSE:
            mat_diffuse = mat_diffuse | sel
        elif part.material == C.GLASS:
            mat_glass = mat_glass | sel
        elif part.material == C.MIRROR:
            mat_mirror = mat_mirror | sel

    # ---- emissive hit
    is_light = lane_hit & mat_light
    le = [zero] * 4
    for i, m, ei in zip(static.rows, static.materials, static.emission_idx):
        if m == C.LIGHT:
            sel = idx == i
            emis = gets(ei)
            le = [torch.where(sel, emis[j], le[j]) for j in range(4)]
    pdf_l_hit = zero
    for lr in static.light_rows:
        sel = idx == lr
        pdf_l_hit = torch.where(
            sel, light_pdf(lr, hit["nrm"], d, hit["pos"], o), pdf_l_hit)
    weight_b = power_heuristic(last_pdf, pdf_l_hit)
    if depth == 0:
        mis_w = torch.ones_like(weight_b)
    else:
        mis_w = torch.where(specular, 1.0, weight_b)
    L = tuple(L[j] + torch.where(is_light, beta[j] * le[j] * mis_w, 0.0)
              for j in range(4))
    active = active & ~is_light

    scatter = active & (depth < max_depth)
    active = scatter

    # ---- Beer-Lambert
    ext = gets(S - 1)
    diffp = _vsub(hit["pos"], o)
    dsq = _vdot(diffp, diffp)
    dist = sqrt(torch.where(dsq > 0, dsq, 1.0)) * (dsq > 0)
    bl = scatter & in_trans
    beta = tuple(torch.where(bl, beta[j] * torch.exp(-ext[j] * dist), beta[j])
                 for j in range(4))

    is_diffuse = scatter & mat_diffuse
    is_glass = scatter & mat_glass
    is_mirror = scatter & mat_mirror

    # ---- DIFFUSE: NEE + cosine bounce (5 draws)
    u_l, seed = _rand_masked(seed, is_diffuse)
    u_p, seed = _rand_masked(seed, is_diffuse)
    v_p, seed = _rand_masked(seed, is_diffuse)
    u_h, seed = _rand_masked(seed, is_diffuse)
    v_h, seed = _rand_masked(seed, is_diffuse)

    brdf = [zero] * 4
    for i, m, ri in zip(static.rows, static.materials, static.reflectance_idx):
        if m == C.DIFFUSE:
            sel = idx == i
            refl = gets(ri)
            brdf = [torch.where(sel, refl[j], brdf[j]) for j in range(4)]
    for (part, _), sel in zip(mesh, part_sels):
        if part.material == C.DIFFUSE:
            refl = gets(part.reflectance_idx)
            brdf = [torch.where(sel, refl[j], brdf[j]) for j in range(4)]
    brdf = [b * inv_pi for b in brdf]

    li = torch.clamp((u_l * float(n_lights)).to(torch.int64), 0, n_lights - 1)
    nee = [zero] * 4
    sh_aux = []
    nee_aux = []
    for l_i, lr in enumerate(static.light_rows):
        lsel = is_diffuse & (li == l_i)
        row = prims[lslot[lr]]
        l_o = (row[0], row[1], row[2])
        l_e1 = (row[3], row[4], row[5])
        l_e2 = (row[6], row[7], row[8])
        p_l = tuple(l_o[c] + u_p * l_e1[c] + v_p * l_e2[c] for c in range(3))
        ldir = _vnormalize(_vsub(p_l, hit["pos"]))
        sh = scan_fn(("nee", l_i), hit["pos"], ldir, hit["idx"])
        sh_aux.append(torch.where(lsel, sh["idx"], -1))
        unocc = sh["hit"] & (sh["idx"] == lr)
        cos_t = torch.clamp(_vdot(hit["nrm"], ldir), min=0.0)
        pdf_l = light_pdf(lr, sh["nrm"], ldir, sh["pos"], hit["pos"])
        pdf_b = cos_t * inv_pi
        w_l = power_heuristic(pdf_l, pdf_b)
        scale = torch.where(lsel & unocc,
                            cos_t * w_l / torch.clamp(pdf_l, min=1e-12), 0.0)
        l_emis = gets(static.emission_idx[lslot[lr]])
        if defer_nee:
            contrib = tuple((brdf[j] * (l_emis[j] * scale)) * beta[j]
                            for j in range(4))
            nee_aux.append((ldir, sh["t"], contrib, lsel))
        else:
            nee = [nee[j] + l_emis[j] * scale for j in range(4)]
    if not defer_nee:
        L = tuple(L[j] + brdf[j] * nee[j] * beta[j] for j in range(4))

    # cosine hemisphere
    r_h = sqrt(torch.clamp(u_h, min=0.0))
    th = (2.0 * math.pi) * v_h
    xh = r_h * torch.cos(th)
    yh = r_h * torch.sin(th)
    zh = sqrt(torch.clamp(1.0 - u_h, min=0.0))
    n = hit["nrm"]
    z_minor = torch.abs(n[2]) < 0.999
    up = (torch.where(z_minor, 0.0, 1.0), zero, torch.where(z_minor, 1.0, 0.0))
    tangent = _vnormalize(_vcross(up, n))
    bitangent = _vcross(n, tangent)
    bounce_d = tuple(tangent[c] * xh + bitangent[c] * yh + n[c] * zh
                     for c in range(3))
    bounce_pdf = zh * inv_pi
    cos_b = torch.abs(_vdot(n, bounce_d))
    bfac = cos_b / torch.clamp(bounce_pdf, min=1e-12)
    beta_diffuse = tuple(beta[j] * brdf[j] * bfac for j in range(4))

    # ---- GLASS (1 draw)
    u_g, seed = _rand_masked(seed, is_glass)
    cos_in = _vdot(n, d)
    cosi = torch.clamp(cos_in, -1.0, 1.0)
    fe = torch.where(cosi > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    sint2 = fe * fe * (1.0 - cosi * cosi)
    tir = sint2 > 1.0
    cost = sqrt(torch.where(tir, 1.0, 1.0 - sint2))
    ci = torch.abs(cosi)
    rs = (ETA1 * ci - ETA2 * cost) / (ETA1 * ci + ETA2 * cost)
    rp = (ETA2 * ci - ETA1 * cost) / (ETA2 * ci + ETA1 * cost)
    reflectance = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    eta = torch.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    flip_n = cos_in > 0.0
    ng = _vwhere(flip_n, tuple(-c for c in n), n)
    nd2 = 2.0 * _vdot(ng, d)
    refl_dir = _vsub(d, _vscale(nd2, ng))
    ndoti = _vdot(ng, d)
    kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    ktir = kk < 0.0
    sqk = sqrt(torch.where(ktir, 1.0, kk))
    rft = _vsub(_vscale(eta, d), _vscale(eta * ndoti + sqk, ng))
    rft = _vwhere(ktir, (zero, zero, zero), rft)
    refr_dir = _vnormalize(rft)
    pr = reflectance
    choose_refl = u_g < pr / torch.clamp(pr + (1.0 - pr), min=1e-12)
    glass_dir = _vwhere(choose_refl, refl_dir, refr_dir)
    eta2v = eta * eta
    beta_glass = tuple(torch.where(choose_refl, beta[j], beta[j] * eta2v)
                       for j in range(4))
    eta_scale_glass = torch.where(choose_refl, eta_scale, eta_scale / eta2v)
    toggle_trans = is_glass & ~choose_refl

    # ---- MIRROR
    nd2m = 2.0 * _vdot(n, d)
    mirror_dir = _vsub(d, _vscale(nd2m, n))

    # ---- merge
    o = _vwhere(scatter, hit["pos"], o)
    d = _vwhere(is_diffuse, bounce_d,
                _vwhere(is_glass, glass_dir,
                        _vwhere(is_mirror, mirror_dir, d)))
    beta = tuple(torch.where(is_diffuse, beta_diffuse[j],
                             torch.where(is_glass, beta_glass[j], beta[j]))
                 for j in range(4))
    last_pdf = torch.where(is_diffuse, bounce_pdf, last_pdf)
    is_spec_bounce = is_glass | is_mirror
    specular = is_spec_bounce | (specular & ~(is_diffuse | is_spec_bounce))
    exclude = torch.where(is_spec_bounce, -1, exclude)
    eta_scale = torch.where(is_glass, eta_scale_glass, eta_scale)
    in_trans = in_trans ^ toggle_trans

    # ---- Russian roulette
    r0 = beta[0] * eta_scale
    r1 = beta[1] * eta_scale
    r2 = beta[2] * eta_scale
    max_c = torch.maximum(r0, torch.maximum(r1, r2))
    rr = active & (max_c < 1.0) if depth > rr_start else false
    u_r, seed = _rand_masked(seed, rr)
    q = torch.clamp(1.0 - max_c, min=0.0)
    killed = rr & (u_r < q)
    active = active & ~killed
    surv = rr & ~killed
    inv1q = 1.0 / torch.clamp(1.0 - q, min=1e-12)
    beta = tuple(torch.where(surv, beta[j] * inv1q, beta[j])
                 for j in range(4))

    aux = (hit_aux, tuple(sh_aux))
    if defer_nee:
        aux += (hit["pos"], tuple(nee_aux))
    return {"diff": (o, d, L, beta, last_pdf, eta_scale),
            "nondiff": (seed, exclude, specular, in_trans, active),
            "aux": aux}


def _init_state(rays, seeds):
    """The carry camera rays start with."""
    R = rays.shape[1]
    dev = rays.device
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    return {
        "diff": ((rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5]),
                 (zero,) * 4, (one,) * 4, one, one),
        "nondiff": (tuple(seeds.unbind(0)),
                    torch.full((R,), -1, dtype=torch.int64, device=dev),
                    torch.zeros((R,), dtype=torch.bool, device=dev),
                    torch.zeros((R,), dtype=torch.bool, device=dev),
                    torch.ones((R,), dtype=torch.bool, device=dev)),
    }


def _mesh(static, mesh_arrays):
    """(part, arrays) pairs of the static's mesh parts."""
    k = ARRAYS_PER_PART
    return tuple((part, mesh_arrays[k * i:k * (i + 1)])
                 for i, part in enumerate(static.mesh_parts))


def forward_reference(static: SceneStatic, max_depth: int, rr_start: int,
                      prims: torch.Tensor, rays: torch.Tensor,
                      seeds: torch.Tensor, spect: torch.Tensor,
                      *mesh_arrays) -> torch.Tensor:
    """Plain torch forward: (4, R) radiance, on the inputs' device.

    A bounce over all-dead rays is the identity (every update is masked
    by ``active``), so the loop stops once no ray is alive."""
    mesh = _mesh(static, mesh_arrays)
    state = _init_state(rays, seeds)
    for depth in range(max_depth + 1):
        if not bool(state["nondiff"][4].any()):
            break
        state = _bounce(static, prims, spect, state, depth, max_depth,
                        rr_start, mesh)
    return torch.stack(state["diff"][2])


# ---------------------------------------------------------------------------
# the taped="full" tape: each bounce's input carry
# ---------------------------------------------------------------------------

TAPE_F = 16  # o3 d3 L4 beta4 last_pdf eta_scale
TAPE_I = 8   # seed words (u32 bits), exclude, specular, in_trans, active


def _u32_bits(x):
    """int64 u32 values -> int32 tensor with the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _tape_row(state):
    """(16, R) f32 and (8, R) i32 planes of one input carry."""
    o, d, L, beta, last_pdf, eta_scale = state["diff"]
    seed, exclude, specular, in_trans, active = state["nondiff"]
    f = torch.stack([*o, *d, *L, *beta, last_pdf, eta_scale])
    i = torch.stack([*(_u32_bits(w) for w in seed), exclude.to(torch.int32),
                     specular.to(torch.int32), in_trans.to(torch.int32),
                     active.to(torch.int32)])
    return f, i


def _state_from_tape(f, i):
    """The carry of one tape row ((16, R) float planes, (8, R) i32)."""
    planes = tuple(f.unbind(0))
    diff = (planes[0:3], planes[3:6], planes[6:10], planes[10:14],
            planes[14], planes[15])
    seed = tuple(w.to(torch.int64) & 0xFFFFFFFF for w in i[0:4])
    nondiff = (seed, i[4].to(torch.int64), i[5] != 0, i[6] != 0, i[7] != 0)
    return {"diff": diff, "nondiff": nondiff}


def forward_taped_reference(static: SceneStatic, max_depth: int,
                            rr_start: int, prims: torch.Tensor,
                            rays: torch.Tensor, seeds: torch.Tensor,
                            spect: torch.Tensor):
    """Plain torch taped forward: (radiance (4, R), tape_f
    ((max_depth+1) * 16, R) f32, tape_i ((max_depth+1) * 8, R) i32), the
    tape holding every bounce's input carry. Rows after a ray died hold
    its final carry with active = 0, as build_forward(taped="full")
    writes them."""
    state = _init_state(rays, seeds)
    rows_f, rows_i = [], []
    for depth in range(max_depth + 1):
        f, i = _tape_row(state)
        rows_f.append(f)
        rows_i.append(i)
        if bool(state["nondiff"][4].any()):
            state = _bounce(static, prims, spect, state, depth, max_depth,
                            rr_start)
    return (torch.stack(state["diff"][2]), torch.cat(rows_f).contiguous(),
            torch.cat(rows_i).contiguous())


def forward_winners_reference(static: SceneStatic, max_depth: int,
                              rr_start: int, prims: torch.Tensor,
                              rays: torch.Tensor, seeds: torch.Tensor,
                              spect: torch.Tensor, *mesh_arrays):
    """Plain torch winner-taped forward (build_forward(taped=True)):
    (radiance (4, R), tape_idx (max_depth+1, R) i32, tape_sh
    (max_depth+1, n_lights, R) i32). tape_idx[k] is the closest-hit
    winner where the ray is alive at bounce k, tape_sh[k, l] the shadow
    winner where bounce k is a diffuse scatter that picked light l; every
    other entry, and every row after the ray died, is -1."""
    mesh = _mesh(static, mesh_arrays)
    R = rays.shape[1]
    D = int(max_depth) + 1
    n_lights = len(static.light_rows)
    tape_idx = torch.full((D, R), -1, dtype=torch.int32, device=rays.device)
    tape_sh = torch.full((D, n_lights, R), -1, dtype=torch.int32,
                         device=rays.device)
    state = _init_state(rays, seeds)
    for depth in range(D):
        if not bool(state["nondiff"][4].any()):
            break
        state = _bounce(static, prims, spect, state, depth, max_depth,
                        rr_start, mesh)
        hit_idx, sh_idx = state["aux"]
        tape_idx[depth] = hit_idx.to(torch.int32)
        for l_i, w in enumerate(sh_idx):
            tape_sh[depth, l_i] = w.to(torch.int32)
    return torch.stack(state["diff"][2]), tape_idx, tape_sh


def tape_to_jax(tape_f: torch.Tensor, tape_i: torch.Tensor):
    """The port's tape as the JAX package's taped="full" arrays, NumPy:
    (tape_f (D, 16, R) f32, tape_u (D, 4, R) u32 seed words,
    tape_i (D, 4, R) i32 exclude / specular / in_trans / active)."""
    R = tape_f.shape[1]
    f = tape_f.detach().cpu().reshape(-1, TAPE_F, R).numpy()
    i = tape_i.detach().cpu().reshape(-1, TAPE_I, R).numpy()
    return f, i[:, :4].view("uint32").copy(), i[:, 4:].copy()


# ---------------------------------------------------------------------------
# the refill schedule of the forward kernel (csrc/forward.cuh)
# ---------------------------------------------------------------------------

WARP = 32
# Dead lanes at which a warp of the refill schedule takes new rays
# (csrc/forward.cuh REFILL_AT).
REFILL_AT = 8
# Lanes of a group of the taped forward's group schedule (csrc/forward.cuh
# GROUP): 16 consecutive rays' words of one tape row, two 32-byte sectors.
GROUP = 16
# Counters of the persistent schedules' counting builds (csrc/forward.cuh
# TRIP_*): bounce calls, and 32 per trip of a warp.
TRIP_COUNTS = ("lane_trips", "warp_trips")


def trips_from_tape(tape_i: torch.Tensor) -> torch.Tensor:
    """Bounce-loop trips per ray (R,) int64 from a taped="full" tape: the
    rows whose active word is set (a ray enters one bounce per live
    row)."""
    R = tape_i.shape[-1]
    return tape_i.reshape(-1, TAPE_I, R)[:, 7].to(torch.int64).sum(dim=0)


def schedule_efficiency(trips: torch.Tensor, width: int = WARP) -> float:
    """SIMT efficiency of rays in lockstep groups: rays in order, `width`
    consecutive rays per group (the last group padded with idle lanes),
    each group running as many trips as its longest ray. Lane trips over
    group trips times width. width = WARP is the one-thread schedule's
    warp, width = GROUP the group schedule's group, whose warps then
    refill each group on its own."""
    n = trips.numel()
    padded = torch.zeros(-(-n // width) * width, dtype=torch.int64)
    padded[:n] = trips.detach().cpu().to(torch.int64)
    slots = padded.reshape(-1, width).amax(dim=1).sum() * width
    return float(padded.sum()) / float(slots) if slots else 1.0


def forward_refill_reference(static: SceneStatic, max_depth: int,
                             rr_start: int, prims: torch.Tensor,
                             rays: torch.Tensor, seeds: torch.Tensor,
                             spect: torch.Tensor, *mesh_arrays,
                             lanes: int = 4 * WARP,
                             threshold: int = REFILL_AT, group: int = 1,
                             taped: bool = False):
    """Plain model of the persistent-warp schedules (csrc/forward.cuh),
    for the tests: a pool of `lanes` lanes in warps of 32, cut into groups
    of `group` lanes, and one ray counter. A group is free when none of
    its lanes holds a ray. At the top of each trip, warp by warp, a warp
    whose free groups hold `threshold` lanes (or that is all free) takes
    `group` consecutive ray ids from the counter for each free group, by
    rank among them; an id >= R leaves its lane idle. Then every lane of
    a started group writes, with `taped`, its tape row at the group's
    depth (a live ray its input carry, a dead one its final carry with
    active = 0), every live lane runs one bounce (the lanes grouped by
    depth, one ``_bounce`` per depth), and each started group's depth goes
    up by one. A group whose last ray died writes its radiance and, with
    `taped`, its rows after that depth (final carry, active = 0), and is
    free. The loop ends when no lane is live after a refill.

    ``group=1`` is the refill schedule (refill_fwd_kernel, a lane retiring
    as soon as its ray dies), ``group=GROUP`` with the default threshold
    the taped forward's group schedule (group_taped_kernel, which takes
    rays for every free group). Returns what ``forward_reference``
    returns, or with `taped` what ``forward_taped_reference`` returns
    (mesh parts not taped), and (lane trips, warp trips) as the counting
    builds count them."""
    if lanes <= 0 or lanes % WARP or not 1 <= threshold <= WARP \
            or group <= 0 or WARP % group:
        raise ValueError(f"lanes must be a positive multiple of {WARP}, "
                         f"threshold in 1..{WARP} and group a divisor of "
                         f"{WARP} (got {lanes}, {threshold}, {group})")
    mesh = _mesh(static, mesh_arrays)
    R = rays.shape[1]
    D = int(max_depth) + 1
    dev = rays.device
    out = torch.zeros((4, R), dtype=torch.float32, device=dev)
    if taped:
        tape_f = torch.empty((D * TAPE_F, R), dtype=torch.float32,
                             device=dev)
        tape_i = torch.empty((D * TAPE_I, R), dtype=torch.int32, device=dev)
    per_warp = WARP // group
    offsets = torch.arange(group, device=dev)
    # each lane's carry, as tape planes; its ray (-1: none) and whether the
    # ray is alive; each group's depth
    pool_f = torch.zeros((TAPE_F, lanes), dtype=torch.float32, device=dev)
    pool_i = torch.zeros((TAPE_I, lanes), dtype=torch.int32, device=dev)
    ray = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
    alive = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    depth = torch.zeros((lanes // group,), dtype=torch.int64, device=dev)
    issued = lane_trips = warp_trips = 0

    def write_rows(idx, d):
        r = ray[idx]
        tape_f[d * TAPE_F:(d + 1) * TAPE_F, r] = pool_f[:, idx]
        tape_i[d * TAPE_I:(d + 1) * TAPE_I, r] = pool_i[:, idx]

    while True:
        free = ~(ray >= 0).reshape(-1, group).any(dim=1)
        for w, n in enumerate(free.reshape(-1, per_warp).sum(dim=1).tolist()):
            if issued >= R or not (n * group >= threshold or n == per_warp):
                continue
            g = w * per_warp + torch.nonzero(
                free[w * per_warp:(w + 1) * per_warp]).flatten()
            idx = (g[:, None] * group + offsets).flatten()
            ids = issued + torch.arange(n * group, device=dev)
            issued += n * group
            idx, ids = idx[ids < R], ids[ids < R]
            ray[idx] = ids
            alive[idx] = True
            depth[g] = 0
            pool_f[:, idx], pool_i[:, idx] = _tape_row(
                _init_state(rays[:, ids], seeds[:, ids]))
        if not bool(alive.any()):
            break
        lane_trips += int(alive.sum())
        warp_trips += WARP * int(alive.reshape(-1, WARP).any(dim=1).sum())
        held = ray >= 0
        lane_depth = depth.repeat_interleave(group)
        for d in torch.unique(lane_depth[held]).tolist():
            if taped:
                write_rows(torch.nonzero(held & (lane_depth == d)).flatten(),
                           d)
            idx = torch.nonzero(alive & (lane_depth == d)).flatten()
            if not idx.numel():
                continue
            r = ray[idx]
            state = _bounce(static, prims, spect[:, r],
                            _state_from_tape(pool_f[:, idx], pool_i[:, idx]),
                            d, max_depth, rr_start, mesh)
            pool_f[:, idx], pool_i[:, idx] = _tape_row(state)
            alive[idx] = pool_i[7, idx] != 0
        started = held.reshape(-1, group).any(dim=1)
        depth[started] += 1
        done = started & ~alive.reshape(-1, group).any(dim=1)
        retire = done.repeat_interleave(group) & held
        idx = torch.nonzero(retire).flatten()
        out[:, ray[idx]] = pool_f[6:10, idx]
        if taped:
            lane_depth = depth.repeat_interleave(group)
            for k in range(D):
                write_rows(idx[lane_depth[idx] <= k], k)
        ray[idx] = -1
        alive[idx] = False
    trips = (lane_trips, warp_trips)
    if taped:
        return out, tape_f, tape_i, trips
    return out, trips


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _require_no_parts(static: SceneStatic) -> None:
    """The full tape and the backward kernels cover the unrolled rows
    (triangle rows included), not the mesh parts' chunk-BVH walk."""
    if static.mesh_parts:
        raise NotImplementedError(MESH_PARTS_REPLAY)


def _check_tensor(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_static(static: SceneStatic):
    P = len(static.rows)
    S = static.n_spectra
    if not static.light_rows:
        raise ValueError("scene has no lights")
    if P > MAX_PRIMS or len(static.light_rows) > MAX_LIGHTS \
            or S > MAX_SPECTRA or len(static.mesh_parts) > MAX_PARTS:
        raise ValueError(
            f"kernel bounds: at most {MAX_PRIMS} unrolled primitives, "
            f"{MAX_LIGHTS} lights, {MAX_SPECTRA} spectra, {MAX_PARTS} mesh "
            f"parts (got {P}, {len(static.light_rows)}, {S}, "
            f"{len(static.mesh_parts)})")


def _check(static: SceneStatic, prims, rays, seeds, spect, mesh_arrays):
    _check_static(static)
    P = len(static.rows)
    S = static.n_spectra
    R = rays.shape[-1] if rays.dim() == 2 else -1
    dev = rays.device
    for name, t, shape, dtype in (
            ("prims", prims, (P, 12), torch.float32),
            ("rays", rays, (6, R), torch.float32),
            ("seeds", seeds, (4, R), torch.int64),
            ("spect", spect, (S * 4, R), torch.float32)):
        _check_tensor(name, t, shape, dtype, dev)
    _check_parts(static, mesh_arrays, dev)


def _check_parts(static: SceneStatic, mesh_arrays, dev):
    """The mesh arrays: (tri_rows, chunk_bbox, node_bbox, node_meta) per
    mesh part, on dev."""
    if len(mesh_arrays) != ARRAYS_PER_PART * len(static.mesh_parts):
        raise ValueError(
            f"{len(mesh_arrays)} mesh arrays for {len(static.mesh_parts)} "
            f"mesh parts: expected (tri_rows, chunk_bbox, node_bbox, "
            f"node_meta) per part")
    for k, part in enumerate(static.mesh_parts):
        tri, cbox, nbox, nmeta = mesh_arrays[ARRAYS_PER_PART * k:
                                             ARRAYS_PER_PART * (k + 1)]
        n_real = -(-part.count // meshpack.TRIS_PER_CHUNK)
        for name, t, shape, dtype in (
                ("tri_rows", tri, (n_real * meshpack.ROWS_PER_CHUNK, 128),
                 torch.float32),
                ("chunk_bbox", cbox, (cbox.shape[0], 8), torch.float32),
                ("node_bbox", nbox, (nmeta.shape[0], 8), torch.float32),
                ("node_meta", nmeta, (nbox.shape[0], 8), torch.int32)):
            _check_tensor(f"mesh part {k} {name}", t, shape, dtype, dev)
        if cbox.shape[0] < n_real:
            raise ValueError(f"mesh part {k}: {cbox.shape[0]} chunk boxes "
                             f"for {n_real} chunks")


@functools.lru_cache(maxsize=16)
def _tables(static: SceneStatic, device: torch.device):
    """int32 kernel tables: per slot, then per mesh part, (row, category,
    material, emission, reflectance); per light (row, slot)."""
    meta = torch.tensor(
        list(zip(static.rows, static.categories, static.materials,
                 static.emission_idx, static.reflectance_idx))
        + [(p.start, 2, p.material, p.emission_idx, p.reflectance_idx)
           for p in static.mesh_parts],
        dtype=torch.int32).reshape(-1, 5)
    lights = torch.tensor(
        [(lr, static.rows.index(lr)) for lr in static.light_rows],
        dtype=torch.int32).reshape(-1, 2)
    return meta.to(device), lights.to(device)


# Argument kinds of each C entry point (csrc/*.cu): "p" a pointer or the
# stream, "i" an int, "q" a long long.
SIGNATURES = {
    "megakernel_fwd": "ppipipppipqiiiipppppp",
    "megakernel_fwd_taped": "ppipipppipppqiiippp",
    "megakernel_fwd_winners": "ppipipppipppqiiiippp",
    "megakernel_bwd": "ppipipppipppppppqiiipp",
    "megakernel_bwd_timed": "ppipipppipppppppqiiippp",
    "megakernel_bwd_tape": "ppipipipppppppqiiip",
    "megakernel_bwd_tape_timed": "ppipipipppppppqiiipp",
    "shade_step": "ppipipi" + "p" * 15 + "qiiiip",
    "walk": "pppppqipppp",
    "candidates": "pppppqiiipp",
    "pair_closest": "pppppqipp",
    "pair_any": "ppppqipp",
    "pair_timed": "pppppqiipp",
    "ray_setup": "ppppppqiippppqp",
    "ray_setup_bwd": "ppppppqiippppqp",
    "hero_gather": "pppppiiiqp",
    "hero_column_sums": "pppppiiqip",
}


def _fn(lib_name, fn_name):
    """The typed C entry point fn_name of csrc/<lib_name>.cu."""
    fn = getattr(_build.library(lib_name), fn_name)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "q": ctypes.c_longlong}
    fn.argtypes = [kinds[k] for k in SIGNATURES[fn_name]]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, fn, device, *args):
    """Call a kernel entry point on the device's current stream, inside
    the span ``kernel:<name>`` (``utils.profiling.annotate``); raise on a
    CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        with profiling.annotate("kernel:" + name):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _require_cuda(device):
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")


def forward(static: SceneStatic, max_depth: int, rr_start: int,
            prims: torch.Tensor, rays: torch.Tensor, seeds: torch.Tensor,
            spect: torch.Tensor, *mesh_arrays,
            work: torch.Tensor | None = None,
            trips: torch.Tensor | None = None) -> torch.Tensor:
    """Forward megakernel -> radiance (4, R) f32.

    CPU tensors run ``forward_reference``. CUDA tensors launch the CUDA
    kernel, built from csrc/megakernel_fwd.cu at first use, in its mesh
    mode when the scene has mesh parts or triangle rows; a failed build or
    launch raises. A scene without mesh parts runs on persistent warps
    that refill their dead lanes (``forward_refill_reference`` models the
    schedule). ``work``, a (WORK_KINDS,) int64 CUDA tensor, makes the
    mesh mode add its work to it: casts (closest-hit and shadow scans),
    box tests, triangle plane tests, triangle inside tests, chunk scans,
    the lanes that ran them (the warp's lanes scan an entered chunk
    together) and the inside tests those scans need. ``trips``, a
    (len(TRIP_COUNTS),) int64 CUDA tensor, makes the refill schedule of a
    scene without mesh parts add its lane and warp trips to it. Each
    selects a build of the same code that also counts; the plain version
    counts nothing."""
    global launches, launches_mesh
    _check(static, prims, rays, seeds, spect, mesh_arrays)
    dev = rays.device
    if work is not None:
        if not static.mesh_mode:
            raise ValueError("work counts are taken in the mesh mode only")
        _check_tensor("work", work, (WORK_KINDS,), torch.int64, dev)
    if trips is not None:
        if static.mesh_parts or work is not None:
            raise ValueError("trip counts are taken on scenes without mesh "
                             "parts, and not with work counts")
        _check_tensor("trips", trips, (len(TRIP_COUNTS),), torch.int64, dev)
    if dev.type == "cpu":
        if work is not None or trips is not None:
            raise ValueError("work and trip counts are taken on the card: "
                             "the plain version counts nothing")
        return forward_reference(static, max_depth, rr_start, prims, rays,
                                 seeds, spect, *mesh_arrays)
    _require_cuda(dev)
    fn = _fn("megakernel_fwd", "megakernel_fwd")
    meta, lights = _tables(static, dev)
    R = rays.shape[1]
    out = torch.empty((4, R), dtype=torch.float32, device=dev)
    ptrs, info = _part_tables(static, mesh_arrays)
    seeds32 = _u32_bits(seeds)
    counter = (_ray_counter(dev) if not static.mesh_parts and work is None
               else None)
    _launch("megakernel_fwd", fn, dev, prims.data_ptr(), meta.data_ptr(),
            len(static.rows), lights.data_ptr(), lights.shape[0],
            rays.data_ptr(), seeds32.data_ptr(), spect.data_ptr(),
            static.n_spectra, out.data_ptr(), R, int(max_depth),
            int(rr_start), int(static.mesh_mode), len(static.mesh_parts),
            ctypes.addressof(ptrs), ctypes.addressof(info),
            None if work is None else work.data_ptr(),
            None if counter is None else counter.data_ptr(),
            None if trips is None else trips.data_ptr())
    if static.mesh_mode:
        launches_mesh += 1
    else:
        launches += 1
    return out


def _ray_counter(device):
    """The refill schedule's ray counter: one zeroed u64 (as int64) on
    the device, zeroed on its current stream."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def _part_tables(static: SceneStatic, mesh_arrays):
    """Host tables of the mesh parts for a launch: the device pointers of
    (tri_rows, chunk_bbox, node_bbox, node_meta) per part, and per part
    (n_nodes, n_real_chunks)."""
    n_parts = len(static.mesh_parts)
    ptrs = (ctypes.c_longlong * max(1, 4 * n_parts))(
        *(a.data_ptr() for a in mesh_arrays))
    info = (ctypes.c_int * max(1, 2 * n_parts))(*(
        v for k in range(n_parts)
        for v in (mesh_arrays[4 * k + 3].shape[0],
                  mesh_arrays[4 * k].shape[0] // meshpack.ROWS_PER_CHUNK)))
    return ptrs, info


def forward_winners(static: SceneStatic, max_depth: int, rr_start: int,
                    prims: torch.Tensor, rays: torch.Tensor,
                    seeds: torch.Tensor, spect: torch.Tensor, *mesh_arrays):
    """Winner-taped forward megakernel (build_forward(taped=True)) ->
    (radiance (4, R), tape_idx (max_depth+1, R) i32, tape_sh
    (max_depth+1, n_lights, R) i32), the contract of
    ``forward_winners_reference``.

    CPU tensors run ``forward_winners_reference``; CUDA tensors launch
    ``megakernel_fwd_winners`` of csrc/megakernel_fwd.cu, in its mesh
    mode when the scene has mesh parts or triangle rows. Its radiance is
    the untaped forward's bit for bit. The tapes feed the guided replay
    (tracer/replay.py)."""
    global launches_winners
    _check(static, prims, rays, seeds, spect, mesh_arrays)
    dev = rays.device
    if dev.type == "cpu":
        return forward_winners_reference(static, max_depth, rr_start, prims,
                                         rays, seeds, spect, *mesh_arrays)
    _require_cuda(dev)
    fn = _fn("megakernel_fwd", "megakernel_fwd_winners")
    meta, lights = _tables(static, dev)
    R = rays.shape[1]
    D = int(max_depth) + 1
    out = torch.empty((4, R), dtype=torch.float32, device=dev)
    tape_idx = torch.empty((D, R), dtype=torch.int32, device=dev)
    tape_sh = torch.empty((D, lights.shape[0], R), dtype=torch.int32,
                          device=dev)
    ptrs, info = _part_tables(static, mesh_arrays)
    seeds32 = _u32_bits(seeds)
    _launch("megakernel_fwd_winners", fn, dev, prims.data_ptr(),
            meta.data_ptr(), len(static.rows), lights.data_ptr(),
            lights.shape[0], rays.data_ptr(), seeds32.data_ptr(),
            spect.data_ptr(), static.n_spectra, out.data_ptr(),
            tape_idx.data_ptr(), tape_sh.data_ptr(), R, int(max_depth),
            int(rr_start), int(static.mesh_mode), len(static.mesh_parts),
            ctypes.addressof(ptrs), ctypes.addressof(info))
    launches_winners += 1
    return out, tape_idx, tape_sh


def forward_taped(static: SceneStatic, max_depth: int, rr_start: int,
                  prims: torch.Tensor, rays: torch.Tensor,
                  seeds: torch.Tensor, spect: torch.Tensor,
                  trips: torch.Tensor | None = None):
    """Taped forward megakernel (build_forward(taped="full")) ->
    (radiance (4, R), tape_f ((max_depth+1) * 16, R) f32, tape_i
    ((max_depth+1) * 8, R) i32).

    CPU tensors run ``forward_taped_reference``; CUDA tensors launch
    ``megakernel_fwd_taped`` of csrc/megakernel_fwd.cu: in its mesh mode
    on the refill schedule when the scene has triangle rows, otherwise on
    the group schedule (``forward_refill_reference(group=GROUP)`` models
    it). ``trips``, a (len(TRIP_COUNTS),) int64 CUDA tensor, makes the
    group schedule of a scene without triangle rows add its lane and warp
    trips to it (its counting build). Scenes without mesh parts: the tape
    feeds the tape-fed backward."""
    global launches_taped
    _require_no_parts(static)
    _check(static, prims, rays, seeds, spect, ())
    dev = rays.device
    if trips is not None:
        if static.mesh_mode:
            raise ValueError("taped trip counts are taken on scenes without "
                             "triangle rows (the group schedule)")
        _check_tensor("trips", trips, (len(TRIP_COUNTS),), torch.int64, dev)
    if dev.type == "cpu":
        if trips is not None:
            raise ValueError("trip counts are taken on the card: the plain "
                             "version counts nothing")
        return forward_taped_reference(static, max_depth, rr_start, prims,
                                       rays, seeds, spect)
    _require_cuda(dev)
    fn = _fn("megakernel_fwd", "megakernel_fwd_taped")
    meta, lights = _tables(static, dev)
    R = rays.shape[1]
    D = int(max_depth) + 1
    out = torch.empty((4, R), dtype=torch.float32, device=dev)
    tape_f = torch.empty((D * TAPE_F, R), dtype=torch.float32, device=dev)
    tape_i = torch.empty((D * TAPE_I, R), dtype=torch.int32, device=dev)
    seeds32 = _u32_bits(seeds)
    _launch("megakernel_fwd_taped", fn, dev, prims.data_ptr(),
            meta.data_ptr(), len(static.rows), lights.data_ptr(),
            lights.shape[0], rays.data_ptr(), seeds32.data_ptr(),
            spect.data_ptr(), static.n_spectra, out.data_ptr(),
            tape_f.data_ptr(), tape_i.data_ptr(), R, int(max_depth),
            int(rr_start), int(static.mesh_mode),
            _ray_counter(dev).data_ptr(),
            None if trips is None else trips.data_ptr())
    launches_taped += 1
    return out, tape_f, tape_i


# ---------------------------------------------------------------------------
# the wavefront's shade step: one bounce, the mesh casts done outside it
# ---------------------------------------------------------------------------

CARRY_F = 16  # carry_f planes: o3 d3 L4 beta4 last_pdf eta_scale


def shade_step_reference(static: SceneStatic, depth: int, max_depth: int,
                         rr_start: int, prims: torch.Tensor,
                         carry_f: torch.Tensor, carry_u: torch.Tensor,
                         carry_i: torch.Tensor, spect: torch.Tensor,
                         mesh_f: torch.Tensor, mesh_i: torch.Tensor,
                         un_f: torch.Tensor | None = None,
                         un_i: torch.Tensor | None = None):
    """Plain torch shade step (build_shade_step, megakernel.py:1087): one
    bounce of ``_bounce(defer_nee=True)`` on a carry held in planes.

    carry_f (16, R) f32, carry_u (4, R) i32 (the seed words' bits),
    carry_i (4, R) i32 [exclude, specular, in_trans, active]; mesh_f
    (4, R) [t, n.xyz] and mesh_i (1, R) the ray's closest mesh hit; un_f
    (4, R) / un_i (1, R), when given, the unrolled rows' winner the
    previous step wrote (scan_in_kernel=False), else the step scans the
    unrolled rows. The mesh winner folds into the unrolled one under the
    tie rule of megakernel.py:1177-1185. Returns (carry_f', carry_u',
    carry_i', tape_idx (R,), sh_f (3 + 8L, R), sh_i (2L, R), un_f'
    (4, R), un_i' (1, R)), L = n_lights, integers int32:
    - tape_idx: the merged main winner where the ray entered alive;
    - sh_f: the shadow origin (the hit position where the ray entered
      alive), then per light [ldir xyz, t_unrolled, contrib x4]; sh_i per
      light [idx_unrolled, lsel]. A light the bounce did not pick holds
      (0, 0, 0, +inf, 0 x4) and (-1, 0);
    - un_f' / un_i': the unrolled winner [t, n.xyz] / [idx] of the output
      ray where the ray is still alive, else (+inf, 0, 0, 0) / -1.
    A ray dead at entry keeps its carry."""
    R = carry_f.shape[1]
    zero = torch.zeros((R,), dtype=torch.float32, device=carry_f.device)
    state = _state_from_tape(carry_f, torch.cat([carry_u, carry_i]))
    alive_in = state["nondiff"][4]
    mesh_t, mesh_n = mesh_f[0], tuple(mesh_f[1:4])
    mesh_id = mesh_i[0].to(torch.int64)

    def scan_fn(tag, so, sd, sexcl):
        if tag == "main" and un_f is not None:
            idx_u = un_i[0].to(torch.int64)
            st = {"t": un_f[0], "idx": idx_u,
                  "pos": _vwhere(idx_u >= 0, _vadd(so, _vscale(un_f[0], sd)),
                                 (zero, zero, zero)),
                  "nrm": tuple(un_f[1:4])}
        else:
            st = _scan_primitives(static, prims, so, sd, sexcl)
        if tag != "main":
            return st  # NEE: the unrolled rows only
        take = (mesh_t < st["t"]) | ((mesh_t == st["t"])
                                     & (mesh_id > st["idx"]))
        idx = torch.where(take, mesh_id, st["idx"])
        return {"t": torch.where(take, mesh_t, st["t"]), "idx": idx,
                "pos": _vwhere(take, _vadd(so, _vscale(mesh_t, sd)),
                               st["pos"]),
                "nrm": _vwhere(take, mesh_n, st["nrm"]), "hit": idx >= 0}

    parts = tuple((part, ()) for part in static.mesh_parts)
    out = _bounce(static, prims, spect, state, depth, max_depth, rr_start,
                  parts, scan_fn, defer_nee=True)
    hit_idx, sh_idx, pos, nee = out["aux"]
    f, i = _tape_row(out)
    sh_f = [torch.where(alive_in, c, 0.0) for c in pos]
    sh_i = []
    for (ldir, t_su, contrib, lsel), idx_su in zip(nee, sh_idx):
        sh_f += [torch.where(lsel, c, 0.0) for c in ldir]
        sh_f.append(torch.where(lsel, t_su, math.inf))
        sh_f += [torch.where(lsel, c, 0.0) for c in contrib]
        sh_i += [idx_su, lsel]
    alive = out["nondiff"][4]
    nxt = _scan_primitives(static, prims, out["diff"][0], out["diff"][1],
                           out["nondiff"][1])
    un_f_out = torch.stack([torch.where(alive, nxt["t"], math.inf)]
                           + [torch.where(alive, c, 0.0) for c in nxt["nrm"]])
    un_i_out = torch.where(alive, nxt["idx"], -1)[None]
    return (f, i[0:4].contiguous(), i[4:8].contiguous(),
            hit_idx.to(torch.int32), torch.stack(sh_f),
            torch.stack(sh_i).to(torch.int32), un_f_out,
            un_i_out.to(torch.int32))


def shade_step(static: SceneStatic, depth: int, max_depth: int,
               rr_start: int, prims: torch.Tensor, carry_f: torch.Tensor,
               carry_u: torch.Tensor, carry_i: torch.Tensor,
               spect: torch.Tensor, mesh_f: torch.Tensor,
               mesh_i: torch.Tensor, un_f: torch.Tensor | None = None,
               un_i: torch.Tensor | None = None):
    """Shade step -> the outputs of ``shade_step_reference``.

    CPU tensors run ``shade_step_reference``; CUDA tensors launch
    csrc/shade_step.cu, the build that scans the unrolled rows itself when
    un_f and un_i are None (the first bounce), else the one that reads
    them. A failed build or launch raises."""
    global launches_shade
    _check_static(static)
    P, S = len(static.rows), static.n_spectra
    n_lights = len(static.light_rows)
    R = carry_f.shape[-1] if carry_f.dim() == 2 else -1
    dev = carry_f.device
    if (un_f is None) != (un_i is None):
        raise ValueError("un_f and un_i go together")
    if not 0 <= int(depth) <= int(max_depth):
        raise ValueError(f"depth {depth} outside 0..{max_depth}")
    i32, f32 = torch.int32, torch.float32
    for name, t, shape, dtype in (
            ("prims", prims, (P, 12), f32),
            ("carry_f", carry_f, (CARRY_F, R), f32),
            ("carry_u", carry_u, (4, R), i32),
            ("carry_i", carry_i, (4, R), i32),
            ("spect", spect, (S * 4, R), f32),
            ("mesh_f", mesh_f, (4, R), f32),
            ("mesh_i", mesh_i, (1, R), i32),
            *((("un_f", un_f, (4, R), f32), ("un_i", un_i, (1, R), i32))
              if un_f is not None else ())):
        _check_tensor(name, t, shape, dtype, dev)
    if dev.type == "cpu":
        return shade_step_reference(static, depth, max_depth, rr_start,
                                    prims, carry_f, carry_u, carry_i, spect,
                                    mesh_f, mesh_i, un_f, un_i)
    _require_cuda(dev)
    fn = _fn("shade_step", "shade_step")
    meta, lights = _tables(static, dev)
    outs = (torch.empty((CARRY_F, R), dtype=f32, device=dev),
            torch.empty((4, R), dtype=i32, device=dev),
            torch.empty((4, R), dtype=i32, device=dev),
            torch.empty((R,), dtype=i32, device=dev),
            torch.empty((3 + 8 * n_lights, R), dtype=f32, device=dev),
            torch.empty((2 * n_lights, R), dtype=i32, device=dev),
            torch.empty((4, R), dtype=f32, device=dev),
            torch.empty((1, R), dtype=i32, device=dev))
    _launch("shade_step", fn, dev, prims.data_ptr(), meta.data_ptr(), P,
            lights.data_ptr(), n_lights, spect.data_ptr(), S,
            carry_f.data_ptr(), carry_u.data_ptr(), carry_i.data_ptr(),
            mesh_f.data_ptr(), mesh_i.data_ptr(),
            None if un_f is None else un_f.data_ptr(),
            None if un_i is None else un_i.data_ptr(),
            *(t.data_ptr() for t in outs), R, int(depth), int(max_depth),
            int(rr_start), len(static.mesh_parts))
    launches_shade += 1
    return outs


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def backward_reference(static: SceneStatic, max_depth: int, rr_start: int,
                       prims: torch.Tensor, rays: torch.Tensor,
                       seeds: torch.Tensor, spect: torch.Tensor,
                       dL: torch.Tensor, ray_chunk: int | None = None):
    """Plain torch backward: autograd of ``forward_reference`` with
    respect to (prims, rays, spect) for the radiance cotangent dL (4, R).

    ray_chunk splits the rays into bands of at most that many rays and
    sums d_prims over the bands in order, so that the autograd graph
    (some 10^4 saved (R,) tensors per band at depth 8) stays bounded.
    Returns (d_prims (P, 12), d_rays (6, R), d_spect (S*4, R))."""
    _require_no_parts(static)
    R = rays.shape[1]
    step = R if not ray_chunk else int(ray_chunk)
    d_prims = torch.zeros_like(prims)
    d_rays, d_spect = [], []
    for a in range(0, R, step):
        b = min(R, a + step)
        p = prims.detach().requires_grad_(True)
        r = rays[:, a:b].detach().requires_grad_(True)
        sp = spect[:, a:b].detach().requires_grad_(True)
        with torch.enable_grad():
            out = forward_reference(static, max_depth, rr_start, p, r,
                                    seeds[:, a:b], sp)
            grads = torch.autograd.grad(out, (p, r, sp),
                                        grad_outputs=dL[:, a:b],
                                        allow_unused=True)
        gp, gr, gs = (torch.zeros_like(x) if g is None else g
                      for g, x in zip(grads, (p, r, sp)))
        d_prims = d_prims + gp
        d_rays.append(gr)
        d_spect.append(gs)
    return d_prims, torch.cat(d_rays, dim=1), torch.cat(d_spect, dim=1)


def backward_from_tape_reference(static: SceneStatic, max_depth: int,
                                 rr_start: int, prims: torch.Tensor,
                                 spect: torch.Tensor, tape_f: torch.Tensor,
                                 tape_i: torch.Tensor, dL: torch.Tensor):
    """Plain torch tape-fed backward (build_backward_from_tape): for each
    depth from max_depth down to 0, rebuild the carry from its tape row,
    run ``_bounce`` under autograd with respect to (prims, spect, the 16
    carry planes) and pull the carry cotangent through it. A row in which
    no ray is active is the identity and is skipped. d_rays is the
    cotangent of the depth-0 row's o and d. Returns (d_prims (P, 12),
    d_rays (6, R), d_spect (S*4, R))."""
    _require_no_parts(static)
    R = tape_f.shape[1]
    tf = tape_f.reshape(-1, TAPE_F, R)
    ti = tape_i.reshape(-1, TAPE_I, R)
    d_diff = [torch.zeros((R,), dtype=torch.float32, device=tape_f.device)
              for _ in range(TAPE_F)]
    d_diff[6:10] = list(dL.unbind(0))
    d_prims = torch.zeros_like(prims)
    d_spect = torch.zeros_like(spect)
    for depth in range(tf.shape[0] - 1, -1, -1):
        if not bool((ti[depth, 7] != 0).any()):
            continue
        p = prims.detach().requires_grad_(True)
        sp = spect.detach().requires_grad_(True)
        planes = tf[depth].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            state = _state_from_tape(planes, ti[depth])
            out = _bounce(static, p, sp, state, depth, max_depth, rr_start)
            o, d, L, beta, last_pdf, eta_scale = out["diff"]
            outs = torch.stack([*o, *d, *L, *beta, last_pdf, eta_scale])
            gp, gs, gd = torch.autograd.grad(
                outs, (p, sp, planes), grad_outputs=torch.stack(d_diff),
                allow_unused=True)
        if gp is not None:
            d_prims = d_prims + gp
        if gs is not None:
            d_spect = d_spect + gs
        d_diff = list(gd.unbind(0))
    return d_prims, torch.stack(d_diff[0:6]), d_spect


def _backward_outputs(prims, spect, R):
    dev = prims.device
    f32 = dict(dtype=torch.float32, device=dev)
    P = prims.shape[0]
    return (torch.empty((P, 12), **f32), torch.empty((6, R), **f32),
            torch.empty(tuple(spect.shape), **f32),
            torch.empty(((R + 127) // 128, P * 12), **f32))


def _check_times(times, dev):
    """times: None, or the (len(SWEEP_SECTIONS),) int64 CUDA counters of
    a timed build."""
    if times is None:
        return
    _check_tensor("times", times, (len(SWEEP_SECTIONS),), torch.int64, dev)
    if dev.type == "cpu":
        raise ValueError("section times are taken on the card: the plain "
                         "version times nothing")


def backward(static: SceneStatic, max_depth: int, rr_start: int,
             prims: torch.Tensor, rays: torch.Tensor, seeds: torch.Tensor,
             spect: torch.Tensor, dL: torch.Tensor, tape=None,
             times: torch.Tensor | None = None):
    """Backward megakernel -> (d_prims (P, 12), d_rays (6, R),
    d_spect (S*4, R)) for the radiance cotangent dL (4, R).

    CPU tensors run ``backward_reference``. CUDA tensors launch
    csrc/megakernel_bwd.cu: the taped forward's kernel replays the paths
    into the tape, then the tape-fed kernel's sweep runs on it, so the
    result is ``forward_taped`` followed by ``backward_from_tape`` bit for
    bit; a failed build or launch raises. One call counts one backward
    launch. d_prims is summed in a fixed order, so two calls on the same
    inputs give bit-equal results. tape: optional (tape_f, tape_i) of
    ``forward_taped``'s shapes that receives the replay's tape (scratch
    otherwise; CUDA only). times: a (len(SWEEP_SECTIONS),) int64 CUDA
    tensor selects the sweep's timed build, which adds each section's
    clock64() cycles, summed over warps, to it."""
    global launches_bwd
    _require_no_parts(static)
    _check(static, prims, rays, seeds, spect, ())
    R = rays.shape[1]
    dev = rays.device
    _check_tensor("dL", dL, (4, R), torch.float32, dev)
    _check_times(times, dev)
    if dev.type == "cpu":
        return backward_reference(static, max_depth, rr_start, prims, rays,
                                  seeds, spect, dL)
    _require_cuda(dev)
    name = "megakernel_bwd" if times is None else "megakernel_bwd_timed"
    fn = _fn("megakernel_bwd", name)
    meta, lights = _tables(static, dev)
    D = int(max_depth) + 1
    d_prims, d_rays, d_spect, partial = _backward_outputs(prims, spect, R)
    if R == 0:
        return d_prims.zero_(), d_rays, d_spect
    if tape is None:
        tape = (torch.empty((D * TAPE_F, R), dtype=torch.float32, device=dev),
                torch.empty((D * TAPE_I, R), dtype=torch.int32, device=dev))
    tape_f, tape_i = tape
    _check_tensor("tape_f", tape_f, (D * TAPE_F, R), torch.float32, dev)
    _check_tensor("tape_i", tape_i, (D * TAPE_I, R), torch.int32, dev)
    seeds32 = _u32_bits(seeds)
    _launch(name, fn, dev, prims.data_ptr(), meta.data_ptr(),
            len(static.rows), lights.data_ptr(), lights.shape[0],
            rays.data_ptr(), seeds32.data_ptr(), spect.data_ptr(),
            static.n_spectra, dL.data_ptr(), d_prims.data_ptr(),
            partial.data_ptr(), d_rays.data_ptr(), d_spect.data_ptr(),
            tape_f.data_ptr(), tape_i.data_ptr(), R, int(max_depth),
            int(rr_start), int(static.mesh_mode),
            _ray_counter(dev).data_ptr(),
            *(() if times is None else (times.data_ptr(),)))
    launches_bwd += 1
    return d_prims, d_rays, d_spect


def backward_from_tape(static: SceneStatic, max_depth: int, rr_start: int,
                       prims: torch.Tensor, spect: torch.Tensor,
                       tape_f: torch.Tensor, tape_i: torch.Tensor,
                       dL: torch.Tensor, times: torch.Tensor | None = None):
    """Tape-fed backward megakernel -> (d_prims (P, 12), d_rays (6, R),
    d_spect (S*4, R)) from the tape of ``forward_taped`` and the radiance
    cotangent dL (4, R).

    CPU tensors run ``backward_from_tape_reference``; CUDA tensors launch
    csrc/megakernel_bwd_tape.cu, whose reverse sweep is the retrace
    kernel's: on the same tape both give bit-equal results. times: as
    ``backward``'s, the timed build."""
    global launches_bwd_tape
    _require_no_parts(static)
    P = len(static.rows)
    R = spect.shape[-1] if spect.dim() == 2 else -1
    dev = spect.device
    D = int(max_depth) + 1
    for name, t, shape, dtype in (
            ("prims", prims, (P, 12), torch.float32),
            ("spect", spect, (static.n_spectra * 4, R), torch.float32),
            ("tape_f", tape_f, (D * TAPE_F, R), torch.float32),
            ("tape_i", tape_i, (D * TAPE_I, R), torch.int32)):
        _check_tensor(name, t, shape, dtype, dev)
    _check_tensor("dL", dL, (4, R), torch.float32, dev)
    _check_times(times, dev)
    if dev.type == "cpu":
        return backward_from_tape_reference(static, max_depth, rr_start,
                                            prims, spect, tape_f, tape_i, dL)
    _require_cuda(dev)
    name = ("megakernel_bwd_tape" if times is None
            else "megakernel_bwd_tape_timed")
    fn = _fn("megakernel_bwd_tape", name)
    meta, lights = _tables(static, dev)
    d_prims, d_rays, d_spect, partial = _backward_outputs(prims, spect, R)
    if R == 0:
        return d_prims.zero_(), d_rays, d_spect
    _launch(name, fn, dev, prims.data_ptr(),
            meta.data_ptr(), len(static.rows), lights.data_ptr(),
            lights.shape[0], spect.data_ptr(), static.n_spectra,
            tape_f.data_ptr(), tape_i.data_ptr(), dL.data_ptr(),
            d_prims.data_ptr(), partial.data_ptr(), d_rays.data_ptr(),
            d_spect.data_ptr(), R, int(max_depth), int(rr_start),
            int(static.mesh_mode),
            *(() if times is None else (times.data_ptr(),)))
    launches_bwd_tape += 1
    return d_prims, d_rays, d_spect


class TraceFn(torch.autograd.Function):
    """Differentiable trace: forward is ``forward``, backward is
    ``backward`` (the retrace kernel for CUDA tensors). Seeds get no
    gradient. Scenes without mesh parts.

        radiance = TraceFn.apply(static, max_depth, rr_start, prims, rays,
                                 seeds, spect)
    """

    @staticmethod
    def forward(ctx, static, max_depth, rr_start, prims, rays, seeds, spect):
        _require_no_parts(static)
        ctx.static = static
        ctx.max_depth = int(max_depth)
        ctx.rr_start = int(rr_start)
        ctx.save_for_backward(prims, rays, seeds, spect)
        return forward(static, max_depth, rr_start, prims, rays, seeds,
                       spect)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        prims, rays, seeds, spect = ctx.saved_tensors
        with profiling.annotate("trace.backward"):
            d_prims, d_rays, d_spect = backward(
                ctx.static, ctx.max_depth, ctx.rr_start, prims, rays, seeds,
                spect, g.contiguous())
        return None, None, None, d_prims, d_rays, None, d_spect


class TraceTapedFn(torch.autograd.Function):
    """Differentiable trace through the tape (the analogue of the JAX
    package's ``_call_taped``): when an input needs a gradient, forward is
    ``forward_taped``, which traces each path once and keeps the tape, and
    backward is ``backward_from_tape``, which replays nothing. When none
    does, forward is the untaped ``forward`` and nothing is kept.
    Scenes without mesh parts.

        radiance = TraceTapedFn.apply(static, max_depth, rr_start, prims,
                                      rays, seeds, spect)
    """

    @classmethod
    def apply(cls, static, max_depth, rr_start, prims, rays, seeds, spect):
        # ctx.needs_input_grad says what the inputs require, not whether
        # grad mode is on where the trace is called (inside forward it is
        # always off): under no_grad, run the untaped forward directly
        if not torch.is_grad_enabled():
            _require_no_parts(static)
            return forward(static, max_depth, rr_start, prims, rays, seeds,
                           spect)
        return super().apply(static, max_depth, rr_start, prims, rays, seeds,
                             spect)

    @staticmethod
    def forward(ctx, static, max_depth, rr_start, prims, rays, seeds, spect):
        _require_no_parts(static)
        ctx.static = static
        ctx.max_depth = int(max_depth)
        ctx.rr_start = int(rr_start)
        if not any(ctx.needs_input_grad[k] for k in (3, 4, 6)):
            return forward(static, max_depth, rr_start, prims, rays, seeds,
                           spect)
        out, tape_f, tape_i = forward_taped(static, max_depth, rr_start,
                                            prims, rays, seeds, spect)
        ctx.save_for_backward(prims, spect, tape_f, tape_i)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        prims, spect, tape_f, tape_i = ctx.saved_tensors
        with profiling.annotate("trace.backward"):
            d_prims, d_rays, d_spect = backward_from_tape(
                ctx.static, ctx.max_depth, ctx.rr_start, prims, spect,
                tape_f, tape_i, g.contiguous())
        return None, None, None, d_prims, d_rays, None, d_spect


def _replay_forward(ctx, trace, static, max_depth, rr_start, prims_full,
                    rays, seeds, spect, cats, mesh_arrays):
    """The forward of the guided-replay Functions (``MeshTraceFn``, the
    wavefront's ``tracer.kernel.MeshWavefrontFn``): ``trace(*args,
    taped=...)`` on the static's unrolled rows, winner-taped when an input
    needs a gradient, and the tensors ``_replay_backward`` reads saved."""
    if tuple(cats.shape) != (prims_full.shape[0],):
        raise ValueError(f"cats: expected ({prims_full.shape[0]},), got "
                         f"{tuple(cats.shape)}")
    prims = _unrolled(static, prims_full)
    args = (static, int(max_depth), int(rr_start), prims, rays, seeds, spect,
            *mesh_arrays)
    ctx.static = static
    ctx.max_depth = int(max_depth)
    ctx.rr_start = int(rr_start)
    ctx.n_arrays = len(mesh_arrays)
    if not any(ctx.needs_input_grad[k] for k in (3, 4, 6)):
        return trace(*args, taped=False)
    out, tape_idx, tape_sh = trace(*args, taped=True)
    ctx.save_for_backward(prims_full, rays, seeds, spect, cats, tape_idx,
                          tape_sh)
    return out


def _replay_backward(ctx, g):
    """The cotangents of (prims_full, rays, spect): torch autograd of
    ``tracer.replay.trace_replay`` on the saved winner tape, in the span
    ``trace.backward``."""
    from computeraytracer_tpu_torch.tracer import replay

    prims_full, rays, seeds, spect, cats, tape_idx, tape_sh = \
        ctx.saved_tensors
    leaves = [x.detach().requires_grad_(True)
              for x in (prims_full, rays, spect)]
    with profiling.annotate("trace.backward"), torch.enable_grad():
        out = replay.trace_replay(ctx.static, cats, leaves[0], leaves[1],
                                  seeds, leaves[2], tape_idx, tape_sh,
                                  ctx.max_depth, ctx.rr_start)
        grads = torch.autograd.grad(out, leaves,
                                    grad_outputs=g.contiguous(),
                                    allow_unused=True)
    dp, dr, ds = (torch.zeros_like(x) if gr is None else gr
                  for gr, x in zip(grads, leaves))
    return (None, None, None, dp, dr, None, ds, None) + (None,) * ctx.n_arrays


def _kernel_trace(*args, taped):
    """The in-kernel forward: winner-taped or not."""
    return forward_winners(*args) if taped else forward(*args)


class MeshTraceFn(torch.autograd.Function):
    """Differentiable trace through the guided replay (the analogue of the
    JAX package's ``_mesh_call``, tracer/pallas.py:168-207): the
    backward of scenes with mesh parts, and of any scene traced with
    ``backward="replay"``.

    prims_full is the FULL (P, 12) table (``pack_prims(scene)``), so that
    the replay gathers winners by row id; the kernel reads its unrolled
    rows and the mesh arrays. Under grad, forward is ``forward_winners``,
    which keeps each bounce's winners; backward is torch autograd of
    ``tracer.replay.trace_replay`` with respect to prims_full, rays and
    spect. Seeds, the categories and the mesh arrays get no gradient.
    With no input needing a gradient, or under no_grad, the untaped
    ``forward`` runs and nothing is kept.

        radiance = MeshTraceFn.apply(static, max_depth, rr_start,
                                     prims_full, rays, seeds, spect, cats,
                                     *mesh_arrays)
    """

    @classmethod
    def apply(cls, static, max_depth, rr_start, prims_full, rays, seeds,
              spect, cats, *mesh_arrays):
        # as TraceTapedFn.apply: grad mode is off inside forward
        if not torch.is_grad_enabled():
            return forward(static, max_depth, rr_start,
                           _unrolled(static, prims_full), rays, seeds, spect,
                           *mesh_arrays)
        return super().apply(static, max_depth, rr_start, prims_full, rays,
                             seeds, spect, cats, *mesh_arrays)

    @staticmethod
    def forward(ctx, static, max_depth, rr_start, prims_full, rays, seeds,
                spect, cats, *mesh_arrays):
        return _replay_forward(ctx, _kernel_trace, static, max_depth,
                               rr_start, prims_full, rays, seeds, spect,
                               cats, mesh_arrays)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _replay_backward(ctx, g)
