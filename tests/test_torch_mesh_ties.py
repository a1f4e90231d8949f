"""The mesh tie rule (t < best, or t == best and the higher id) under the
properties that the kernels' traversal relies on: the winner of a mesh
part is the least (t, -id) over its triangles, whatever the chunk that
holds a triangle and whatever the order of the tests. The CUDA traversal
(csrc/bounce.cuh scan_mesh_part) spreads each chunk's triangles over the
lanes of a warp and reduces their bests; tests/test_torch_cuda.py holds
it against the plain walk on the card.

On ``tie_mesh_scene``, a flat grid of exact ties in three layouts (each
triangle once: ties on shared edges and vertices; every triangle twice
under two ids, the pairs inside one chunk; the same with the pairs
across the chunk boundaries), and ``tie_mesh_rays`` (rays that meet the
grid at t = 400 exactly through cell interiors, edges and vertices,
oblique and random rays), 384 rays seeded empty (+inf, -1), with a bound
(idx -1: exactly the grid's t, or short of it) or inactive (t = -inf),
a fifth of them excluding the triangle that wins unexcluded:
- ``binned.walk_reference`` against the JAX ``binned.build_walk_kernel``
  in interpret mode (tests/test_torch_wavefront.py's pattern): idx equal
  on every lane, the higher id winning every exact tie (counted by brute
  force over every triangle), t and normals within rel 1e-5 (XLA fuses
  FMAs on the CPU), inactive lanes returning their seed;
- the plain walk's winners (t, normals and idx, bit for bit) do not
  depend on the order of the packed triangles: a random permutation of
  the pack moves the triangles, ids and all, between chunks, and the
  plain scan's blocks are cut across the chunks;
- the slab test enters a box for a ray that runs in one of its faces (a
  ray along z through a shared edge on a chunk boundary): the walk's
  boxes stay conservative, so its winner is the plain scan's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import binned as jbinned
from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.kernels import meshpack as jmeshpack
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

R = 384
TILE_M = R // jmk.LANES  # one grid step
MESH_MIN = 256
GRID_T = float(presets.TIE_GRID[3])  # t of the rays along z


def _scene(layout):
    doc = presets.tie_mesh_scene(64, 64, layout)
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
    assert len(static.mesh_parts) == 1
    return doc, scene, static


def _arrays(scene, static):
    return tuple(a for p in kt.mesh_packs_for(scene, static)
                 for a in p.arrays)


def _seeds(static, rays, arrays):
    """Lane i: kind i % 3 (empty, bounded, inactive); a bound of exactly
    the grid's t on even lanes, just short of it on odd ones (or 1e3 and
    50 off the z axis); every fifth lane excludes the winner of an
    unexcluded, unseeded walk."""
    empty_f = torch.zeros((4, R))
    empty_f[0] = torch.inf
    empty_i = torch.full((2, R), -1, dtype=torch.int32)
    first = bn.walk_reference(static, rays, empty_f, empty_i, *arrays)[1][0]
    lane = torch.arange(R)
    kind = lane % 3
    on_z = rays[3] == 0
    bound = torch.where(lane % 2 == 0, torch.where(on_z, GRID_T, 1e3),
                        torch.where(on_z, GRID_T - 0.01, 50.0))
    seed_f = torch.zeros((4, R))
    seed_f[0] = torch.where(kind == 0, torch.inf,
                            torch.where(kind == 1, bound, -torch.inf))
    exclude = torch.where(lane % 5 == 1, first, -1)
    seed_i = torch.stack([torch.full((R,), -1, dtype=torch.int32),
                          exclude.to(torch.int32)])
    return seed_f, seed_i, kind


def _hits(rays, tri_rows):
    """Every triangle's plane t of every ray and whether it is a valid
    hit (not padding, inside the watertight test, t >= T_MIN): (t, valid,
    ids), (R, N) and (N,)."""
    tri = tri_rows.reshape(-1, meshpack.LANES_PER_TRI)
    col = lambda x: x[:, None]
    o = tuple(col(rays[c]) for c in range(3))
    d = tuple(col(rays[3 + c]) for c in range(3))
    w = lambda k: tri[:, k][None, :]
    v0, v1, v2 = (w(0), w(1), w(2)), (w(3), w(4), w(5)), (w(6), w(7), w(8))
    t, _, grazing = isect.plane_t((w(10), w(11), w(12)), v0, o, d)
    ids = tri[:, 9].to(torch.int64)
    wt = isect.watertight_setup(o, d)
    valid = ((ids[None, :] >= 0) & ~grazing & (t >= mk.T_MIN)
             & isect.watertight_inside(wt, v0, v1, v2))
    return t, valid, ids


@pytest.mark.parametrize("layout", presets.TIE_LAYOUTS)
def test_tie_walk_matches_jax(layout):
    doc, scene, static = _scene(layout)
    arrays = _arrays(scene, static)
    rays = torch.from_numpy(presets.tie_mesh_rays(R, seed=1))
    seed_f, seed_i, kind = _seeds(static, rays, arrays)
    out_f, out_i = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)

    js, _ = jax_scene_from_dict(doc)
    jstatic = jmk.SceneStatic.from_scene(js, mesh_min=MESH_MIN)
    jarrays = [jnp.asarray(a) for part in jstatic.mesh_parts
               for a in jmeshpack.pack_scene_mesh(js, part).arrays]
    planes = lambda x: jnp.asarray(x.numpy().reshape(x.shape[0], -1,
                                                     jmk.LANES))
    walk = jbinned.build_walk_kernel(jstatic, TILE_M, True)
    jf, ji = jax.block_until_ready(walk(planes(rays), planes(seed_f),
                                        planes(seed_i), *jarrays))
    jf = np.asarray(jf).reshape(4, R)
    ji = np.asarray(ji).reshape(R)
    got_f, got_i = out_f.numpy(), out_i[0].numpy()
    np.testing.assert_array_equal(got_i, ji)
    inactive = (kind == 2).numpy()
    for f in (got_f, jf):
        np.testing.assert_array_equal(f[:, inactive],
                                      seed_f.numpy()[:, inactive])
    hit = got_i >= 0
    np.testing.assert_allclose(got_f[0, hit], jf[0, hit], rtol=1e-5)
    np.testing.assert_allclose(got_f[1:, hit], jf[1:, hit], rtol=1e-5,
                               atol=1e-6)

    # every exact tie at the winning t goes to the highest id, on every
    # lane that holds one
    t, valid, ids = _hits(rays, arrays[0])
    excluded = ids[None, :] == seed_i[1].to(torch.int64)[:, None]
    won = out_i[0] >= 0
    tied = valid & ~excluded & (t == out_f[0][:, None]) & won[:, None]
    n_tied = tied.sum(dim=1)
    top = torch.where(tied, ids[None, :], -1).amax(dim=1)
    many = n_tied >= 2
    assert torch.equal(out_i[0][many].to(torch.int64), top[many])
    assert int(many.sum()) >= 40
    # the ties the layout promises: duplicates, shared edges, and in the
    # split layout pairs whose two triangles lie in two chunks
    chunk_of = torch.arange(ids.shape[0]) // meshpack.TRIS_PER_CHUNK
    chunks = torch.where(tied, chunk_of[None, :], -1)
    across = many & (chunks.amax(dim=1)
                     != torch.where(tied, chunk_of[None, :],
                                    1 << 30).amin(dim=1))
    if layout == "split":
        assert across.any()
    if layout == "packed":
        assert (many & ~across).any()
    if layout == "edges":
        assert (n_tied >= 3).any()  # a vertex where several triangles meet
    # the excluded winner loses its tie to the next id
    redo = many & (seed_i[1] >= 0) & (kind == 0)
    assert redo.any() and (out_i[0][redo] != seed_i[1][redo]).all()


@pytest.mark.parametrize("scene_kind,seed,block", [
    ("split", 0, 37), ("split", 1, 128), ("edges", 2, 53),
    ("packed", 3, 64), ("blob", 4, 101), ("blob", 5, 29)])
def test_plain_walk_ignores_triangle_order(monkeypatch, scene_kind, seed,
                                           block):
    if scene_kind == "blob":
        doc = presets.mesh_scene(64, 64, 2)
        scene, _ = scene_from_dict(doc, device="cpu")
        static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
        g = np.random.default_rng(seed)
        o = g.uniform([130, 40, 130], [430, 320, 430], (R, 3)).T
        dd = g.standard_normal((3, R))
        rays = torch.from_numpy(np.concatenate(
            [o, dd / np.linalg.norm(dd, axis=0)]).astype(np.float32))
    else:
        _, scene, static = _scene(scene_kind)
        rays = torch.from_numpy(presets.tie_mesh_rays(R, seed=seed))
    part = static.mesh_parts[0]
    plan = meshpack.plan_scene_mesh(scene, part)
    pack = meshpack.pack_scene_mesh(scene, part, plan)
    perm = np.random.default_rng(seed).permutation(plan.n)
    shuffled = meshpack.pack_scene_mesh(scene, part,
                                        plan._replace(order=plan.order[perm]))
    ids = lambda p: p.tri_rows.reshape(-1, meshpack.LANES_PER_TRI)[:, 9]
    moved = (ids(pack) != ids(shuffled))[:plan.n].float().mean().item()
    assert moved > 0.9
    seed_f, seed_i, _ = _seeds(static, rays, pack.arrays)
    # plain scan blocks of `block` triangles, cut across the chunks
    monkeypatch.setattr(mk, "MESH_BLOCK", block * R)
    want = bn.walk_reference(static, rays, seed_f, seed_i, *pack.arrays)
    got = bn.walk_reference(static, rays, seed_f, seed_i, *shuffled.arrays)
    assert (want[1] >= 0).sum() >= R // 4
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_slab_enters_a_box_from_its_face():
    """The padded slab test (binned._slab_t_enter, the arithmetic of
    bounce.cuh slab_enter) on the box [0, 1]^3 and rays along z: one in
    each face plane parallel to z (x = 0, x = 1, y = 1, and with a -0.0
    component), one on an edge, one inside, one just outside. Each ray in
    the box or on its boundary enters it at z = 0 (t = 1, padded by
    4 ulp); the one outside misses it (+inf). A face distance of 0 times
    the parallel axis's 1e30 once gave an exit at t = 0, and the box was
    missed."""
    box = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0]])
    xy = [(1.0, 0.5), (0.0, 0.5), (0.5, 1.0), (1.0, 1.0), (0.5, 0.5),
          (1.0 + 2 ** -20, 0.5)]
    o = torch.tensor([[x for x, _ in xy] * 2, [y for _, y in xy] * 2,
                      [-1.0] * len(xy) + [2.0] * len(xy)])
    d = torch.zeros((3, 2 * len(xy)))
    d[2] = torch.tensor([1.0] * len(xy) + [-1.0] * len(xy))
    d[0, len(xy):] = -0.0  # the negative zero: inv_dir's -1e30
    t = bn._slab_t_enter(box, o, d, torch.full((2 * len(xy),), math.inf))
    entry = 1.0 - 4 * 2.0 ** -23
    want = torch.tensor([entry] * (len(xy) - 1) + [math.inf])
    assert torch.equal(t[0], torch.cat([want, want]))
