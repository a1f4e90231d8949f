"""The binned mesh casts of the PyTorch port (``kernels/binned.py``) vs the
JAX package's kernels and the port's own seeded walk.

Sizes are tests/test_binned.py's: ``displaced_blob(4)`` (5,120 triangles
in 64 chunks) under 2,048 random rays for the candidate pass and the pair
scans, ``mesh_scene(16, 16, subdivisions=2)`` (``mesh_min=64``: one mesh
part of 320 triangles in 3 chunks) under 4,096 rays aimed at the blob for
the casts. The JAX kernels run in interpret mode.

- Candidates: ``candidates`` (the plain ``candidates_reference`` on the
  CPU) against ``binned.candidate_chunks_pallas`` for k in {4, 6} with an
  active mask: inactive lanes -1 / +inf, active lanes the same candidate
  sets, t_next equal on at least 99.9% of them and within rel 1e-6 on all
  (XLA fuses the slab pad into an FMA on the CPU); each lane's candidates
  in ascending (t_enter, id) order. Padded supernodes (a chunk count that
  is not a multiple of 16) never yield a padding chunk.
- Pair scans: ``pair_reference`` and ``pair_occluded_reference`` against
  ``build_pair_kernel`` / ``build_pair_kernel_occl`` on the same
  chunk-sorted pairs: idx and flags equal, t and normals within rtol 1e-5
  (as ``test_walk_matches_jax`` holds the walk); a chunk id at or beyond
  the real chunk count tests nothing.
- Closest hit: ``mesh_closest_hit`` and ``mesh_closest_hit_batched`` equal
  (``torch.equal``) to ``walk_reference`` over every ray, with each branch
  of ``_walk_finish`` (nothing unresolved, both compaction tiers, the full
  walk) forced by k = 1 and the active set; the batched cast against the
  JAX one: idx equal, t within rtol 1e-5.
- Occlusion: ``mesh_occluded`` and ``mesh_occluded_batched`` equal to the
  flag the closest hit derives, ``(idx >= 0) & (t <= t_su)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import binned as jbinned
from computeraytracer_tpu.kernels import meshpack as jmeshpack
from computeraytracer_tpu.scene import mesh as jmesh_ops
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jpt
from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

LANES = 128
TILE = 1024


@pytest.fixture(scope="module")
def blob():
    """tests/test_binned.py's _setup: the JAX pack of displaced_blob(4) and
    2,048 random rays with bounds and an active mask (~80%)."""
    verts, faces = jmesh_ops.displaced_blob(4)
    pack = jmeshpack.pack_mesh(verts[faces[:, 0]], verts[faces[:, 1]],
                               verts[faces[:, 2]], np.arange(len(faces)))
    rng = np.random.default_rng(0)
    R = 2048
    o = rng.uniform(-2, 2, (3, R)).astype(np.float32)
    dn = rng.normal(size=(R, 3))
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    d = dn.T.astype(np.float32)
    tb = rng.uniform(0.5, 10, R).astype(np.float32)
    act = rng.uniform(size=R) < 0.8
    return {"pack": pack, "o": o, "d": d, "tb": tb, "act": act, "R": R,
            "rays": torch.from_numpy(np.concatenate([o, d])),
            "bbox": torch.from_numpy(np.array(pack.chunk_bbox)),
            "tri": torch.from_numpy(np.array(pack.tri_rows))}


def _jcomp(x):
    return tuple(jnp.asarray(x[c]) for c in range(x.shape[0]))


def _same_sets(got, want, lanes):
    """Candidate sets of (k, R) got and (R, k) want equal on lanes."""
    for i in np.nonzero(lanes)[0]:
        a = set(got[:, i][got[:, i] >= 0].tolist())
        b = set(want[i][want[i] >= 0].tolist())
        assert a == b, i


@pytest.mark.parametrize("k", [4, 6])
def test_candidates_match_jax(blob, k):
    R, act = blob["R"], blob["act"]
    tb = torch.from_numpy(blob["tb"])
    before = bn.launches_candidates
    cand, t_next = bn.candidates(blob["bbox"], blob["rays"], tb, k,
                                 torch.from_numpy(act))
    assert bn.launches_candidates == before  # the CPU launches nothing
    assert cand.shape == (k, R) and cand.dtype == torch.int32
    jc, jt = jbinned.candidate_chunks_pallas(
        blob["pack"].chunk_bbox, _jcomp(blob["o"]), _jcomp(blob["d"]),
        jnp.asarray(blob["tb"]), k=k, active=jnp.asarray(act),
        interpret=True)
    jc, jt = np.asarray(jc), np.asarray(jt)
    c, t = cand.numpy(), t_next.numpy()
    assert (c[:, ~act] == -1).all() and np.isposinf(t[~act]).all()
    _same_sets(c, jc, act)
    fin = np.isfinite(jt) & act
    assert (np.isfinite(t) == np.isfinite(jt))[act].all()
    assert (t[fin] == jt[fin]).mean() >= 0.999
    np.testing.assert_allclose(t[fin], jt[fin], rtol=1e-6)
    assert (c[:, act] >= 0).sum(axis=0).max() == k  # some lane overflows
    assert np.isfinite(t[act]).any()
    # the slots in ascending (t_enter, chunk id) order, then the -1 padding
    rays = blob["rays"]
    te = bn._slab_t_enter(blob["bbox"], rays[0:3], rays[3:6],
                          tb + tb.abs() * bn.PAD_BOUND)
    real = cand >= 0
    t_slot = torch.where(real, te.gather(0, cand.long().clamp(min=0)),
                         torch.inf)
    later = (t_slot[1:] > t_slot[:-1]) | ((t_slot[1:] == t_slot[:-1])
                                          & (cand[1:] > cand[:-1]))
    assert (later | ~real[1:]).all() and (real[:-1] | ~real[1:]).all()
    a = torch.from_numpy(act)
    assert (t_next[a] >= t_slot[-1][a]).all()


def test_candidates_unpadded_chunk_count(blob):
    """40 chunk boxes (not a multiple of 16): the supernodes are padded
    with far boxes, which must never become candidates
    (tests/test_binned.py:57)."""
    C = 40
    boxes = blob["bbox"][:C].contiguous()
    tb = torch.from_numpy(blob["tb"])
    cand, t_next = bn.candidates(boxes, blob["rays"], tb, 6)
    jc, jt = jbinned.candidate_chunks_pallas(
        blob["pack"].chunk_bbox[:C], _jcomp(blob["o"]), _jcomp(blob["d"]),
        jnp.asarray(blob["tb"]), k=6, interpret=True)
    jc, jt = np.asarray(jc), np.asarray(jt)
    c, t = cand.numpy(), t_next.numpy()
    assert c.max() < C and jc.max() < C
    _same_sets(c, jc, np.ones(blob["R"], bool))
    assert (np.isfinite(t) == np.isfinite(jt)).all()
    fin = np.isfinite(jt)
    np.testing.assert_allclose(t[fin], jt[fin], rtol=1e-6)
    cboxes, sboxes = bn._supernodes(boxes)
    assert cboxes.shape == (48, 8) and sboxes.shape == (3, 8)
    assert (cboxes[C:, :6] == float(jmeshpack.BIG)).all()


def _jplanes(x, p_pad):
    """(c, P) -> (c, p_pad / 128, 128) padded with its dead fill."""
    x = np.asarray(x)
    fill = -1 if x.dtype == np.int32 else 0.0
    out = np.full((x.shape[0], p_pad), fill, x.dtype)
    out[:, :x.shape[1]] = x
    return jnp.asarray(out.reshape(x.shape[0], -1, LANES))


def test_pair_scans_match_jax(blob):
    """Both pair scans on the chunk-sorted pairs of 512 rays' candidates
    (k = 4): the closest hit against build_pair_kernel, the any-hit flag
    against build_pair_kernel_occl and against the closest hit's t."""
    n = 512
    rays = blob["rays"][:, :n].contiguous()
    tb = torch.from_numpy(blob["tb"][:n])
    cand, _ = bn.candidates(blob["bbox"], rays, None, 4)
    exclude = torch.from_numpy(
        np.random.default_rng(5).integers(-1, 5120, n).astype(np.int32))
    pair_f, pair_i, perm = bn._pairs(cand, rays, exclude, tb)
    P = pair_f.shape[1]
    live = pair_i[0] >= 0
    assert live.any() and not live.all()
    assert bool((pair_i[0][live][1:] >= pair_i[0][live][:-1]).all())
    tri = blob["tri"]
    before = (bn.launches_pair, bn.launches_pair_occl)
    out_f, out_i = bn.pair_intersect(pair_f, pair_i, tri)
    flag = bn.pair_occluded(pair_f, pair_i, tri)
    assert (bn.launches_pair, bn.launches_pair_occl) == before
    p_pad = -(-P // TILE) * TILE
    n_rows = int(tri.shape[0])
    jf, ji = jbinned.build_pair_kernel(n_rows, True)(
        _jplanes(pair_f, p_pad), _jplanes(pair_i, p_pad),
        blob["pack"].tri_rows)
    (jh,) = jbinned.build_pair_kernel_occl(n_rows, True)(
        _jplanes(pair_f, p_pad), _jplanes(pair_i, p_pad),
        blob["pack"].tri_rows)
    jf = np.asarray(jf).reshape(4, -1)[:, :P]
    ji = np.asarray(ji).reshape(-1)[:P]
    jh = np.asarray(jh).reshape(-1)[:P]
    gi = out_i[0].numpy()
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(flag[0].numpy(), jh)
    hit = gi >= 0
    assert hit.any() and not hit.all()
    gf = out_f.numpy()
    np.testing.assert_allclose(gf[0, hit], jf[0, hit], rtol=1e-5)
    np.testing.assert_allclose(gf[1:, hit], jf[1:, hit], rtol=1e-5,
                               atol=1e-6)
    assert np.isposinf(gf[0, ~hit]).all() and (gf[1:, ~hit] == 0).all()
    # the any-hit flag is exactly the closest hit's t <= t_light
    derived = hit & (gf[0] <= pair_f[6].numpy())
    np.testing.assert_array_equal(flag[0].numpy() != 0, derived)
    assert derived.any() and (hit & ~derived).any()
    # a chunk id at or beyond the real chunk count tests nothing
    n_chunks = n_rows // 16
    bad = pair_i.clone()
    bad[0, :8] = torch.tensor([n_chunks, n_chunks + 5, 2 ** 30, -1] * 2,
                              dtype=torch.int32)
    got_f, got_i = bn.pair_reference(pair_f, bad, tri)
    assert (got_i[0, :8] == -1).all() and torch.isinf(got_f[0, :8]).all()
    assert (bn.pair_occluded_reference(pair_f, bad, tri)[0, :8] == 0).all()


def _cast_case(R, seed=1):
    """mesh_scene(16, 16, 2) with mesh_min=64 and R rays from a shell
    around the blob at random points inside it (tests/test_binned.py:80)."""
    doc = presets.mesh_scene(16, 16, subdivisions=2)
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    assert static.mesh_parts
    packs = kt.mesh_packs_for(scene, static)
    arrays = tuple(a for p in packs for a in p.arrays)
    rng = np.random.default_rng(seed)
    bb = packs[0].chunk_bbox.numpy()
    bb = bb[np.abs(bb[:, 0:6]).max(1) < 1e6]
    lo, hi = bb[:, 0:3].min(0), bb[:, 3:6].max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo)
    on = ctr + rng.uniform(-1.5, 1.5, (R, 3)) * ext
    tgt = ctr + rng.uniform(-0.5, 0.5, (R, 3)) * ext
    dn = tgt - on
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    rays = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([on.T, dn.T]), dtype=np.float32))
    return doc, static, arrays, rays, rng, ext


def _walk_want(static, arrays, rays, exclude, active):
    """walk_reference from an empty seed on the active rays; the inactive
    encoding (+inf, 0, -1) elsewhere."""
    R = rays.shape[1]
    seed_f = torch.zeros((4, R))
    seed_f[0] = torch.where(active, torch.inf, -torch.inf)
    seed_i = torch.stack([torch.full((R,), -1, dtype=torch.int32), exclude])
    f, i = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)
    f[0][~active] = torch.inf
    return f, i


def _equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_closest_hit_is_the_walk_in_every_finish():
    """k = 1 leaves most rays that reach the blob unresolved; active sets
    with 0, <= 1,024, <= 2,048 and more unresolved rays take each branch
    of _walk_finish at R = 16,384 (tiers 1,024 and 2,048). Every result
    equals the walk over all rays."""
    R = 16384
    _, static, arrays, rays, _, _ = _cast_case(R)
    assert bn._finish_tiers(R) == [1024, 2048]
    exclude = torch.full((R,), -1, dtype=torch.int32)
    tri_rows, bbox = bn._part(arrays, 0)
    unres = ~bn.mesh_winner(tri_rows, bbox, rays, exclude, k=1)[3]
    ids = torch.nonzero(unres)[:, 0]
    res_ids = torch.nonzero(~unres)[:, 0]
    assert ids.shape[0] > 2048 and res_ids.shape[0] > 1000
    want_all = _walk_want(static, arrays, rays, exclude,
                          torch.ones(R, dtype=torch.bool))
    bn.cast_log = log = []
    try:
        for n_unres, finish in ((0, None), (700, 1024), (1500, 2048),
                                (ids.shape[0], "full")):
            active = torch.zeros(R, dtype=torch.bool)
            active[res_ids[:1000]] = True
            active[ids[:n_unres]] = True
            before = bn.host_reads
            got = bn.mesh_closest_hit(static, arrays, rays, exclude, k=1,
                                      active=active)
            assert bn.host_reads == before + 1  # the unresolved count
            assert log[-1]["finish"] == finish and log[-1]["unres"] == n_unres
            assert got[0].is_contiguous() and got[1].is_contiguous()
            want_f = want_all[0].clone()
            want_f[:, ~active] = torch.tensor([[torch.inf], [0.0], [0.0],
                                               [0.0]])
            _equal(got, (want_f, torch.where(active, want_all[1], -1)))
            assert (got[1][0][active] >= 0).any()
    finally:
        bn.cast_log = None


@pytest.fixture(scope="module")
def cast4096():
    return _cast_case(4096)


def test_closest_hit_batched_matches_walk_and_jax(cast4096):
    """mesh_closest_hit_batched with batch 1,024 (4 batches at a live share
    of about 0.8) and the plain cast equal the walk over all rays; the
    JAX cast on the same rays gives the same winners."""
    doc, static, arrays, rays, rng, _ = cast4096
    R = rays.shape[1]
    exclude = torch.full((R,), -1, dtype=torch.int32)
    active = torch.from_numpy(rng.uniform(size=R) < 0.8)
    want = _walk_want(static, arrays, rays, exclude, active)
    bn.cast_log = log = []
    try:
        got_b = bn.mesh_closest_hit_batched(static, arrays, rays, exclude,
                                            active=active, batch=1024)
        got_t = bn.mesh_closest_hit_batched(static, arrays, rays, exclude,
                                            active=active, batch=1024,
                                            threshold=R // 4)
    finally:
        bn.cast_log = None
    assert log[0]["batches"] == 4 and log[-2]["batches"] == 0
    got = bn.mesh_closest_hit(static, arrays, rays, exclude, active=active)
    for g in (got, got_b, got_t):
        _equal(g, want)
    hit = want[1][0] >= 0
    assert hit.float().mean() > 0.2 and not hit[~active].any()
    # the JAX package's batched cast on the same rays
    js, _ = jax_scene_from_dict(jpresets.mesh_scene(16, 16, subdivisions=2))
    jstatic = jpt.SceneStatic.from_scene(js, mesh_min=64)
    jarrays = tuple(jnp.asarray(a) for p in jpt.mesh_packs_for(js, jstatic)
                    for a in p.arrays)
    jt, ji, _ = jbinned.mesh_closest_hit_batched(
        jstatic, jarrays, _jcomp(rays[:3].numpy()), _jcomp(rays[3:].numpy()),
        jnp.asarray(exclude.numpy()), interpret=True,
        active=jnp.asarray(active.numpy()), batch=1024)
    np.testing.assert_array_equal(got_b[1][0].numpy(), np.asarray(ji))
    h = hit.numpy()
    np.testing.assert_allclose(got_b[0][0].numpy()[h], np.asarray(jt)[h],
                               rtol=1e-5)


@pytest.mark.parametrize("frac", [0.04, 1.0])
def test_occluded_is_the_closest_hit_flag(cast4096, frac):
    """mesh_occluded and mesh_occluded_batched equal (idx >= 0) & (t <=
    t_su) of the closest-hit cast at every live share
    (tests/test_binned.py:131), and so does k = 1, which sends the
    occluder-free unresolved rays through the walk seeded empty."""
    _, static, arrays, rays, rng, ext = cast4096
    R = rays.shape[1]
    exclude = torch.full((R,), -1, dtype=torch.int32)
    tsu = torch.from_numpy((rng.uniform(0.5, 3.0, R) * float(ext.max()))
                           .astype(np.float32))
    active = torch.from_numpy(rng.uniform(size=R) < frac)
    f, i = bn.mesh_closest_hit(static, arrays, rays, exclude, tsu,
                               active=active)
    want = (i[0] >= 0) & (f[0] <= tsu)
    bn.cast_log = log = []
    try:
        got = bn.mesh_occluded(static, arrays, rays, exclude, tsu,
                               active=active)
        got_b = bn.mesh_occluded_batched(static, arrays, rays, exclude, tsu,
                                         active=active, batch=1024,
                                         threshold=R // 4)
        got_k1 = bn.mesh_occluded(static, arrays, rays, exclude, tsu, k=1,
                                  active=active)
    finally:
        bn.cast_log = None
    for g in (got, got_b, got_k1):
        assert torch.equal(g, want)
    if frac == 1.0:
        assert log[-1]["unres"] > 0
        assert want.any() and not want.all()


@pytest.mark.parametrize("bad", ["k", "rays_dtype", "pair_i_dtype",
                                 "tri_rows", "work_on_cpu"])
def test_binned_wrappers_check(blob, bad):
    rays, bbox, tri = blob["rays"], blob["bbox"], blob["tri"]
    cand, _ = bn.candidates(bbox, rays[:, :64].contiguous(), None, 1)
    pair_f, pair_i, _ = bn._pairs(cand, rays[:, :64],
                                  torch.full((64,), -1, dtype=torch.int32))
    with pytest.raises(ValueError):
        if bad == "k":
            bn.candidates(bbox, rays, None, 2)  # not a built k
        elif bad == "rays_dtype":
            bn.candidates(bbox, rays.double(), None, 4)
        elif bad == "pair_i_dtype":
            bn.pair_intersect(pair_f, pair_i.long(), tri)
        elif bad == "tri_rows":
            bn.pair_occluded(pair_f, pair_i, tri[:-1])
        else:
            bn.pair_intersect(pair_f, pair_i, tri,
                              work=torch.zeros(mk.WORK_KINDS, dtype=torch.int64))
