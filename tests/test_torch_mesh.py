"""Mesh scenes in the PyTorch port vs the JAX package.

- ``scene/mesh.py`` and the chunk BVH packs of ``kernels/meshpack.py``
  equal the JAX package's exactly (Morton order and DFS meta included);
- the watertight triangle test: a ray aimed at a shared edge or vertex of
  two adjacent icosphere triangles hits one of them, through
  ``ops/intersect.py`` and through the plain mesh-part scan (the pattern
  of tests/test_watertight.py);
- the plain mesh render against the JAX package's ``render_sample``:
  ``mesh_scene(12, 12, subdivisions=2)`` with ``mesh_min=64`` (one part
  of 320 triangles in 3 chunks, tests/test_pallas.py:47-65), and the
  scenes whose triangles stay unrolled category-2 rows. For those the
  JAX package's Pallas kernel in interpret mode is held at
  ``subdivisions=0`` (20 triangles); at ``subdivisions=1`` (80
  triangles, the default ``mesh_min=256``) its XLA tracer is the
  reference instead, which tests/test_pallas.py holds the Pallas kernel
  against: interpret mode compiles 86 unrolled rows for some 2.5 minutes.
  Criterion: at least 99.9% of pixels within rel 1e-4, the denominator
  floored at 1e-2 (tests/test_pallas.py);
- the loader and the presets accept ``"meshes"``; mesh gradients run
  for triangle rows through every backward, and a mesh part handed to a
  backward kernel raises (its gradients are held against the JAX package
  in tests/test_torch_replay.py and tests/test_torch_tri_grads.py).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.kernels import meshpack as jmeshpack
from computeraytracer_tpu.ops import intersect as jisect
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import mesh as jmesh
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu.tracer import xla as jax_xla
from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.scene import load_scene, presets
from computeraytracer_tpu_torch.scene import mesh as tmesh
from computeraytracer_tpu_torch.scene import scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.utils import read_png

N = 12  # film side of the render comparisons


def _scene(subdivisions, w=N, h=N):
    return scene_from_dict(presets.mesh_scene(w, h, subdivisions),
                           device="cpu")[0]


def _close_pixels(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    return (rel < 1e-4).all(axis=-1).mean(), rel.max()


# ---------------------------------------------------------------------------
# geometry and packing
# ---------------------------------------------------------------------------


def test_mesh_module_matches_jax(tmp_path):
    for fn, args in ((tmesh.icosphere, (2,)),
                     (tmesh.displaced_blob, (2,)),
                     (tmesh.displaced_blob, (1, 0.4, 3))):
        got = fn(*args)
        want = getattr(jmesh, fn.__name__)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    v, f = tmesh.icosphere(1)
    np.testing.assert_array_equal(tmesh.transform(v, 2.0, (1, 2, 3)),
                                  jmesh.transform(v, 2.0, (1, 2, 3)))
    got = tmesh.mesh_arrays(v, f, reflectance=1, emission=2, material=0)
    want = jmesh.mesh_arrays(v, f, reflectance=1, emission=2, material=0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tri = tmesh.mesh_triangles(v[:3], [[0, 1, 2]], 0, 1, 2)
    assert tri[0]["v1"].dtype == np.float32 and tri[0]["material"] == 2
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2/5 3 -1\n")
    for g, w in zip(tmesh.load_obj(str(path)), jmesh.load_obj(str(path))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("subdivisions,mesh_min", [(2, 64), (2, 256),
                                                   (3, 256)])
def test_scene_static_and_packs_match_jax(subdivisions, mesh_min):
    doc = jpresets.mesh_scene(8, 8, subdivisions)
    js, _ = jax_scene_from_dict(doc)
    ts, _ = scene_from_dict(doc, device="cpu")
    jst = jmk.SceneStatic.from_scene(js, mesh_min=mesh_min)
    tst = mk.SceneStatic.from_scene(ts, mesh_min=mesh_min)
    for field in ("rows", "categories", "materials", "emission_idx",
                  "reflectance_idx", "light_rows", "n_spectra"):
        assert getattr(tst, field) == getattr(jst, field), field
    assert [tuple(p) for p in tst.mesh_parts] == \
        [tuple(p) for p in jst.mesh_parts]
    np.testing.assert_array_equal(
        mk.pack_prims(ts, tst).numpy(),
        np.asarray(jmk.pack_prims(jdata.as_jax(js), jst)))
    assert tst.mesh_mode
    for tpart, jpart in zip(tst.mesh_parts, jst.mesh_parts):
        tplan = meshpack.plan_scene_mesh(ts, tpart)
        jplan = jmeshpack.plan_scene_mesh(js, jpart)
        for field in ("order", "perm", "meta"):
            np.testing.assert_array_equal(getattr(tplan, field),
                                          getattr(jplan, field))
        assert (tplan.n, tplan.n_chunks, tplan.n_groups) == \
            (jplan.n, jplan.n_chunks, jplan.n_groups)
        tpack = meshpack.pack_scene_mesh(ts, tpart)
        jpack = jmeshpack.pack_scene_mesh(js, jpart)
        for g, w in zip(tpack.arrays, jpack.arrays):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
        for g, w in zip(tpack.arrays[1:], jpack.arrays[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tpack.n_chunks == jpack.n_chunks
        _assert_same_tri_rows(tpack.tri_rows.numpy(),
                              np.asarray(jpack.tri_rows))


def _assert_same_tri_rows(got, want):
    """Vertices, ids and padding equal; the unit normals (words 10-12)
    equal to the kernels' formula with every product rounded on its own,
    and within 2^-21 of the JAX package's. The JAX pack takes the cross
    product with jnp.cross, which XLA fuses into FMAs on the CPU (not on
    the TPU, whose vector unit has no f32 FMA); the port keeps the
    separately rounded products of the kernels' formula."""
    got = got.reshape(-1, 16)
    want = want.reshape(-1, 16)
    rest = np.r_[0:10, 13:16]
    np.testing.assert_array_equal(got[:, rest], want[:, rest])
    v0, v1, v2 = want[:, 0:3], want[:, 3:6], want[:, 6:9]
    e1, e2 = v1 - v0, v2 - v0
    n = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                  e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                  e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
    n_len2 = (n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2]
    inv = np.float32(1.0) / np.sqrt(np.maximum(n_len2, np.float32(1e-30)))
    np.testing.assert_array_equal(got[:, 10:13], n * inv[:, None])
    # a component that cancels to near 0 keeps the rounding of the unit
    # length's scale, so the bound is absolute
    assert np.abs(got[:, 10:13] - want[:, 10:13]).max() <= 2.0 ** -21


# ---------------------------------------------------------------------------
# watertightness (tests/test_watertight.py pattern)
# ---------------------------------------------------------------------------


def _shared_edges(faces):
    edges = {}
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            edges.setdefault((min(u, v), max(u, v)), []).append(fi)
    return {k: v for k, v in edges.items() if len(v) == 2}


def _edge_rays(seed=0, n_points=3):
    """Rays from an eye to f32 points on shared front-facing edges (and on
    vertices whose whole fan faces the eye) of the 320-face icosphere."""
    rng = np.random.default_rng(seed)
    verts, faces = tmesh.icosphere(2)
    eye = np.array([0.0, 0.3, 3.0], np.float32)
    v0 = verts[faces[:, 0]]
    n = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    front = (n * (v0 - eye)).sum(1) * np.sign((n * v0).sum(1)) < -1e-6
    fan = {}
    for fi, tri in enumerate(faces):
        for vi in tri:
            fan.setdefault(int(vi), []).append(bool(front[fi]))
    pts = []
    for (a, b), (f1, f2) in _shared_edges(faces).items():
        if not (front[f1] and front[f2]):
            continue
        va, vb = verts[a].astype(np.float32), verts[b].astype(np.float32)
        for w in rng.uniform(0.05, 0.95, n_points):
            pts.append(np.float32(1.0 - w) * va + np.float32(w) * vb)
        if all(fan[int(a)]):
            pts.append(va)
    pts = np.asarray(pts, np.float32)
    return verts.astype(np.float32), faces, eye, pts


def test_shared_edge_rays_always_hit():
    verts, faces, eye, pts = _edge_rays()
    assert len(pts) > 400
    o = np.broadcast_to(eye, pts.shape)
    d = pts - o
    col = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, c]))
                          [:, None] for c in range(3))
    row = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, c]))
                          [None, :] for c in range(3))
    t, ok = isect.triangle_candidates_c(col(o), col(d),
                                        row(verts[faces[:, 0]]),
                                        row(verts[faces[:, 1]]),
                                        row(verts[faces[:, 2]]))
    hit = (ok & (t >= 0.001)).any(dim=1)
    assert bool(hit.all()), f"{int((~hit).sum())} rays fell through"
    # the same decisions as the JAX package's test, ray by triangle
    jt, jok = jisect.triangle_candidates(o[:, None, :], d[:, None, :],
                                         verts[faces[:, 0]],
                                         verts[faces[:, 1]],
                                         verts[faces[:, 2]])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_mesh_part_scan_never_leaks():
    """The packed icosphere as a mesh part: every edge-aimed ray hits it
    through the plain chunk scan, whatever the block of triangles."""
    verts, faces, eye, pts = _edge_rays(seed=1, n_points=2)
    cols = tmesh.mesh_arrays(verts, faces, 0, 0, 0)
    pack = meshpack.pack_mesh(*(torch.from_numpy(cols[k]) for k in
                                ("data1", "data2", "data3")),
                              torch.arange(len(faces)))
    o = tuple(torch.full((len(pts),), float(e)) for e in eye)
    d = tuple(torch.from_numpy(pts[:, c] - eye[c]) for c in range(3))
    inf = torch.full((len(pts),), float("inf"))
    neg = torch.full((len(pts),), -1, dtype=torch.int64)
    zero = torch.zeros(len(pts))
    results = []
    for block in (1 << 22, 4096):
        mk_block, mk.MESH_BLOCK = mk.MESH_BLOCK, block
        try:
            results.append(mk._scan_mesh_part(
                pack.tri_rows, o, d, neg, isect.watertight_setup(o, d), inf,
                neg, (zero,) * 3, (zero,) * 3))
        finally:
            mk.MESH_BLOCK = mk_block
    t, idx, _, _ = results[0]
    assert bool((idx >= 0).all()), f"{int((idx < 0).sum())} rays leaked"
    assert bool(torch.isfinite(t).all())
    for a, b in zip(results[0], results[1]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# renders against the JAX package
# ---------------------------------------------------------------------------


def _jax_render(subdivisions, static_kw, tracer="pallas"):
    js, _ = jax_scene_from_dict(jpresets.mesh_scene(N, N, subdivisions))
    if tracer == "xla":
        return np.asarray(jax_xla.render_sample(js, N, N, 1, max_depth=3))
    static = jmk.SceneStatic.from_scene(js, **static_kw)
    return np.asarray(jax.block_until_ready(jax_pallas.render_sample(
        js, N, N, 1, max_depth=3, static=static, backward="none",
        wavefront=False, tile_m=2)))


@pytest.mark.parametrize("subdivisions,mesh_min,tracer", [
    (2, 64, "pallas"),     # one mesh part of 320 triangles in 3 chunks
    (0, 256, "pallas"),    # 20 unrolled triangle rows
    (1, 256, "xla"),       # 80 unrolled triangle rows
])
def test_mesh_render_matches_jax(subdivisions, mesh_min, tracer):
    scene = _scene(subdivisions)
    static = mk.SceneStatic.from_scene(scene, mesh_min=mesh_min)
    if mesh_min == 64:
        assert [p.count for p in static.mesh_parts] == [320]
        assert static.mesh_parts[0].n_chunks == 3
    else:
        assert not static.mesh_parts and 2 in static.categories
    got = kt.render_sample(scene, N, N, 1, max_depth=3, static=static)
    assert not got.requires_grad
    got = got.numpy()
    want = _jax_render(subdivisions, {"mesh_min": mesh_min}, tracer)
    assert got.shape == want.shape and np.isfinite(got).all()
    frac, worst = _close_pixels(got, want)
    assert frac >= 0.999, f"only {frac:.4f} of pixels match ({worst:.3g})"
    assert float(np.abs(got).max()) > 0


def test_mesh_part_and_unrolled_rows_agree():
    """The same 80 triangles as one mesh part and as unrolled category-2
    rows: the two scans' tie rules pick the same winners here."""
    scene = _scene(1)
    part = kt.render_sample(scene, N, N, 2, max_depth=3,
                            static=mk.SceneStatic.from_scene(scene, 16))
    rows = kt.render_sample(scene, N, N, 2, max_depth=3,
                            static=mk.SceneStatic.from_scene(scene, 10 ** 6))
    frac, worst = _close_pixels(part.numpy(), rows.numpy())
    assert frac >= 0.999, (frac, worst)


def test_mesh_render_api_and_bands():
    scene = _scene(2, 8, 8)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2)
    whole = api.render(scene, cfg)
    banded = api.render(scene, cfg.replace(ray_chunk=24))
    assert torch.isfinite(whole["accum_xyz"]).all()
    assert float(whole["accum_xyz"].abs().max()) > 0
    assert torch.equal(whole["accum_xyz"], banded["accum_xyz"])


def test_cpu_mesh_render_launches_no_kernel():
    scene = _scene(2, 4, 4)
    before = (mk.launches, mk.launches_mesh)
    kt.render_sample(scene, 4, 4, 1, max_depth=2,
                     static=mk.SceneStatic.from_scene(scene, 64))
    assert (mk.launches, mk.launches_mesh) == before


# ---------------------------------------------------------------------------
# loader, presets, CLI and what raises
# ---------------------------------------------------------------------------


def test_mesh_documents_load_bit_exact(tmp_path):
    doc = jpresets.mesh_scene(10, 8, 1)
    assert presets.mesh_scene(10, 8, 1) == doc
    js, jmeta = jax_scene_from_dict(doc)
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps(doc))
    for ts, meta in (scene_from_dict(doc, device="cpu"),
                     load_scene(str(path), device="cpu")):
        assert meta == jmeta
        p = ts.primitives
        for f in dataclasses.fields(p):
            w = np.asarray(getattr(js.primitives, f.name))
            g = getattr(p, f.name).numpy()
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        assert int((p.category == 2).sum()) == 80


def test_cli_renders_mesh_preset(tmp_path, capsys):
    out = tmp_path / "mesh.png"
    rc = cli.main(["render", "--preset", "mesh_scene", "--width", "6",
                   "--height", "4", "--spp", "1", "--depth", "1",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (4, 6, 3) and img.max() > 0
    capsys.readouterr()
    assert cli.main(["info", "--preset", "mesh_scene"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] == 81920 and info["patches"] == 6


def test_mesh_gradients_raise():
    """Mesh gradients: triangle rows through every backward (the backward
    kernels' plain versions, or the guided replay), and what still raises:
    a mesh part handed to the full tape or to a backward kernel, which
    have no chunk-BVH walk (the tracer routes mesh parts to the replay)."""
    scene = _scene(1, 4, 4)
    d1 = scene.primitives.data1.clone().requires_grad_(True)
    s = dataclasses.replace(scene, primitives=dataclasses.replace(
        scene.primitives, data1=d1))
    grads = {}
    for backward in ("pallas", "pallas_taped", "replay"):
        d1.grad = None
        (kt.render_sample(s, 4, 4, 1, max_depth=1, backward=backward)
         ** 2).sum().backward()
        assert torch.isfinite(d1.grad).all()
        grads[backward] = d1.grad
    assert grads["pallas"][6:].abs().max() > 0
    scale = grads["pallas"].abs().max()
    for backward in ("pallas_taped", "replay"):
        torch.testing.assert_close(grads[backward] / scale,
                                   grads["pallas"] / scale, rtol=1e-4,
                                   atol=1e-6)
    assert not kt.render_sample(s, 4, 4, 1, 1, backward="none").requires_grad
    static = mk.SceneStatic.from_scene(scene, mesh_min=16)
    assert static.mesh_parts
    o, d, hero, seed = kt.camera_planes(scene, 4, 4, *kt.tile_coords(4, 4, 0),
                                        1)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    dL = torch.zeros((4, 16))
    for call in (lambda: mk.TraceFn.apply(static, 1, 1, *args),
                 lambda: mk.TraceTapedFn.apply(static, 1, 1, *args),
                 lambda: mk.backward(static, 1, 1, *args, dL),
                 lambda: mk.forward_taped(static, 1, 1, *args),
                 lambda: mk.backward_from_tape(
                     static, 1, 1, args[0], args[3],
                     torch.zeros((32, 16)), torch.zeros((16, 16),
                                                        dtype=torch.int32),
                     dL)):
        with pytest.raises(NotImplementedError, match="guided replay"):
            call()


def test_mesh_knobs():
    scene = _scene(2, 4, 4)
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    # the wavefront renders what the in-kernel path renders, bit for bit
    assert torch.equal(
        kt.render_sample(scene, 4, 4, 1, 1, static=static, wavefront=True),
        kt.render_sample(scene, 4, 4, 1, 1, static=static, wavefront=False))
    # every backward of a scene with a mesh part is the guided replay
    for backward in ("replay", "pallas_taped"):
        assert torch.equal(
            kt.render_sample(scene, 4, 4, 1, 1, static=static,
                             backward=backward),
            kt.render_sample(scene, 4, 4, 1, 1, static=static))
    assert kt.MESH_WAVEFRONT_DEFAULT is False
    assert torch.equal(kt.render_sample(scene, 4, 4, 1, 1, static=static),
                       kt.render_sample(scene, 4, 4, 1, 1, static=static,
                                        wavefront=None))
    # the wavefront flag is ignored for a scene without mesh parts
    cornell = scene_from_dict(presets.cornell_box(4, 4), device="cpu")[0]
    plain = kt.render_sample(cornell, 4, 4, 1, 1)
    assert torch.equal(kt.render_sample(cornell, 4, 4, 1, 1, wavefront=True),
                       plain)


@pytest.mark.parametrize("bad", ["missing_arrays", "extra_arrays",
                                 "tri_rows_rows", "node_meta_dtype",
                                 "work_on_cpu", "work_without_mesh",
                                 "work_dtype"])
def test_forward_checks_mesh_arrays(bad):
    scene = _scene(2, 4, 4)
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    o, d, hero, seed = kt.camera_planes(scene, 4, 4, *kt.tile_coords(4, 4, 0),
                                        1)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    arrays = list(kt.mesh_packs_for(scene, static)[0].arrays)
    if bad == "missing_arrays":
        arrays = arrays[:3]
    elif bad == "extra_arrays":
        static = mk.SceneStatic.from_scene(scene, mesh_min=10 ** 6)
        args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    elif bad == "tri_rows_rows":
        arrays[0] = arrays[0][:-1]
    elif bad == "node_meta_dtype":
        arrays[3] = arrays[3].to(torch.int64)
    work = None
    if bad.startswith("work"):
        # the plain version counts no work, and only the mesh mode counts
        work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64)
    if bad == "work_without_mesh":
        scene = scene_from_dict(presets.cornell_box(4, 4), device="cpu")[0]
        static = mk.SceneStatic.from_scene(scene)
        args = kt.kernel_inputs(scene, o, d, hero, seed, static)
        arrays = []
    elif bad == "work_dtype":
        work = work.to(torch.int32)
    with pytest.raises(ValueError, match=None if work is None else "work"):
        mk.forward(static, 2, 1, *args, *arrays, work=work)
