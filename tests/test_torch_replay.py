"""The guided replay of the PyTorch port vs the JAX package's.

Scenes with mesh parts take their gradients through the winner-taped
forward (``forward_winners``, ``build_forward(taped=True)``) and torch
autograd of the guided replay (``tracer/replay.py``). Inputs are built
with the JAX package's own ray generation and hero gather (the pattern of
tests/test_torch_backward.py): 128 random pixels of a 16x16 film of
``mesh_scene(16, 16, 1)`` with ``mesh_min=16`` (one mesh part of 80
triangles, the sizes of tests/test_pallas.py:147-187), depth 2.

- winner tape: ``forward_winners_reference`` against
  ``build_forward(taped=True, interpret=True)``: radiance as
  tests/test_torch_mesh.py holds the forward (at least 99.9% of rays
  within rel 1e-4, the denominator floored at 1e-2); the tapes equal
  wherever the port's holds a winner, and the replay of the JAX tape bit
  for bit the replay of the port's. The two differ only in entries that
  nothing reads: the TPU kernel tapes every light for every lane of a
  tile that scans and -1 for a whole tile that it skips, the port the
  picked light's winner per ray and -1 elsewhere.
- ``hit_from_index`` against the JAX package's on real winners of every
  category (patch, sphere, triangle row, mesh-part triangle, miss),
  within rel 1e-5 (XLA may fuse products into FMAs on the CPU), and bit
  for bit against the port's own scans: the replayed t is the forward's.
- the replay's cotangents (autograd of ``trace_replay`` on the JAX
  winner tape) against ``jax.vjp`` of the JAX package's ``trace_replay``
  on that tape, the backward of its Pallas path (``_mesh_bwd``), with
  the tolerances of tests/test_torch_backward.py: d_prims within rtol
  1e-3 / atol 1e-4 of its largest entry, d_rays and d_spect within rel
  1e-3 (denominator floored at 1e-3 of the plane's largest magnitude).
- ``MeshTraceFn``: the untaped forward under no_grad, gradients equal to
  autograd of the replay on its own tape and bit-equal across runs.
- ``optimize`` on ``mesh_scene(8, 8, 2)`` (a mesh part of 320 triangles
  at the default mesh_min): one step's gradient against the JAX
  package's ``make_loss_fn`` with its default kernel, the eager XLA
  tracer (its Pallas kernel's interpret-mode forward and replay take
  minutes on the CPU; tests/test_pallas.py holds the two JAX paths
  together at these tolerances), and the loss going down over 3 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.kernels import meshpack as jmeshpack
from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import replay as jreplay
from computeraytracer_tpu.train import optimize as jopt
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import mesh as tmesh
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import replay
from computeraytracer_tpu_torch.train import optimize as opt

W = H = 16
R = 128
MAX_DEPTH = 2
RR_START = 1
MESH_MIN = 16


@pytest.fixture(scope="module")
def case():
    """The JAX package's inputs, winner-taped forward and replay vjp, and
    the port's operands built from the same NumPy arrays."""
    js, _ = jax_scene_from_dict(jpresets.mesh_scene(W, H, 1))
    jstatic = jmk.SceneStatic.from_scene(js, mesh_min=MESH_MIN)
    g = np.random.default_rng(0)
    px = g.integers(0, W, R).astype(np.uint32)
    py = g.integers(0, H, R).astype(np.uint32)
    sample = np.uint32(1)
    cam = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(cam.eye, cam.lookat, cam.up, cam.fov,
                                      W, H, px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    rays = np.asarray(jnp.concatenate([o, d], axis=0))
    seeds = np.asarray(seed_p)
    spect = np.ascontiguousarray(np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)])
    planes = lambda x: jnp.asarray(x).reshape(x.shape[0], 1, jmk.LANES)
    arrays = [jnp.asarray(a) for part in jstatic.mesh_parts
              for a in jmeshpack.pack_scene_mesh(js, part).arrays]
    fwd = jmk.build_forward(jstatic, MAX_DEPTH, RR_START, tile_m=1,
                            interpret=True, taped=True)
    rad, t_idx, t_sh = jax.block_until_ready(fwd(
        jmk.pack_prims(jdata.as_jax(js), jstatic), planes(rays),
        planes(seeds), planes(spect), *arrays))
    t_idx = jnp.asarray(t_idx)
    t_sh = jnp.asarray(t_sh)
    cats = jnp.asarray(js.primitives.category, jnp.int32)

    def jax_replay(pf, r, sp):
        return jreplay.trace_replay(jstatic, cats, pf, r, planes(seeds), sp,
                                    t_idx, t_sh, MAX_DEPTH, RR_START)

    j_out, j_vjp = jax.vjp(jax_replay, jmk.pack_prims(jdata.as_jax(js)),
                           planes(rays), planes(spect))

    scene = scene_from_jax(js)
    static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
    assert [p.count for p in static.mesh_parts] == [80]
    return {
        "scene": scene, "static": static,
        "prims": mk.pack_prims(scene, static),
        "prims_full": mk.pack_prims(scene),
        "cats": scene.primitives.category,
        "rays": torch.from_numpy(rays.copy()),
        "seeds": torch.from_numpy(seeds.astype(np.int64)),
        "spect": torch.from_numpy(spect.copy()),
        "arrays": tuple(a for p in kt.mesh_packs_for(scene, static)
                        for a in p.arrays),
        "jax_rad": np.asarray(rad).reshape(4, R),
        "jax_idx": torch.from_numpy(np.array(t_idx).reshape(-1, R)),
        "jax_sh": torch.from_numpy(np.array(t_sh).reshape(
            MAX_DEPTH + 1, -1, R)),
        "jax_replay": np.asarray(j_out).reshape(4, R),
        "jax_vjp": lambda dL: [np.asarray(x) for x in j_vjp(planes(dL))],
        "dL": g.standard_normal((4, R)).astype(np.float32),
    }


def _port_winners(case):
    return mk.forward_winners_reference(
        case["static"], MAX_DEPTH, RR_START, case["prims"], case["rays"],
        case["seeds"], case["spect"], *case["arrays"])


def _replay(case, t_idx, t_sh, prims_full=None, rays=None, spect=None):
    return replay.trace_replay(
        case["static"], case["cats"],
        case["prims_full"] if prims_full is None else prims_full,
        case["rays"] if rays is None else rays, case["seeds"],
        case["spect"] if spect is None else spect, t_idx, t_sh, MAX_DEPTH,
        RR_START)


def test_winner_tape_matches_jax(case):
    rad, t_idx, t_sh = _port_winners(case)
    assert t_idx.dtype == t_sh.dtype == torch.int32
    assert t_idx.shape == (MAX_DEPTH + 1, R)
    assert t_sh.shape == (MAX_DEPTH + 1, 1, R)
    want = case["jax_rad"]
    rel = np.abs(rad.numpy() - want) / np.maximum(np.abs(want), 1e-2)
    assert (rel < 1e-4).all(axis=0).mean() >= 0.999, rel.max()
    for got, jax_tape in ((t_idx, case["jax_idx"]), (t_sh, case["jax_sh"])):
        held = got >= 0
        assert held.any()
        assert torch.equal(jax_tape[held], got[held])
    # every entry where the tapes part is one that nothing reads
    with torch.no_grad():
        ours = _replay(case, t_idx, t_sh)
        theirs = _replay(case, case["jax_idx"], case["jax_sh"])
    assert torch.equal(ours, theirs)
    assert torch.equal(ours, rad)  # the replay retraces the forward's paths
    # hits on the mesh part were taped
    part = case["static"].mesh_parts[0]
    assert ((t_idx >= part.start) & (t_idx < part.start + part.count)).any()


def _all_categories_scene():
    """Cornell box (patches, spheres) with a mesh part of 80 triangles and
    a 2-triangle mesh that stays unrolled rows."""
    doc = presets.cornell_box(W, H)
    blob_v, blob_f = tmesh.displaced_blob(1)
    blob_v = tmesh.transform(blob_v, scale=90.0, translate=(400.0, 150.0,
                                                             200.0))
    doc["objects"]["meshes"] = [
        {"vertices": blob_v.tolist(), "faces": blob_f.tolist(),
         "emission": "dark", "reflectance": "white", "type": "diffuse"},
        {"vertices": [[100, 1, 100], [450, 1, 100], [450, 1, 450],
                      [100, 1, 450]],
         "faces": [[0, 1, 2], [0, 2, 3]], "emission": "dark",
         "reflectance": "green", "type": "diffuse"}]
    return doc


def test_hit_from_index_matches_jax():
    doc = _all_categories_scene()
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
    assert len(static.mesh_parts) == 1 and 2 in static.categories
    mesh = tuple(zip(static.mesh_parts, [
        p.arrays for p in kt.mesh_packs_for(scene, static)]))
    prims = mk.pack_prims(scene, static)
    px, py = kt.tile_coords(W, H, 0)
    o, d, _, _ = kt.camera_planes(scene, W, H, px, py, 1)
    o, d = tuple(o), tuple(d)
    neg = torch.full((W * H,), -1, dtype=torch.int64)
    first = mk._scan_primitives(static, prims, o, d, neg, mesh)
    # second rays from the first hits in fixed directions, excluding them
    g = np.random.default_rng(3)
    d2 = g.standard_normal((3, W * H)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=0)
    o2, d2 = first["pos"], tuple(torch.from_numpy(d2))
    second = mk._scan_primitives(static, prims, o2, d2, first["idx"], mesh)
    cats = scene.primitives.category
    prims_full = mk.pack_prims(scene)
    js, _ = jax_scene_from_dict(doc)
    jprims = jmk.pack_prims(jdata.as_jax(js))
    jcats = jnp.asarray(js.primitives.category, jnp.int32)
    seen = set()
    for hit, ro, rd in ((first, o, d), (second, o2, d2)):
        got = replay.hit_from_index(prims_full, cats, hit["idx"], ro, rd)
        h = hit["hit"]
        assert torch.equal(got["hit"], h)
        assert torch.equal(got["t"][h], hit["t"][h])
        for k in ("pos", "nrm"):
            for a, b in zip(got[k], hit[k]):
                assert torch.equal(a, b)
        seen |= {int(c) for c in cats[hit["idx"][h]]}
        seen |= {("part", bool((hit["idx"] >= static.mesh_parts[0].start)
                               .any()))}
        want = jreplay.hit_from_index(
            jprims, jcats, jnp.asarray(hit["idx"].numpy(), jnp.int32),
            tuple(jnp.asarray(x.numpy()) for x in ro),
            tuple(jnp.asarray(x.numpy()) for x in rd))
        np.testing.assert_array_equal(got["hit"].numpy(),
                                      np.asarray(want["hit"]))
        hn = h.numpy()
        np.testing.assert_allclose(got["t"].numpy()[hn],
                                   np.asarray(want["t"])[hn], rtol=1e-5)
        for k, atol in (("pos", 1e-3), ("nrm", 1e-5)):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=atol)
    assert {0, 1, 2, ("part", True)} <= seen
    assert not bool(first["hit"].all() and second["hit"].all())  # misses


def test_replay_gradient_matches_jax_replay(case):
    """Autograd of the port's replay on the JAX winner tape against
    jax.vjp of the JAX replay: rays whose radiance parts by more than rel
    1e-4 after a flipped sampling decision get dL = 0 on both sides."""
    leaves = [case[k].clone().requires_grad_(True)
              for k in ("prims_full", "rays", "spect")]
    out = _replay(case, case["jax_idx"], case["jax_sh"], *leaves)
    want_rad = case["jax_replay"]
    rel = np.abs(out.detach().numpy() - want_rad) / np.maximum(
        np.abs(want_rad), 1e-6)
    same = (rel <= 1e-4).all(axis=0)
    assert same.mean() >= 0.99
    dL = case["dL"].copy()
    dL[:, ~same] = 0.0
    got = [g.numpy() for g in torch.autograd.grad(out, leaves,
                                                  torch.from_numpy(dL))]
    want = case["jax_vjp"](dL)
    want[1] = want[1].reshape(6, R)
    want[2] = want[2].reshape(-1, R)
    for g in got:
        assert np.isfinite(g).all()
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(got[0] / scale, want[0] / scale, rtol=1e-3,
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        den = np.maximum(np.abs(w), 1e-3 * np.abs(w).max())
        assert (np.abs(g - w) / den).max() < 1e-3
    assert np.abs(got[0][6:]).max() > 0  # the mesh part's vertices


def test_mesh_trace_fn(case):
    static = case["static"]
    args = (static, MAX_DEPTH, RR_START, case["prims_full"], case["rays"],
            case["seeds"], case["spect"], case["cats"], *case["arrays"])
    before = (mk.launches_mesh, mk.launches_winners)
    with torch.no_grad():
        plain = mk.MeshTraceFn.apply(*args)
    assert torch.equal(plain, mk.forward(
        static, MAX_DEPTH, RR_START, case["prims"], case["rays"],
        case["seeds"], case["spect"], *case["arrays"]))
    dL = torch.from_numpy(case["dL"])
    runs = []
    for _ in range(2):
        leaves = [case[k].clone().requires_grad_(True)
                  for k in ("prims_full", "rays", "spect")]
        out = mk.MeshTraceFn.apply(static, MAX_DEPTH, RR_START, leaves[0],
                                   leaves[1], case["seeds"], leaves[2],
                                   case["cats"], *case["arrays"])
        assert torch.equal(out.detach(), plain)
        out.backward(dL)
        runs.append([x.grad for x in leaves])
    assert (mk.launches_mesh, mk.launches_winners) == before  # the CPU
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    _, t_idx, t_sh = _port_winners(case)
    leaves = [case[k].clone().requires_grad_(True)
              for k in ("prims_full", "rays", "spect")]
    want = torch.autograd.grad(_replay(case, t_idx, t_sh, *leaves), leaves,
                               dL)
    for a, b in zip(runs[0], want):
        assert torch.equal(a, b)


def test_optimize_mesh_scene_matches_jax():
    doc = jpresets.mesh_scene(8, 8, 2)
    js, _ = jax_scene_from_dict(doc)
    scene = scene_from_jax(js)
    assert [p.count for p in mk.SceneStatic.from_scene(scene).mesh_parts] \
        == [320]
    target = np.zeros((8, 8, 3), np.float32)
    jloss = jopt.make_loss_fn(js, 8, 8, 1, 2)
    jparams = {"spectra": jnp.asarray(js.spectra),
               "data1": jnp.asarray(js.primitives.data1)}
    jval, jgrad = jax.value_and_grad(jloss)(jparams, jnp.asarray(target), 1)
    loss_fn = opt.make_loss_fn(scene, 8, 8, 1, 2)
    params = {k: (scene.spectra if k == "spectra"
                  else scene.primitives.data1).clone().requires_grad_(True)
              for k in ("spectra", "data1")}
    loss = loss_fn(params, torch.from_numpy(target), 1)
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-4)
    for k in ("spectra", "data1"):
        got, want = params[k].grad.numpy(), np.asarray(jgrad[k])
        assert np.isfinite(got).all()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-3,
                                   atol=1e-4)
    assert np.abs(params["data1"].grad.numpy()[6:]).max() > 0
    # 3 Adam steps recover a dimmed albedo of the mesh
    static = mk.SceneStatic.from_scene(scene)
    row = static.mesh_parts[0].reflectance_idx
    with torch.no_grad():
        want_img = opt.render_mean_xyz(scene, 8, 8, 1, 2)
    spectra = scene.spectra.clone()
    spectra[row] = spectra[row] * 0.3
    _, losses = opt.optimize(
        dataclasses.replace(scene, spectra=spectra), want_img, 8, 8,
        trainable=("spectra",), steps=3, learning_rate=0.05, spp=1,
        max_depth=2, spectra_rows=[row])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_row_sums_fixed_order(monkeypatch):
    """The gather's backward sums rows shared by many rays over blocks of
    rays (here 8) in a fixed order: the float64 scatter's sums to
    rounding, bit-equal across runs, zero for rows no ray gathered."""
    monkeypatch.setattr(replay, "SUM_BLOCK", 8)
    g = np.random.default_rng(5)
    idx = torch.from_numpy(g.integers(0, 3, 101))
    idx[::4] = torch.from_numpy(g.integers(0, 40, 26))
    vals = torch.from_numpy(g.standard_normal((101, 12)).astype(np.float32))
    got = replay._row_sums(idx, vals, 50)
    want = torch.zeros((50, 12), dtype=torch.float64).index_put_(
        (idx,), vals.double(), accumulate=True)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, replay._row_sums(idx, vals, 50))
    unused = torch.ones(50, dtype=torch.bool)
    unused[idx] = False
    assert (got[unused] == 0).all()
