"""The wavefront of the PyTorch port (``wavefront=True`` on scenes with
mesh parts) vs the JAX package's kernels and the port's in-kernel path.

Against the JAX kernels directly, in interpret mode (the pattern of
tests/test_binned.py), on the 1,024 rays of a 32x32 film of
``mesh_scene(32, 32, 1)`` with ``mesh_min=16`` (one mesh part of 80
triangles), depth 3, inputs from the JAX package's ray generation (the
pattern of tests/test_torch_replay.py):
- ``walk_reference`` against ``binned.build_walk_kernel`` on camera rays
  and secondary rays, seeded empty (+inf, -1), with the unrolled rows'
  winner, and inactive (t = -inf): idx equal on every lane, t and normals
  within rel 1e-5 (XLA fuses FMAs on the CPU), inactive lanes returning
  their seed;
- ``shade_step_reference`` against ``megakernel.build_shade_step`` in both
  variants (``scan_in_kernel`` True: the first bounce; False: the second,
  fed the first step's unrolled winner) on the same carries and mesh
  winners: integer planes equal wherever the port writes a value (the TPU
  kernel writes every lane of a live tile; the port writes tape_idx where
  the ray entered alive, a light's shadow winner where the bounce picked
  it, the unrolled winner where the ray stays alive), seed words
  bit-equal, float planes within rel 1e-4 (the denominator floored at
  1e-2 of the plane's scale) on at least 99.9% of those lanes.

The whole path against the port's own in-kernel plain version, which it
matches bit for bit (both run torch with no FMA; the JAX wavefront's
interpret-mode tests take 92-116 s and are not rerun):
- ``trace_radiance(wavefront=True)`` equal to ``wavefront=False`` on
  ``mesh_scene(64, 32, 2)`` (``mesh_min=64``, 2,048 rays, depth 3), with
  one light and with a second light patch added (the per-light planes and
  the light order), and at 128x64 with two lights, where sparse casts run
  in two batches of 1,024 rays (the binned casts' batched branch);
- the taped wavefront's tapes equal to ``forward_winners_reference``'s;
- gradients of ``sum(img ** 2)`` with respect to data1 and spectra at
  32x16, ``mesh_scene(32, 16, 1)``, ``mesh_min=16``, depth 2, bit-equal
  to the in-kernel path's (tests/test_torch_replay.py holds that path
  against the JAX replay) and non-zero on the mesh rows;
- the routing of every ``backward`` with ``wavefront=True``, no tape under
  no_grad, and the wrappers' checks.
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
from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 32
R = W * H
MAX_DEPTH = 3
RR_START = 1
MESH_MIN = 16
TILE_M = 8  # one tile of 1,024 rays


def _planes(x):
    x = np.asarray(x)
    return jnp.asarray(x.reshape(x.shape[0], -1, jmk.LANES))


def _np(x):
    """A JAX kernel output as (k, R) NumPy."""
    x = np.asarray(x)
    return x.reshape(-1, R) if x.ndim == 3 else x.reshape(R)


def _frac_close(got, want, lanes):
    """Share of `lanes` whose planes agree within rel 1e-4, the
    denominator floored at 1e-2 of the plane's scale (its largest finite
    magnitude, at least 1; as chip_smoke.py's tape checks): a coordinate
    near 0 in a 555-unit box carries XLA's FMA noise of a few 1e-6."""
    mag = np.where(np.isfinite(want), np.abs(want), 0.0)
    scale = np.maximum(mag.max(axis=1, keepdims=True), 1.0)
    with np.errstate(invalid="ignore"):  # inf - inf: equal, not close
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2 * scale)
    return ((rel < 1e-4) | (got == want)).all(axis=0)[lanes].mean()


@pytest.fixture(scope="module")
def case():
    js, _ = jax_scene_from_dict(jpresets.mesh_scene(W, H, 1))
    jstatic = jmk.SceneStatic.from_scene(js, mesh_min=MESH_MIN)
    px = np.tile(np.arange(W, dtype=np.uint32), H)
    py = np.repeat(np.arange(H, dtype=np.uint32), W)
    sample = np.uint32(1)
    cam = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(cam.eye, cam.lookat, cam.up, cam.fov,
                                      W, H, px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    rays = np.asarray(jnp.concatenate([o, d], axis=0))
    spect = np.ascontiguousarray(np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)])
    scene = scene_from_jax(js)
    static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
    assert [p.count for p in static.mesh_parts] == [80]
    return {
        "js": js, "jstatic": jstatic,
        "jprims": jmk.pack_prims(jdata.as_jax(js), jstatic),
        "jarrays": [jnp.asarray(a) for part in jstatic.mesh_parts
                    for a in jmeshpack.pack_scene_mesh(js, part).arrays],
        "static": static,
        "prims": mk.pack_prims(scene, static),
        "rays": torch.from_numpy(rays.copy()),
        "seeds": torch.from_numpy(np.asarray(seed_p).astype(np.int64)),
        "spect": torch.from_numpy(spect.copy()),
        "arrays": tuple(a for p in kt.mesh_packs_for(scene, static)
                        for a in p.arrays),
    }


def _in_part(static, idx):
    part = static.mesh_parts[0]
    return (idx >= part.start) & (idx < part.start + part.count)


def test_walk_matches_jax(case):
    from computeraytracer_tpu.kernels import binned as jbinned

    static, prims = case["static"], case["prims"]
    cam = case["rays"]
    o, d = tuple(cam[:3]), tuple(cam[3:])
    mesh = tuple(zip(static.mesh_parts, [case["arrays"]]))
    first = mk._scan_primitives(static, prims, o, d,
                                torch.full((R,), -1, dtype=torch.int64),
                                mesh)
    # the odd half: secondary rays from the first hits in fixed random
    # directions, excluding the hit
    g = np.random.default_rng(7)
    d2 = g.standard_normal((3, R)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=0)
    second = torch.cat([torch.stack(first["pos"]), torch.from_numpy(d2)])
    odd = torch.arange(R) % 2 == 1
    rays = torch.where(odd, second, cam).contiguous()
    exclude = torch.where(odd, first["idx"], -1)
    unrolled = mk._scan_primitives(static, prims, tuple(rays[:3]),
                                   tuple(rays[3:]), exclude)
    kind = torch.arange(R) % 3  # 0 empty, 1 the unrolled winner, 2 inactive
    seed_f = torch.zeros((4, R))
    seed_f[0] = torch.where(kind == 0, torch.inf, unrolled["t"])
    seed_f[0][kind == 2] = -torch.inf
    seed_f[1:] = torch.where(kind == 1, torch.stack(unrolled["nrm"]), 0.0)
    seed_i = torch.stack([torch.where(kind == 1, unrolled["idx"], -1),
                          exclude]).to(torch.int32)
    before = bn.launches_walk
    out_f, out_i = bn.walk(static, rays, seed_f, seed_i, *case["arrays"])
    assert bn.launches_walk == before  # the CPU launches nothing
    want = bn.walk_reference(static, rays, seed_f, seed_i, *case["arrays"])
    assert torch.equal(out_f, want[0]) and torch.equal(out_i, want[1])

    walk = jbinned.build_walk_kernel(case["jstatic"], TILE_M, True)
    jf, ji = jax.block_until_ready(walk(
        _planes(rays.numpy()), _planes(seed_f.numpy()),
        _planes(seed_i.numpy()), *case["jarrays"]))
    jf, ji = _np(jf), _np(ji)[0]
    got_f, got_i = out_f.numpy(), out_i[0].numpy()
    np.testing.assert_array_equal(got_i, ji)
    inactive = (kind == 2).numpy()
    for f in (got_f, jf):
        np.testing.assert_array_equal(f[:, inactive], seed_f.numpy()[:, inactive])
    np.testing.assert_array_equal(got_i[inactive], -1)
    hit = got_i >= 0
    np.testing.assert_allclose(got_f[0, hit], jf[0, hit], rtol=1e-5)
    np.testing.assert_allclose(got_f[1:, hit], jf[1:, hit], rtol=1e-5,
                               atol=1e-6)
    # the mesh won on empty and on seeded lanes, the seed held on others
    on_mesh = _in_part(static, out_i[0])
    seeded = (kind == 1) & (unrolled["idx"] >= 0)
    assert (on_mesh & (kind == 0)).any() and (on_mesh & seeded).any()
    assert (seeded & ~on_mesh).any() and ((kind == 0) & ~on_mesh).any()


def _bounce0(case):
    """The first bounce's carries and mesh winners (the walk from an empty
    seed)."""
    rays = case["rays"]
    carry_f = torch.cat([rays, torch.zeros((4, R)), torch.ones((6, R))])
    carry_u = mk._u32_bits(case["seeds"])
    carry_i = torch.tensor([-1, 0, 0, 1], dtype=torch.int32)[:, None] \
        .expand(4, R).contiguous()
    seed_f = torch.zeros((4, R))
    seed_f[0] = torch.inf
    seed_i = torch.stack([torch.full((R,), -1), carry_i[0]]).to(torch.int32)
    mesh_f, mesh_i = bn.walk_reference(case["static"], rays, seed_f, seed_i,
                                       *case["arrays"])
    return carry_f, carry_u, carry_i, mesh_f, mesh_i


def _step_inputs(case, scan_in_kernel):
    """(depth, carries, mesh winners, un) fed to both shade steps: the
    first bounce, or the second from the port's first step."""
    static = case["static"]
    carry_f, carry_u, carry_i, mesh_f, mesh_i = _bounce0(case)
    if scan_in_kernel:
        return 0, (carry_f, carry_u, carry_i, mesh_f, mesh_i), ()
    out = mk.shade_step_reference(static, 0, MAX_DEPTH, RR_START,
                                  case["prims"], carry_f, carry_u, carry_i,
                                  case["spect"], mesh_f, mesh_i)
    carry_f, carry_u, carry_i, _, _, _, un_f, un_i = out
    active = carry_i[3] != 0
    seed_f = torch.zeros((4, R))
    seed_f[0] = torch.where(active, un_f[0], -torch.inf)
    seed_i = torch.stack([torch.full((R,), -1, dtype=torch.int32),
                          carry_i[0]])
    mesh_f, mesh_i = bn.walk_reference(static, carry_f[:6].contiguous(),
                                       seed_f, seed_i, *case["arrays"])
    mesh_f[0][~active] = torch.inf
    return 1, (carry_f, carry_u, carry_i, mesh_f, mesh_i), (un_f, un_i)


@pytest.mark.parametrize("scan_in_kernel", [True, False])
def test_shade_step_matches_jax(case, scan_in_kernel):
    static = case["static"]
    depth, (carry_f, carry_u, carry_i, mesh_f, mesh_i), un = \
        _step_inputs(case, scan_in_kernel)
    before = mk.launches_shade
    got = mk.shade_step(static, depth, MAX_DEPTH, RR_START, case["prims"],
                        carry_f, carry_u, carry_i, case["spect"], mesh_f,
                        mesh_i, *un)
    assert mk.launches_shade == before
    step = jmk.build_shade_step(case["jstatic"], MAX_DEPTH, RR_START,
                                tile_m=TILE_M, interpret=True,
                                scan_in_kernel=scan_in_kernel)
    want = jax.block_until_ready(step(
        jnp.full((1, 1), depth, jnp.int32), case["jprims"],
        _planes(carry_f.numpy()), _planes(carry_u.numpy().view(np.uint32)),
        _planes(carry_i.numpy()), _planes(case["spect"].numpy()),
        _planes(mesh_f.numpy()), _planes(mesh_i.numpy()),
        *(_planes(x.numpy()) for x in un)))
    want = [_np(x) for x in want]
    got = [x.numpy() for x in got]
    cf, cu, ci, t_idx, sh_f, sh_i, un_f, un_i = got
    alive_in = carry_i[3].numpy() != 0
    alive = ci[3] != 0
    assert alive_in.all() if depth == 0 else not alive_in.all()
    assert alive.any() and not alive.all()
    # integer planes wherever the port writes a value; seed words
    np.testing.assert_array_equal(cu.view(np.uint32), want[1])
    np.testing.assert_array_equal(ci, want[2])
    np.testing.assert_array_equal(t_idx[alive_in], want[3][alive_in])
    np.testing.assert_array_equal(t_idx[~alive_in], -1)
    lsel = sh_i[1] != 0
    np.testing.assert_array_equal(sh_i[1], want[5][1])
    np.testing.assert_array_equal(sh_i[0][lsel], want[5][0][lsel])
    np.testing.assert_array_equal(sh_i[0][~lsel], -1)
    np.testing.assert_array_equal(un_i[0][alive], want[7][0][alive])
    np.testing.assert_array_equal(un_i[0][~alive], -1)
    assert lsel.any() and _in_part(static, torch.from_numpy(t_idx)).any()
    # float planes on the same lanes
    assert _frac_close(cf, want[0], slice(None)) >= 0.999
    hit = alive_in & (t_idx >= 0)
    assert _frac_close(sh_f[:3], want[4][:3], hit) >= 0.999
    assert _frac_close(sh_f[3:], want[4][3:], lsel) >= 0.999
    un_hit = un_i[0] >= 0
    assert _frac_close(un_f, want[6], un_hit) >= 0.999
    assert np.isinf(un_f[0][~un_hit]).all()
    assert np.isinf(want[6][0][alive & ~un_hit]).all()


def _two_lights(doc):
    """A second light patch on the left wall, after the six Cornell
    patches."""
    light = doc["objects"]["patches"][2]
    doc["objects"]["patches"].append(dict(
        light, origin=[1.0, 150.0, 200.0], edge1=[0.0, 0.0, 120.0],
        edge2=[0.0, 120.0, 0.0]))
    return doc


def _path_case(lights, w=64, h=32):
    doc = presets.mesh_scene(w, h, 2)
    if lights == 2:
        doc = _two_lights(doc)
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    assert len(static.light_rows) == lights and static.mesh_parts
    planes = kt.camera_planes(scene, w, h, *kt.tile_coords(w, h, 0), 1)
    return scene, static, planes


def _launch_counts():
    return (mk.launches_mesh, mk.launches_shade, bn.launches_walk,
            bn.launches_candidates, bn.launches_pair, bn.launches_pair_occl)


@pytest.mark.parametrize("lights", [1, 2])
def test_wavefront_radiance_is_in_kernel(lights):
    scene, static, planes = _path_case(lights)
    before = _launch_counts()
    got, want = (kt.trace_radiance(scene, *planes, MAX_DEPTH, static=static,
                                   backward="none", wavefront=wf)
                 for wf in (True, False))
    assert _launch_counts() == before
    assert torch.isfinite(got).all() and (got != 0).any()
    assert torch.equal(got, want)


def test_wavefront_batched_casts_are_in_kernel():
    """8,192 rays: a cast with at most 2,048 live rays is compacted and
    cast in batches of 1,024; the two lights' shadow casts take two."""
    scene, static, planes = _path_case(2, 128, 64)
    bn.cast_log = log = []
    try:
        got = kt.trace_radiance(scene, *planes, MAX_DEPTH, static=static,
                                backward="none", wavefront=True)
    finally:
        bn.cast_log = None
    want = kt.trace_radiance(scene, *planes, MAX_DEPTH, static=static,
                             backward="none", wavefront=False)
    assert torch.equal(got, want)
    batches = [e["batches"] for e in log if "cast" in e]
    assert 0 in batches and max(batches) >= 2
    kinds = {e["cast"] for e in log if "cast" in e and e["batches"]}
    assert kinds == {"closest", "any"}


@pytest.mark.parametrize("lights", [1, 2])
def test_wavefront_tapes_are_forward_winners(lights):
    scene, static, planes = _path_case(lights)
    args = kt.kernel_inputs(scene, *planes, static)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    got = kt.wavefront_forward(static, MAX_DEPTH, RR_START, *args, *arrays,
                               taped=True)
    want = mk.forward_winners_reference(static, MAX_DEPTH, RR_START, *args,
                                        *arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tape_idx, tape_sh = got[1:]
    assert tape_sh.shape == (MAX_DEPTH + 1, lights, 64 * 32)
    assert _in_part(static, tape_idx).any()
    assert all((tape_sh[:, l] >= 0).any() for l in range(lights))


def test_wavefront_gradients_are_in_kernel():
    w, h = 32, 16
    scene, _ = scene_from_dict(presets.mesh_scene(w, h, 1), device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=MESH_MIN)
    plans = tuple(meshpack.plan_scene_mesh(scene, part)
                  for part in static.mesh_parts)

    def grads(wavefront):
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        sp = scene.spectra.clone().requires_grad_(True)
        s = dataclasses.replace(scene, spectra=sp, primitives=dataclasses
                                .replace(scene.primitives, data1=d1))
        img = kt.render_sample(s, w, h, 1, 2, static=static,
                               mesh_plans=plans, wavefront=wavefront)
        return torch.autograd.grad((img ** 2).sum(), (d1, sp))

    got, want = grads(True), grads(False)
    for g, wnt in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, wnt)
    assert (got[0][6:] != 0).any()  # the mesh part's vertices


def test_wavefront_routing(monkeypatch):
    scene, static, planes = _path_case(1)
    calls = []
    wavefront_forward = kt.wavefront_forward

    def recorded(*args, taped=False, **kw):
        calls.append(taped)
        return wavefront_forward(*args, taped=taped, **kw)

    monkeypatch.setattr(kt, "wavefront_forward", recorded)
    o, d, hero, seed = planes
    want = kt.trace_radiance(scene, *planes, 2, static=static,
                             backward="none", wavefront=False)
    for backward, grad, taped in (("pallas", True, True),
                                  ("pallas_taped", True, True),
                                  ("replay", True, True),
                                  ("none", True, False),
                                  ("pallas", False, False),
                                  ("replay", False, False)):
        calls.clear()
        od = o.clone().requires_grad_(True)
        with torch.set_grad_enabled(grad):
            out = kt.trace_radiance(scene, od, d, hero, seed, 2,
                                    static=static, backward=backward,
                                    wavefront=True)
        assert calls == [taped], (backward, grad)
        assert out.requires_grad == taped
        assert torch.equal(out.detach(), want)
    calls.clear()
    # wavefront=None resolves to the in-kernel default
    kt.trace_radiance(scene, *planes, 2, static=static, backward="none")
    assert calls == [] and kt.MESH_WAVEFRONT_DEFAULT is False
    # backward="xla" recomputes from pixel coordinates, which the planar
    # trace does not take
    with pytest.raises(ValueError, match="eager"):
        kt.trace_radiance(scene, *planes, 2, static=static, backward="xla",
                          wavefront=True)


@pytest.mark.parametrize("bad", ["un_f_alone", "depth", "carry_u_dtype",
                                 "mesh_i_shape", "walk_work_on_cpu",
                                 "walk_no_parts", "walk_seed_dtype"])
def test_wavefront_wrappers_check(case, bad):
    static = case["static"]
    carry_f, carry_u, carry_i, mesh_f, mesh_i = _bounce0(case)
    depth, un = 0, ()
    if bad == "un_f_alone":
        un = (mesh_f,)
    elif bad == "depth":
        depth = MAX_DEPTH + 1
    elif bad == "carry_u_dtype":
        carry_u = carry_u.to(torch.int64)
    elif bad == "mesh_i_shape":
        mesh_i = mesh_i[0]
    if bad.startswith("walk"):
        seed_f = torch.zeros((4, R))
        seed_i = torch.full((2, R), -1, dtype=torch.int32)
        kw = {}
        if bad == "walk_work_on_cpu":
            kw["work"] = torch.zeros(mk.WORK_KINDS, dtype=torch.int64)
        elif bad == "walk_no_parts":
            static = dataclasses.replace(static, mesh_parts=())
        else:
            seed_i = seed_i.to(torch.int64)
        with pytest.raises(ValueError):
            bn.walk(static, case["rays"], seed_f, seed_i,
                    *(() if bad == "walk_no_parts" else case["arrays"]),
                    **kw)
        return
    with pytest.raises(ValueError):
        mk.shade_step(static, depth, MAX_DEPTH, RR_START, case["prims"],
                      carry_f, carry_u, carry_i, case["spect"], mesh_f,
                      mesh_i, *un)
