"""Forward megakernel of the PyTorch port vs the JAX package's.

``forward_reference`` (the plain torch version, which the wrapper runs
for CPU tensors) is held against ``build_forward`` in Pallas interpret
mode on identical primitives, rays, seeds and per-ray spectra: Cornell
box camera rays, a share of them aimed at the ceiling so that some see
the area light directly.

Exact equality is not asked for: XLA may fuse multiply-adds into FMAs
on the CPU, and exp, sin and cos differ by an ulp between the two
frameworks, so a rare sampling decision (Russian roulette, a Fresnel
choice) can flip and send one path elsewhere. What must hold:
- at least 99% of rays within rel 1e-4 (denominator floored at 1e-2);
- the mean radiance within 1e-3 relative;
- every ray whose JAX radiance is a direct light hit is one in the port
  too. The ceiling light is coplanar with the ceiling and visible only
  through the last-hit-wins tie; a flipped tie would be systematic, not
  noise.

The same rule holds forward_reference on a scene of more unrolled rows
than the CUDA kernels' shared tables take: 317 rows of the final scene
of *Ray Tracing: The Next Week* (scripts/make_rtnw_final.py at a smaller
count), against the JAX kernel's bounce (``make_bounce``, the body of
``build_forward``'s depth loop) run op by op on the same planes. Pallas
interpret mode would compile that 317-row unrolled scan for minutes and
in more than 10 GB. Its sibling writes the ground as one mesh part of
432 triangles beside 307 rows: the part's chunk BVH walk after the
blocked scan, over a heightfield whose boxes share faces and whose split
quads share diagonals. Both also hold the first bounce's winners, of
camera and shadow rays, equal on every ray: which primitive a ray met
shows there even where the image could not tell.

The kernel itself is held against forward_reference on the card in
tests/test_torch_cuda.py, which imports no jax.
"""

import importlib.util
import pathlib

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
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 64
R = 1024
MAX_DEPTH = 4
RR_START = 1
LIGHT_SPECTRUM = 3  # "light" in the Cornell spectra


def _inputs(seed=0):
    """Kernel inputs for R camera rays of a W x H Cornell film, built with
    the JAX package's own ray generation and hero gather."""
    js, _ = jax_scene_from_dict(jpresets.cornell_box(W, H))
    g = np.random.default_rng(seed)
    px = g.integers(0, W, R).astype(np.uint32)
    py = g.integers(0, H, R).astype(np.uint32)
    # a quarter of the rays in the top rows, around the light
    py[: R // 4] = g.integers(0, H // 6, R // 4)
    px[: R // 4] = g.integers(W // 3, 2 * W // 3, R // 4)
    return _camera_inputs(js, px, py, W, H)


def _camera_inputs(js, px, py, w, h, static=None):
    """Kernel inputs for the camera rays of pixels (px, py) of a w x h
    film of the JAX scene js, at sample 3; prims holds the unrolled rows
    of static when it has mesh parts."""
    sample = np.uint32(3)
    c = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, w, h,
                                      px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    spect = np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)]
    return {
        "scene": js,
        "prims": np.asarray(jmk.pack_prims(jdata.as_jax(js), static)),
        "rays": np.asarray(jnp.concatenate([o, d], axis=0)),
        "seeds": np.asarray(seed_p),
        "spect": np.ascontiguousarray(spect),
    }


@pytest.fixture(scope="module")
def case():
    inp = _inputs()
    static = jmk.SceneStatic.from_scene(inp["scene"])
    fwd = jmk.build_forward(static, MAX_DEPTH, RR_START, tile_m=8,
                            interpret=True)
    m = R // jmk.LANES
    want = fwd(jnp.asarray(inp["prims"]),
               jnp.asarray(inp["rays"]).reshape(6, m, jmk.LANES),
               jnp.asarray(inp["seeds"]).reshape(4, m, jmk.LANES),
               jnp.asarray(inp["spect"]).reshape(-1, m, jmk.LANES))
    inp["want"] = np.asarray(jax.block_until_ready(want)).reshape(4, R)
    return inp


def _torch_inputs(inp, device="cpu"):
    scene = scene_from_jax(inp["scene"], device)
    return (mk.SceneStatic.from_scene(scene),
            torch.from_numpy(inp["prims"].copy()).to(device),
            torch.from_numpy(inp["rays"].copy()).to(device),
            torch.from_numpy(inp["seeds"].astype(np.int64)).to(device),
            torch.from_numpy(inp["spect"].copy()).to(device))


def _agreement(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    return (rel < 1e-4).all(axis=0).mean(), rel.max()


def test_forward_reference_matches_pallas(case):
    static, prims, rays, seeds, spect = _torch_inputs(case)
    got = mk.forward_reference(static, MAX_DEPTH, RR_START, prims, rays,
                               seeds, spect).numpy()
    want = case["want"]
    assert got.shape == (4, R) and np.isfinite(got).all()
    frac, worst = _agreement(got, want)
    assert frac >= 0.99, f"only {frac:.4f} of rays match (worst {worst:.3g})"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    light = case["spect"][LIGHT_SPECTRUM * 4:LIGHT_SPECTRUM * 4 + 4]
    direct = (want == light).all(axis=0)
    assert direct.sum() >= 8, "too few direct light hits to test the tie"
    assert ((got == light).all(axis=0) | ~direct).all()


def _rtnw_generator():
    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "make_rtnw_final.py")
    spec = importlib.util.spec_from_file_location("make_rtnw_final", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh_reads(pack):
    """_scan_mesh_part's reads over plain arrays of one part's pack: the
    row, box and meta reads of megakernel._make_accessors, as slices."""
    tri, cbox, nbox, nmeta = (jnp.asarray(a) for a in pack.arrays)
    rpc = jmeshpack.ROWS_PER_CHUNK
    row = lambda a, i: jax.lax.dynamic_slice_in_dim(a, i, 1)
    return (lambda k: (lambda rr: row(tri, k * rpc + rr)),
            lambda k: row(cbox, k), lambda nn: row(nbox, nn),
            lambda nn: row(nmeta, nn), nmeta.shape[0])


def _holds_past_the_shared_tables(doc, side):
    """forward_reference against the JAX kernel's bounce on every pixel of
    a side x side film of doc, on identical prims, rays, seeds and
    spectra, under the rule above; the mesh parts' scans read the JAX
    package's packs, the port's its own. The first bounce's winners, of
    the camera rays and of the shadow rays the port casts, are the JAX
    kernel's on every ray. Returns the JAX static and the JAX kernel's
    first hit of each camera ray."""
    js, _ = jax_scene_from_dict(doc)
    static = jmk.SceneStatic.from_scene(js)
    px = np.tile(np.arange(side, dtype=np.uint32), side)
    py = np.repeat(np.arange(side, dtype=np.uint32), side)
    inp = _camera_inputs(js, px, py, side, side, static)
    n = side * side
    # the parts reach the bounce through their accessors alone: with them
    # in its static, the kernel skips a shadow scan no ray chose under a
    # lax.cond, whose one XLA program would compile every unrolled row (a
    # skipped scan adds exactly 0, so the image is the same). barrier: the
    # parts' traversal loops are compiled by XLA
    bounce = jmk.make_bounce(static._replace(mesh_parts=()), (n,),
                             MAX_DEPTH, RR_START,
                             barrier=bool(static.mesh_parts))
    accessors = tuple((part, _mesh_reads(pack)) for part, pack in zip(
        static.mesh_parts, jax_pallas.mesh_packs_for(js, static)))
    prims, spect = jnp.asarray(inp["prims"]), jnp.asarray(inp["spect"])
    diff, nondiff = jmk._init_carry(jnp.asarray(inp["rays"])[:, None],
                                    jnp.asarray(inp["seeds"])[:, None],
                                    (1, n))
    diff, (seed, exclude, *flags) = jax.tree_util.tree_map(
        lambda x: x[0], (diff, nondiff))
    nondiff = (seed, exclude, *(f != 0 for f in flags))
    first = None
    for depth in range(MAX_DEPTH + 1):
        diff, nondiff, aux = bounce(
            lambda i, j: prims[i, j],
            lambda row: tuple(spect[row * 4 + j] for j in range(4)),
            diff, nondiff, depth, accessors)
        first = first or (np.asarray(aux[0]), np.asarray(aux[1][0]))
    want = np.stack([np.asarray(x) for x in diff[2]])
    scene = scene_from_jax(js, "cpu")
    tstatic = mk.SceneStatic.from_scene(scene)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, tstatic)
                   for a in p.arrays)
    _, *tin = _torch_inputs(inp)
    got = mk.forward_reference(tstatic, MAX_DEPTH, RR_START, *tin,
                               *arrays).numpy()
    _, tape_idx, tape_sh = mk.forward_winners_reference(
        tstatic, MAX_DEPTH, RR_START, *tin, *arrays)
    # the first bounce's winners, camera and shadow rays: no sampling
    # decision that an ulp could flip comes before them
    assert (tape_idx[0].numpy() == first[0]).all()
    sh = tape_sh[0, 0].numpy()
    assert ((sh == first[1]) | (sh == -1)).all() and (sh != -1).sum() >= 64
    assert got.shape == (4, n) and np.isfinite(got).all()
    frac, worst = _agreement(got, want)
    assert frac >= 0.99, f"only {frac:.4f} of rays match (worst {worst:.3g})"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    k = list(doc["spectra"]).index("light")
    light = inp["spect"][k * 4:k * 4 + 4]
    direct = (want == light).all(axis=0)
    assert direct.sum() >= 8, "too few direct light hits to test the tie"
    assert ((got == light).all(axis=0) | ~direct).all()
    return static, first[0]


def test_forward_reference_matches_pallas_past_the_shared_tables():
    """317 unrolled rows (6 x 6 ground boxes, the light, 100 spheres), every
    pixel of a 32 x 32 film."""
    side = 32
    static, _ = _holds_past_the_shared_tables(_rtnw_generator().final_scene(
        boxes_per_side=6, n_spheres=94, width=side, height=side), side)
    assert len(static.rows) == 317 > mk.MAX_PRIMS and not static.mesh_parts


def test_forward_reference_matches_pallas_past_the_shared_tables_with_a_mesh():
    """307 unrolled rows (the light, 306 spheres) and the 6 x 6 ground
    boxes as one mesh part of 432 triangles, every pixel of a 32 x 32
    film: the part's hits after the blocked rows' scan as the JAX
    kernel's, a fifth of the camera rays on the ground."""
    side = 32
    static, first = _holds_past_the_shared_tables(
        _rtnw_generator().final_scene(boxes_per_side=6, n_spheres=300,
                                      width=side, height=side,
                                      ground_mesh=True), side)
    assert len(static.rows) == 307 > mk.MAX_PRIMS
    (part,) = static.mesh_parts
    assert part.count == 432
    on_ground = (first >= part.start) & (first < part.start + part.count)
    assert on_ground.mean() >= 0.1, "too few camera rays meet the ground"


def test_cpu_wrapper_runs_reference(case):
    static, prims, rays, seeds, spect = _torch_inputs(case)
    before = mk.launches
    got = mk.forward(static, MAX_DEPTH, RR_START, prims, rays, seeds, spect)
    want = mk.forward_reference(static, MAX_DEPTH, RR_START, prims, rays,
                                seeds, spect)
    assert torch.equal(got, want)
    assert mk.launches == before  # CPU calls launch no kernel


def test_depth_zero_is_emission_only(case):
    """max_depth=0: a camera ray returns the light's emission if it hits
    the light and 0 otherwise (no scattering, no NEE)."""
    static, prims, rays, seeds, spect = _torch_inputs(case)
    got = mk.forward_reference(static, 0, RR_START, prims, rays, seeds,
                               spect)
    light = spect[LIGHT_SPECTRUM * 4:LIGHT_SPECTRUM * 4 + 4]
    hit_light = (got == light).all(dim=0)
    assert hit_light.any()
    assert (got[:, ~hit_light] == 0).all()


def test_wrapper_raises_on_triangles_and_mesh_parts(case):
    """The forward takes triangle rows and mesh parts (their mode is held
    in tests/test_torch_mesh.py); mesh arrays that do not fit the
    static's mesh parts raise. TraceFn differentiates triangle rows and
    raises for mesh parts, whose gradients are the guided replay's."""
    static, prims, rays, seeds, spect = _torch_inputs(case)
    cats = list(static.categories)
    cats[0] = 2
    tri = mk.SceneStatic(**{**static.__dict__, "categories": tuple(cats)})
    assert tri.mesh_mode and not static.mesh_mode
    assert torch.isfinite(mk.forward(tri, 1, RR_START, prims, rays, seeds,
                                     spect)).all()
    with pytest.raises(ValueError, match="mesh arrays"):
        mk.forward(static, MAX_DEPTH, RR_START, prims, rays, seeds, spect,
                   torch.zeros(16, 128))
    part = mk.MeshPart(start=0, count=3, n_chunks=1, material=0,
                       emission_idx=0, reflectance_idx=0)
    meshy = mk.SceneStatic(**{**static.__dict__, "mesh_parts": (part,)})
    with pytest.raises(ValueError, match="mesh arrays"):
        mk.forward(meshy, MAX_DEPTH, RR_START, prims, rays, seeds, spect)
    leaf = prims.clone().requires_grad_(True)
    out = mk.TraceFn.apply(tri, MAX_DEPTH, RR_START, leaf, rays, seeds, spect)
    out.sum().backward()
    assert torch.isfinite(leaf.grad).all()
    with pytest.raises(NotImplementedError, match="guided replay"):
        mk.TraceFn.apply(meshy, MAX_DEPTH, RR_START, prims, rays, seeds,
                         spect)


@pytest.mark.parametrize("bad", ["seeds_dtype", "rays_shape",
                                 "spect_rows", "noncontiguous"])
def test_wrapper_checks_inputs(case, bad):
    static, prims, rays, seeds, spect = _torch_inputs(case)
    if bad == "seeds_dtype":
        seeds = seeds.to(torch.int32)
    elif bad == "rays_shape":
        rays = rays[:5]
    elif bad == "spect_rows":
        spect = spect[:-4]
    else:
        rays = rays.t().contiguous().t()
    with pytest.raises(ValueError):
        mk.forward(static, MAX_DEPTH, RR_START, prims, rays, seeds, spect)
