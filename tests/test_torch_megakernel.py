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

The kernel itself is held against forward_reference on the card in
tests/test_torch_cuda.py, which imports no jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import scene_from_jax

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
    sample = np.uint32(3)
    c = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, W, H,
                                      px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    spect = np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)]
    return {
        "scene": js,
        "prims": np.asarray(jmk.pack_prims(jdata.as_jax(js))),
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
    static, prims, rays, seeds, spect = _torch_inputs(case)
    cats = list(static.categories)
    cats[0] = 2
    tri = mk.SceneStatic(**{**static.__dict__, "categories": tuple(cats)})
    with pytest.raises(NotImplementedError, match="mesh slice"):
        mk.forward(tri, MAX_DEPTH, RR_START, prims, rays, seeds, spect)
    with pytest.raises(NotImplementedError, match="mesh slice"):
        mk.forward(static, MAX_DEPTH, RR_START, prims, rays, seeds, spect,
                   torch.zeros(16, 128))
    meshy = mk.SceneStatic(**{**static.__dict__, "mesh_parts": ((0, 3),)})
    with pytest.raises(NotImplementedError, match="mesh slice"):
        mk.forward(meshy, MAX_DEPTH, RR_START, prims, rays, seeds, spect)


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
