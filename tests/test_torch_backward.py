"""Backward megakernel of the PyTorch port vs the JAX package's.

``backward_reference`` (autograd of ``forward_reference``, which the
``backward`` wrapper runs for CPU tensors) is held against
``build_backward`` in Pallas interpret mode on identical primitives,
rays, seeds, per-ray spectra and radiance cotangents: ``simple_scene``
and a variant whose sphere is glass (refraction, Fresnel, Beer-Lambert).
Cornell's backward is held against the plain version on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py``): tracing its 18
unrolled primitives in interpret mode takes minutes.

A ray whose forward radiance differs between the two frameworks by more
than rel 1e-4 took another path after a flipped sampling decision
(exp/sin/cos differ by an ulp); it gets dL = 0 on both sides. On the
rest: d_prims within rtol 1e-3 / atol 1e-4 of its largest entry (the
tolerances of tests/test_pallas.py), d_rays and d_spect within rel 1e-3
(denominator floored at 1e-3 of the plane's largest magnitude).
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

W = H = 32
R = 256
MAX_DEPTH = 3
RR_START = 1


def _doc(variant):
    doc = jpresets.simple_scene(W, H)
    if variant == "glass":
        doc["objects"]["spheres"][0]["type"] = "glass"
    return doc


def _case(variant):
    """Kernel inputs for R random pixels built with the JAX package's own
    ray generation and hero gather, the JAX forward and backward in
    interpret mode, and dL (zeroed on rays whose paths differ)."""
    js, _ = jax_scene_from_dict(_doc(variant))
    g = np.random.default_rng(0)
    px = g.integers(0, W, R).astype(np.uint32)
    py = g.integers(0, H, R).astype(np.uint32)
    sample = np.uint32(3)
    c = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, W, H,
                                      px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    spect = np.ascontiguousarray(np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)])
    inp = {
        "scene": js,
        "prims": np.asarray(jmk.pack_prims(jdata.as_jax(js))),
        "rays": np.asarray(jnp.concatenate([o, d], axis=0)),
        "seeds": np.asarray(seed_p),
        "spect": spect,
        "dL": g.standard_normal((4, R)).astype(np.float32),
    }
    static = jmk.SceneStatic.from_scene(js)
    m = R // jmk.LANES

    def planes(x):
        return jnp.asarray(x).reshape(x.shape[0], m, jmk.LANES)

    ops = [jnp.asarray(inp["prims"])] + [
        planes(inp[k]) for k in ("rays", "seeds", "spect")]
    fwd = jmk.build_forward(static, MAX_DEPTH, RR_START, tile_m=2,
                            interpret=True)
    rad_jax = np.asarray(jax.block_until_ready(fwd(*ops))).reshape(4, R)
    static_t, *tin = _torch_inputs(inp)
    rad_port = mk.forward_reference(static_t, MAX_DEPTH, RR_START,
                                    *tin).numpy()
    rel = np.abs(rad_port - rad_jax) / np.maximum(np.abs(rad_jax), 1e-6)
    inp["same_path"] = (rel <= 1e-4).all(axis=0)
    inp["dL"][:, ~inp["same_path"]] = 0.0
    bwd = jmk.build_backward(static, MAX_DEPTH, RR_START, tile_m=2,
                             interpret=True)
    dp, dr, ds = jax.block_until_ready(bwd(*ops, planes(inp["dL"])))
    inp["want"] = (np.asarray(dp), np.asarray(dr).reshape(6, R),
                   np.asarray(ds).reshape(-1, R))
    return inp


@pytest.fixture(scope="module")
def simple_case():
    return _case("simple")


@pytest.fixture(scope="module")
def glass_case():
    return _case("glass")


def _torch_inputs(inp):
    scene = scene_from_jax(inp["scene"])
    return (mk.SceneStatic.from_scene(scene),
            torch.from_numpy(inp["prims"].copy()),
            torch.from_numpy(inp["rays"].copy()),
            torch.from_numpy(inp["seeds"].astype(np.int64)),
            torch.from_numpy(inp["spect"].copy()))


@pytest.mark.parametrize("variant", ["simple", "glass"])
def test_backward_reference_matches_pallas(request, variant):
    case = request.getfixturevalue(f"{variant}_case")
    assert case["same_path"].mean() >= 0.99
    static, *tin = _torch_inputs(case)
    got = [x.numpy() for x in mk.backward_reference(
        static, MAX_DEPTH, RR_START, *tin, torch.from_numpy(case["dL"]))]
    want = case["want"]
    for g in got:
        assert np.isfinite(g).all()
    scale = np.abs(want[0]).max()
    assert scale > 0
    np.testing.assert_allclose(got[0] / scale, want[0] / scale, rtol=1e-3,
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        den = np.maximum(np.abs(w), 1e-3 * np.abs(w).max())
        assert (np.abs(g - w) / den).max() < 1e-3
    if variant == "glass":
        # Beer-Lambert reached the extinction row (the last spectrum)
        assert np.abs(got[2][-4:]).max() > 0


def test_tracefn_cpu_returns_backward_reference(simple_case):
    static, prims, rays, seeds, spect = _torch_inputs(simple_case)
    dL = torch.from_numpy(simple_case["dL"])
    leaves = [x.clone().requires_grad_(True) for x in (prims, rays, spect)]
    out = mk.TraceFn.apply(static, MAX_DEPTH, RR_START, leaves[0], leaves[1],
                           seeds, leaves[2])
    assert torch.equal(out.detach(), mk.forward_reference(
        static, MAX_DEPTH, RR_START, prims, rays, seeds, spect))
    out.backward(dL)
    want = mk.backward_reference(static, MAX_DEPTH, RR_START, prims, rays,
                                 seeds, spect, dL)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_tracefn_without_grad_is_the_forward(simple_case):
    static, prims, rays, seeds, spect = _torch_inputs(simple_case)
    out = mk.TraceFn.apply(static, MAX_DEPTH, RR_START, prims, rays, seeds,
                           spect)
    assert not out.requires_grad
    assert torch.equal(out, mk.forward(static, MAX_DEPTH, RR_START, prims,
                                       rays, seeds, spect))


def test_cpu_backward_launches_no_kernel(simple_case):
    static, *tin = _torch_inputs(simple_case)
    before = mk.launches, mk.launches_bwd
    got = mk.backward(static, MAX_DEPTH, RR_START, *tin,
                      torch.from_numpy(simple_case["dL"]))
    assert (mk.launches, mk.launches_bwd) == before
    want = mk.backward_reference(static, MAX_DEPTH, RR_START, *tin,
                                 torch.from_numpy(simple_case["dL"]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ray_chunk_bands_match_one_band(simple_case):
    """Per-ray cotangents do not depend on the band; d_prims sums the
    bands in order, so it agrees to rounding."""
    static, *tin = _torch_inputs(simple_case)
    dL = torch.from_numpy(simple_case["dL"])
    whole = mk.backward_reference(static, MAX_DEPTH, RR_START, *tin, dL)
    banded = mk.backward_reference(static, MAX_DEPTH, RR_START, *tin, dL,
                                   ray_chunk=100)
    assert torch.equal(whole[1], banded[1])
    assert torch.equal(whole[2], banded[2])
    torch.testing.assert_close(banded[0], whole[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["seeds_dtype", "rays_shape", "spect_rows",
                                 "noncontiguous", "dL_shape", "dL_dtype",
                                 "dL_noncontiguous"])
def test_backward_wrapper_checks_inputs(simple_case, bad):
    static, prims, rays, seeds, spect = _torch_inputs(simple_case)
    dL = torch.from_numpy(simple_case["dL"])
    if bad == "seeds_dtype":
        seeds = seeds.to(torch.int32)
    elif bad == "rays_shape":
        rays = rays[:5]
    elif bad == "spect_rows":
        spect = spect[:-4]
    elif bad == "noncontiguous":
        rays = rays.t().contiguous().t()
    elif bad == "dL_shape":
        dL = dL[:3]
    elif bad == "dL_dtype":
        dL = dL.double()
    else:
        dL = dL.t().contiguous().t()
    with pytest.raises(ValueError):
        mk.backward(static, MAX_DEPTH, RR_START, prims, rays, seeds, spect,
                    dL)


def test_backward_wrapper_raises_on_triangles(simple_case):
    """Triangle rows are differentiated (on the CPU by the plain version);
    a mesh part raises: its gradient is the guided replay's."""
    static, *tin = _torch_inputs(simple_case)
    dL = torch.from_numpy(simple_case["dL"])
    cats = list(static.categories)
    cats[0] = 2
    tri = mk.SceneStatic(**{**static.__dict__, "categories": tuple(cats)})
    got = mk.backward(tri, MAX_DEPTH, RR_START, *tin, dL)
    want = mk.backward_reference(tri, MAX_DEPTH, RR_START, *tin, dL)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)
    part = mk.MeshPart(start=0, count=1, n_chunks=1, material=0,
                       emission_idx=0, reflectance_idx=0)
    meshy = mk.SceneStatic(**{**static.__dict__, "mesh_parts": (part,)})
    with pytest.raises(NotImplementedError, match="guided replay"):
        mk.backward(meshy, MAX_DEPTH, RR_START, *tin, dL)
