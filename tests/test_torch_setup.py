"""The per-sample setup of the port's kernel path vs the JAX package's.

``kernels.setup.ray_setup`` (its plain version, which the wrapper runs
for pixels on the CPU, and ``tracer.kernel.camera_planes`` through it)
against the JAX composition ``rng.seed_pixel_p`` ->
``camera.camera_rays_p`` -> ``spectrum.sample_wavelengths_p``
(tracer/pallas.py:708-712): bit for bit on o, d, hero and the seeds.

``ops.spectrum.HeroGatherFn`` (``gather_hero``): its forward bit-equal to
the JAX ``gather_hero_planar``; its backward, the fixed-order column sums
of ``setup.hero_column_sums``, against ``jax.vjp`` of ``gather_hero_planar``
and of ``take_cols`` (a one-hot contraction, summed in another order:
rtol 1e-5, atol 1e-6), against a float64 column sum, bit-equal across
runs and at small block sizes, against an explicit loop in its stated
order. Then a value_and_grad by spectra through ``render_pixels_planar``
against the JAX package's (``backward="pallas"``, interpret mode) at
the tolerances of tests/test_torch_train.py, on ``simple_scene``: the
Cornell box's 18 primitives take the interpret-mode backward kernel over
two minutes, past this file's budget.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

FILM = (37, 29)
BAND = (11, 5)  # rows, first row
K, N_COLS = 24, 301


@pytest.mark.parametrize("sample", [1, 17, 2**32 - 3])
def test_ray_setup_matches_jax_composition(sample):
    w, h = FILM
    js, _ = jax_scene_from_dict(jpresets.cornell_box(w, h))
    c = jdata.as_jax(js).camera
    px, py = kt.tile_coords(w, BAND[0], BAND[1])
    pxu, pyu = px.numpy().astype(np.uint32), py.numpy().astype(np.uint32)
    sample_u = jnp.uint32(sample)
    seed = jrng.seed_pixel_p(pxu, pyu, sample_u)
    o, d, seed = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, w, h, pxu,
                                    pyu, sample_u, seed)
    hero, seed = jspec.sample_wavelengths_p(seed)
    want = [np.asarray(x) for x in (o, d, hero, seed)]
    scene = scene_from_jax(js)
    got = setup_k.ray_setup(scene.camera, w, h, px, py, sample)
    planes = kt.camera_planes(scene, w, h, px, py, sample)
    for name, g, p, x in zip(("o", "d", "hero", "seed"), got, planes, want):
        assert torch.equal(g, p), name
        np.testing.assert_array_equal(g.numpy(), x.astype(g.numpy().dtype),
                                      err_msg=name)
    assert got[2].dtype == got[3].dtype == torch.int64


def _gather_case(R, seed=0, decades=0.0):
    """A (24, 301) table, hero (R,) covering 0 and 300, and g (24, R),
    normal or, with decades, spread over 2 * decades decades (so that a
    change of summation order shows in the last bits)."""
    g = np.random.default_rng(seed)
    table = g.standard_normal((K, N_COLS)).astype(np.float32)
    hero = g.integers(0, N_COLS, R)
    hero[:3] = (0, 300, 300)
    hero[-1] = 0
    cot = (g.standard_normal((K, R))
           * 10.0 ** g.uniform(-decades, decades, (K, R))).astype(np.float32)
    return table, hero, cot


def _port_vjp(table, hero, cot):
    t = torch.from_numpy(table).requires_grad_(True)
    out = spec.gather_hero(t, torch.from_numpy(hero))
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("R", [4096, 4097])
def test_hero_gather_matches_jax(R):
    table, hero, cot = _gather_case(R)
    fwd, grad = _port_vjp(table, hero, cot)
    hero_j = jnp.asarray(hero, jnp.int32)
    want_fwd, vjp = jax.vjp(lambda t: jspec.gather_hero_planar(t, hero_j),
                            jnp.asarray(table))
    np.testing.assert_array_equal(fwd, np.asarray(want_fwd))
    (want_planar,) = vjp(jnp.asarray(cot))
    _, vjp_cols = jax.vjp(lambda t: jspec.take_cols(t, hero_j),
                          jnp.asarray(table))
    (want_cols,) = vjp_cols(jnp.asarray(cot))
    for want in (want_planar, want_cols):
        np.testing.assert_allclose(grad, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    exact = np.zeros((K, N_COLS))
    np.add.at(exact.T, hero, cot.T.astype(np.float64))
    rel_l2 = np.linalg.norm(grad - exact) / np.linalg.norm(exact)
    assert rel_l2 <= 1e-6, rel_l2
    assert (grad[:, 0] != 0).all() and (grad[:, 300] != 0).all()


def test_hero_gather_backward_bit_equal_across_runs():
    table, hero, cot = _gather_case(4097, seed=1, decades=3)
    first = _port_vjp(table, hero, cot)[1]
    second = _port_vjp(table, hero, cot)[1]
    np.testing.assert_array_equal(first, second)


def _loop_column_sums(g, hero, n_cols, block):
    """The stated order, one ray at a time: within each block in ray
    order, then the blocks' partials in block order (float32 throughout)."""
    out = torch.zeros((g.shape[0], n_cols))
    for b0 in range(0, g.shape[1], block):
        part = torch.zeros_like(out)
        for r in range(b0, min(b0 + block, g.shape[1])):
            part[:, hero[r]] = part[:, hero[r]] + g[:, r]
        out = out + part
    return out


@pytest.mark.parametrize("block", [1, 7, 64, setup_k.HERO_BLOCK])
def test_column_sums_fixed_order(block):
    _, hero, cot = _gather_case(301, seed=2, decades=3)
    hero = torch.from_numpy(hero % 9)  # many duplicates per column
    g = torch.from_numpy(cot)
    got = setup_k.hero_column_sums_reference(g, hero, 11, block)
    assert torch.equal(got, _loop_column_sums(g, hero, 11, block))
    assert torch.equal(got, setup_k.hero_column_sums_reference(g, hero, 11,
                                                               block))
    assert not got[:, 9:].any()


def test_gather_backward_follows_block_size(monkeypatch):
    """The Function's backward sums in blocks of setup.HERO_BLOCK: a small
    block puts many block boundaries inside the rays."""
    table, hero, cot = _gather_case(1000, seed=3, decades=3)
    monkeypatch.setattr(setup_k, "HERO_BLOCK", 64)
    grad = _port_vjp(table, hero, cot)[1]
    want = _loop_column_sums(torch.from_numpy(cot), torch.from_numpy(hero),
                             N_COLS, 64)
    np.testing.assert_array_equal(grad, want.numpy())


def test_gather_records_only_under_grad():
    table = torch.rand((K, N_COLS))
    hero = torch.randint(0, N_COLS, (50,))
    assert spec.gather_hero(table, hero).grad_fn is None
    table.requires_grad_(True)
    with torch.no_grad():
        assert spec.gather_hero(table, hero).grad_fn is None
    fn = spec.gather_hero(table, hero).grad_fn
    assert type(fn).__name__ == "HeroGatherFnBackward"


W = H = 16
DEPTH = 3


def _jax_value_and_grad(js):
    px, py = (jnp.asarray(x.numpy()) for x in kt.tile_coords(W, H, 0))

    def loss(spectra):
        xyz = jax_pallas.render_pixels_planar(
            js._replace(spectra=spectra), W, H, px, py, 1, max_depth=DEPTH,
            backward="pallas")
        return jnp.mean(xyz ** 2)

    v, g = jax.value_and_grad(loss)(jnp.asarray(js.spectra))
    return float(v), np.asarray(g)


def test_render_value_and_grad_matches_jax():
    js, _ = jax_scene_from_dict(jpresets.simple_scene(W, H))
    want_v, want_g = _jax_value_and_grad(js)
    scene = scene_from_jax(js)
    sp = scene.spectra.clone().requires_grad_(True)
    px, py = kt.tile_coords(W, H, 0)
    before = (setup_k.launches_ray_setup, setup_k.launches_gather,
              setup_k.launches_gather_bwd, mk.launches)
    xyz = kt.render_pixels_planar(dataclasses.replace(scene, spectra=sp),
                                  W, H, px, py, 1, DEPTH)
    loss = (xyz ** 2).mean()
    loss.backward()
    assert before == (setup_k.launches_ray_setup, setup_k.launches_gather,
                      setup_k.launches_gather_bwd, mk.launches)
    got = sp.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert abs(loss.item() - want_v) <= 1e-4 * abs(want_v)
    scale = max(np.abs(want_g).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want_g / scale, rtol=1e-3,
                               atol=1e-4)


def test_cpu_render_differentiates_the_camera():
    """On the CPU the wrappers run the plain versions; the ray-setup
    kernel refuses a camera that needs a gradient only on the card, so a
    CPU render still differentiates the camera."""
    scene, _ = scene_from_dict(presets.cornell_box(8, 8), device="cpu")
    eye = scene.camera.eye.clone().requires_grad_(True)
    cam_scene = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, eye=eye))
    kt.render_sample(cam_scene, 8, 8, 1, 2).sum().backward()
    assert eye.grad is not None and torch.isfinite(eye.grad).all()
