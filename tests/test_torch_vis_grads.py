"""Visibility gradients of the PyTorch port's renderers (``vis_grads``:
``tracer/xla.py`` with the screen, light and hemisphere warps of
``ops/warp.py``; ``tracer/kernel.py`` with the screen warp around the
trace) against the JAX package's ``tracer.xla``.

Scenes: ``occluder_scene`` at 16^2 and ``cornell_box`` at 8^2, depth 2,
one sample. The JAX reference (the occluder's) is computed once, in a
module-scoped fixture, under ``jax.jit``. The image of every ``vis_grads`` mode is the
``stratified=False`` render's bit for bit (the port's version of
tests/test_visibility_grads.py:97). Images against JAX at the convention
of tests/test_torch_eager.py (at least 99% of pixels within rtol = atol
= 2e-4, the mean within 1e-3); gradients of a fixed weighted sum of the
image by data1 and spectra against jax.grad within rtol 1e-3 and atol
1e-5 of each tensor's largest entry (tests/test_torch_eager_grads.py),
``use_remat=True`` bit-equal to ``use_remat=False``. The kernel path's
screen warp runs on the kernels' plain versions here: its image within
the image convention of the eager screen warp's, its gradient within 5%
(relative L2, and on the occluder's translation) of the eager one, the
JAX package's bound between its two paths (:277-323), for both backward
kernels. The Monte Carlo checks against finite differences run on the
card (chip_smoke.py phase 25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import xla as jax_xla
from computeraytracer_tpu_torch.bvh import builder
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.train import optimize as opt

DEPTH = 2
SIDES = {"occluder_scene": 16, "cornell_box": 8}
OCC = 3  # the occluder's row in occluder_scene
MODES = [("screen",), ("light",), ("hemi",), True]


def _weight(side):
    return np.random.default_rng(5).uniform(
        0.5, 1.5, (side, side, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX references: the occluder's vis_grads=True image and its
    gradients by data1 and spectra; the Cornell box's scene (its
    unstratified image is held against JAX's by
    tests/test_torch_eager.py::test_stratified_false_changes_only_the_jitter)."""
    refs = {}
    side = SIDES["occluder_scene"]
    js = jdata.as_jax(jax_scene_from_dict(jpresets.occluder_scene(
        side, side))[0])

    def render(d1, sp):
        s = js._replace(spectra=sp,
                        primitives=js.primitives._replace(data1=d1))
        return jax_xla.render_sample(s, side, side, 1, DEPTH,
                                     vis_grads=True, use_remat=False)

    img, vjp = jax.vjp(jax.jit(render), jnp.asarray(js.primitives.data1),
                       jnp.asarray(js.spectra))
    grads = vjp(jnp.asarray(_weight(side)))
    refs["occluder_scene"] = (js, np.asarray(img),
                              [np.asarray(g) for g in grads])
    side = SIDES["cornell_box"]
    jc = jax_scene_from_dict(jpresets.cornell_box(side, side))[0]
    refs["cornell_box"] = (jc, None, None)
    return refs


def _port(refs, name):
    return scene_from_jax(refs[name][0], device="cpu")


def _close(got, want):
    close = np.isclose(got, want, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert np.isfinite(got).all()
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels match"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def _grads(scene, render):
    """Gradients of sum(weight * render(scene)) by (data1, spectra), and
    by a translation dx of the occluder along x."""
    d1 = scene.primitives.data1.clone().requires_grad_(True)
    sp = scene.spectra.clone().requires_grad_(True)
    dx = torch.zeros((), requires_grad=True)
    bump = torch.zeros_like(d1)
    bump[OCC, 0] = 1.0
    s = dataclasses.replace(scene, spectra=sp, primitives=dataclasses.replace(
        scene.primitives, data1=d1 + bump * dx))
    img = render(s)
    (img * torch.from_numpy(_weight(img.shape[0]))).sum().backward()
    return img.detach(), d1.grad, sp.grad, dx.grad


@pytest.mark.parametrize("name", sorted(SIDES))
def test_vis_images_bit_equal_unstratified(jax_refs, name):
    """Every vis_grads mode renders the stratified=False image bit for
    bit; the occluder's matches the JAX package's vis_grads image."""
    scene, side = _port(jax_refs, name), SIDES[name]
    base = xla.render_sample(scene, side, side, 1, DEPTH, stratified=False)
    for doms in MODES:
        img = xla.render_sample(scene, side, side, 1, DEPTH, vis_grads=doms)
        assert torch.equal(img, base), doms
    if jax_refs[name][1] is not None:
        _close(base.numpy(), jax_refs[name][1])


@pytest.mark.parametrize("use_remat", [False, True])
def test_vis_gradients_match_jax(jax_refs, use_remat):
    js, want_img, want = jax_refs["occluder_scene"]
    side = SIDES["occluder_scene"]
    img, g_d1, g_sp, _ = _grads(_port(jax_refs, "occluder_scene"),
                                lambda s: xla.render_sample(
                                    s, side, side, 1, DEPTH, vis_grads=True,
                                    use_remat=use_remat))
    _close(img.numpy(), want_img)
    for got, w in zip((g_d1, g_sp), want):
        got = got.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got / np.abs(w).max(), w / np.abs(w).max(),
                                   rtol=1e-3, atol=1e-5)
    if use_remat:
        ref = _grads(_port(jax_refs, "occluder_scene"),
                     lambda s: xla.render_sample(s, side, side, 1, DEPTH,
                                                 vis_grads=True,
                                                 use_remat=False))
        assert torch.equal(g_d1, ref[1]) and torch.equal(g_sp, ref[2])


@pytest.fixture(scope="module")
def eager_screen(jax_refs):
    side = SIDES["occluder_scene"]
    return _grads(_port(jax_refs, "occluder_scene"),
                  lambda s: xla.render_sample(s, side, side, 1, DEPTH,
                                              vis_grads=("screen",)))


@pytest.mark.parametrize("backward", ["pallas", "pallas_taped"])
def test_kernel_screen_warp_matches_eager(jax_refs, eager_screen, backward):
    """The screen warp around the trace (the plain versions of kernels 1
    and 3, or of the taped forward and kernel 4): its image is the kernel
    path's stratified=False render bit for bit and within the image
    convention of the eager screen warp's; its gradient within 5% of the
    eager one, where the boundary term is all of the translation's."""
    scene = _port(jax_refs, "occluder_scene")
    side = SIDES["occluder_scene"]
    static = kt.SceneStatic.from_scene(scene)
    img, g_d1, g_sp, g_dx = _grads(scene, lambda s: kt.render_sample(
        s, side, side, 1, DEPTH, static=static, backward=backward,
        vis_grads=("screen",)))
    plain = kt.render_sample(scene, side, side, 1, DEPTH, static=static,
                             stratified=False)
    assert torch.equal(img, plain)
    _close(img.numpy(), eager_screen[0].numpy())
    for got, want in zip((g_d1, g_sp), eager_screen[1:3]):
        assert torch.isfinite(got).all()
        assert ((got - want).norm() / want.norm()).item() <= 0.05
    want_dx = float(eager_screen[3])
    assert abs(want_dx) > 1.0  # the silhouette moves the weighted image
    assert abs(float(g_dx) - want_dx) <= 0.05 * abs(want_dx)


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_screen_warp_several_films_per_call(jax_refs, path):
    """Whole films one after another, one sample index per ray: the
    images and the gradient of one call per sample, summed."""
    scene = _port(jax_refs, "occluder_scene")
    side, n = 8, 3
    static = kt.SceneStatic.from_scene(scene)
    px, py = xla.tile_coords(side, side, 0)

    def render(s, p, q, k):
        if path == "eager":
            return xla.render_pixels(s, side, side, p, q, k, DEPTH,
                                     vis_grads=("screen",))
        return kt.render_pixels(s, side, side, p, q, k, DEPTH, 1, static,
                                vis_grads=("screen",))

    out = []
    for batched in (True, False):
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(scene, primitives=dataclasses.replace(
            scene.primitives, data1=d1))
        if batched:
            smp = torch.arange(1, n + 1).repeat_interleave(side * side)
            img = render(s, px.repeat(n), py.repeat(n), smp).reshape(
                n, side * side, 3).sum(dim=0)
        else:
            img = sum(render(s, px, py, k) for k in range(1, n + 1))
        wt = torch.from_numpy(_weight(side)).reshape(-1, 3)
        (img * wt).sum().backward()
        out.append((img.detach(), d1.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert out[1][1].abs().max() > 0
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5,
                               atol=1e-5 * out[1][1].abs().max().item())


def test_light_and_hemi_with_bvh(jax_refs):
    """The light and hemisphere warps on a BVH-traced render (the
    auxiliary rays scan every primitive): the brute-force render's image
    and gradients, bands of rows allowed."""
    scene = _port(jax_refs, "occluder_scene")
    side = 8
    bvh = builder.scene_bvh(scene, backend="numpy")
    doms = ("light", "hemi")
    got = _grads(scene, lambda s: xla.render_sample(
        s, side, side, 1, DEPTH, bvh=bvh, vis_grads=doms))
    want = _grads(scene, lambda s: xla.render_sample(
        s, side, side, 1, DEPTH, vis_grads=doms))
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    px, py = xla.tile_coords(side, side // 2, side // 2)
    band = xla.render_pixels(scene, side, side, px, py, 1, DEPTH,
                             vis_grads=doms)
    assert torch.equal(band, want[0][side // 2:].reshape(-1, 3))


def test_vis_grads_value_errors(jax_refs):
    scene = _port(jax_refs, "occluder_scene")
    side = SIDES["occluder_scene"]
    for doms in (("light",), ("hemi",), True):
        with pytest.raises(ValueError, match="bounce loop"):
            kt.render_sample(scene, side, side, 1, DEPTH, vis_grads=doms)
    px, py = xla.tile_coords(side, 4, 0)
    for render in (kt.render_pixels, xla.render_pixels):
        with pytest.raises(ValueError, match="full-film"):
            render(scene, side, side, px, py, 1, DEPTH,
                   vis_grads=("screen",))
    with pytest.raises(ValueError, match="boundary term"):
        kt.render_sample(scene, side, side, 1, DEPTH, backward="xla",
                         vis_grads=("screen",))
    with pytest.raises(ValueError, match="kernel='xla'"):
        opt.render_mean_xyz(scene, side, side, 1, DEPTH, vis_grads=True)
