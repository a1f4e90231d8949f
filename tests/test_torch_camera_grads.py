"""Camera gradients on the port's kernel path vs the JAX package's.

The JAX kernel path differentiates the camera through XLA's AD of
``camera_rays_p`` (tracer/pallas.py:709-711); the port through
``kernels.setup.RaySetupFn``, whose backward is the ray setup's backward
kernel on the card and its plain version, ``ray_setup_bwd_reference``,
on the CPU.

- The kernel path's ``render_sample`` gradient by eye, lookat, up, fov
  and data1 against ``jax.grad`` of the JAX package's (interpret mode), at
  tests/test_pallas.py's ``test_geometry_and_camera_gradient_matches_xla``
  setup and tolerance (simple_scene 8x8, depth 2, sample 1, sum(img ** 2);
  rtol 1e-3, atol 1e-4 of each leaf's scale), for both backward kernels.
- ``RaySetupFn``'s backward (the fixed-order sums and ``film_frame_vjp``)
  against torch autograd of ``ray_setup_reference`` for random cotangents
  at three cameras (R = 4,099, a ragged last block): within 1e-5 of each
  leaf's largest entry; only the camera tensors that need a gradient get
  one.
- The plain sums (``ray_setup_bwd_sums_reference``, float64 in a fixed
  order) against an explicit loop in their stated order (bit for bit) and
  within relative L2 1e-6 of a float64 sum.
- With grad mode off, or no camera tensor that needs a gradient, nothing
  is recorded and the outputs are ``ray_setup_reference``'s bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.scene.data import CameraSpec
from computeraytracer_tpu_torch.tracer import kernel as kt

LEAVES = ("eye", "lookat", "up", "fov")
# the cameras of chip_smoke.py phase 30 besides Cornell's: a tilted up, a
# fov near pi/2
CAMERAS = {
    "tilted": ((1.3, 2.1, -3.7), (0.2, 0.9, 0.4), (0.3, 1.0, 0.2), 0.9),
    "wide": ((0.0, 0.5, 5.0), (0.1, -0.2, 0.0), (0.0, 1.0, 0.0), 1.5707),
}
FILM = (67, 62)
N_RAYS = 4099


def _camera(name):
    scene, _ = scene_from_dict(presets.cornell_box(*FILM), device="cpu")
    if name == "cornell":
        return scene.camera
    return CameraSpec(*(torch.tensor(v, dtype=torch.float32)
                        for v in CAMERAS[name]))


def _rays():
    px, py = kt.tile_coords(*FILM, 0, "cpu")
    return px[:N_RAYS], py[:N_RAYS]


def _cotangents(seed):
    g = np.random.default_rng(seed).standard_normal((6, N_RAYS))
    g = torch.from_numpy(g.astype(np.float32))
    return g[:3], g[3:]


@pytest.mark.parametrize("backward", ["pallas", "pallas_taped"])
def test_kernel_path_camera_gradients_match_jax(backward):
    """jax.grad of sum(render_sample ** 2) on the JAX kernel path by
    data1 and the four camera tensors, against the port's kernel path
    (the camera through RaySetupFn), all leaves in one call each."""
    w = h = 8
    js, _ = jax_scene_from_dict(jpresets.simple_scene(64, 64))

    def loss(d1, eye, lookat, up, fov):
        s = js._replace(
            primitives=js.primitives._replace(data1=d1),
            camera=js.camera._replace(eye=eye, lookat=lookat, up=up,
                                      fov=fov))
        img = jax_pallas.render_sample(s, w, h, 1, max_depth=2,
                                       backward=backward)
        return jnp.sum(img ** 2)

    args = [jnp.asarray(x) for x in (js.primitives.data1, *js.camera)]
    want = [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]

    scene = scene_from_jax(js)
    leaves = [torch.tensor(np.asarray(a)).requires_grad_(True)
              for a in args]
    s = dataclasses.replace(
        scene, primitives=dataclasses.replace(scene.primitives,
                                              data1=leaves[0]),
        camera=CameraSpec(*leaves[1:]))
    px, py = kt.tile_coords(w, h, 0, "cpu")
    d = kt.camera_planes(s, w, h, px, py, 1)[1]
    assert type(d.grad_fn).__name__ == "RaySetupFnBackward"
    (kt.render_sample(s, w, h, 1, 2, backward=backward) ** 2).sum().backward()
    for name, leaf, gx in zip(("data1",) + LEAVES, leaves, want):
        got = leaf.grad.numpy()
        assert got.shape == gx.shape and np.isfinite(got).all(), name
        assert np.abs(gx).max() > 0, name
        scale = max(np.abs(gx).max(), 1e-6)
        np.testing.assert_allclose(got / scale, gx / scale, rtol=1e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("camera", ["cornell", "tilted", "wide"])
def test_ray_setup_backward_matches_autograd(camera):
    """RaySetupFn's backward against torch autograd of ray_setup_reference
    for the same cotangents of o and d, at samples 3 and 2^32 - 3: within
    1e-5 of each leaf's largest entry. With only up and fov requiring a
    gradient, eye and lookat get none and up and fov the same ones."""
    cam = _camera(camera)
    px, py = _rays()
    g_o, g_d = _cotangents(7)
    for sample in (3, 2**32 - 3):
        want_leaves = [getattr(cam, n).clone().requires_grad_(True)
                       for n in LEAVES]
        o, d, _, _ = setup_k.ray_setup_reference(CameraSpec(*want_leaves),
                                                 *FILM, px, py, sample)
        want = torch.autograd.grad((o * g_o).sum() + (d * g_d).sum(),
                                   want_leaves)
        leaves = [getattr(cam, n).clone().requires_grad_(True)
                  for n in LEAVES]
        o, d, hero, seed = setup_k.ray_setup(CameraSpec(*leaves), *FILM, px,
                                             py, sample)
        assert o.grad_fn is not None and d.grad_fn is not None
        assert not hero.requires_grad and not seed.requires_grad
        got = torch.autograd.grad((o * g_o).sum() + (d * g_d).sum(), leaves)
        for name, g, w in zip(LEAVES, got, want):
            assert g.shape == w.shape and torch.isfinite(g).all(), name
            err = ((g - w).abs().max() / w.abs().max()).item()
            assert err <= 1e-5, (name, sample, err)
        some = [getattr(cam, n).clone().requires_grad_(n in ("up", "fov"))
                for n in LEAVES]
        o, d, _, _ = setup_k.ray_setup(CameraSpec(*some), *FILM, px, py,
                                       sample)
        ((o * g_o).sum() + (d * g_d).sum()).backward()
        assert some[0].grad is None and some[1].grad is None
        assert torch.equal(some[2].grad, got[2])
        assert torch.equal(some[3].grad, got[3])


def _sums_by_loop(terms):
    """The backward kernel's summation order as an explicit loop, in
    float64, each sum rounded to f32 at the end."""
    K, R = terms.shape
    B, L = setup_k.BWD_BLOCK, setup_k.BWD_WARP
    n_blocks = -(-R // B)
    f64 = dict(dtype=torch.float64)
    partials = []
    for b in range(n_blocks):
        acc = torch.zeros(K, **f64)
        for w in range(B // L):
            lanes = torch.zeros((K, L), **f64)
            r0 = b * B + w * L
            seg = terms[:, r0:min(R, r0 + L)]
            lanes[:, :seg.shape[1]] = seg
            h = L // 2
            while h:
                lanes = torch.stack([lanes[:, i] + lanes[:, i + h]
                                     for i in range(h)], dim=1)
                h //= 2
            acc = acc + lanes[:, 0]
        partials.append(acc)
    per = -(-n_blocks // setup_k.BWD_GROUPS)
    out = torch.zeros(K, **f64)
    for g in range(setup_k.BWD_GROUPS):
        acc = torch.zeros(K, **f64)
        for b in range(g * per, min(n_blocks, (g + 1) * per)):
            acc = acc + partials[b]
        out = out + acc
    return out.float()


@pytest.mark.parametrize("n_rays", [1, 255, 257, N_RAYS, 70_001])
def test_backward_sums_fixed_order(n_rays):
    """ray_setup_bwd_sums_reference bit-equal to its stated order as an
    explicit loop (float64; blocks of 256 rays, a tree per warp of 32, the
    warps in order, the blocks in 64 groups; rounded once to f32), and
    within relative L2 1e-6 of a float64 sum of the same terms; 70,001
    rays fill several blocks a group."""
    g = np.random.default_rng(n_rays)
    terms = torch.from_numpy((g.standard_normal((setup_k.BWD_SUMS, n_rays))
                              * 10.0 ** g.uniform(-2, 2, (1, n_rays)))
                             .astype(np.float32))
    got = setup_k.ray_setup_bwd_sums_reference(terms)
    assert torch.equal(got, _sums_by_loop(terms))
    exact = terms.double().sum(dim=1)
    assert ((got.double() - exact).norm() / exact.norm()).item() <= 1e-6


def test_backward_terms_float64_sum():
    """The plain sums of the real terms (ray_setup_bwd_terms at the tilted
    camera) within relative L2 1e-6 of their float64 sum."""
    cam = _camera("tilted")
    px, py = _rays()
    terms = setup_k.ray_setup_bwd_terms(cam, *FILM, px, py, 5,
                                        *_cotangents(11))
    got = setup_k.ray_setup_bwd_sums_reference(terms)
    exact = terms.double().sum(dim=1)
    assert ((got.double() - exact).norm() / exact.norm()).item() <= 1e-6


def test_ray_setup_records_nothing_without_grad():
    """Under no_grad with camera tensors that need a gradient, and under
    grad with none that does, ray_setup records nothing and its outputs
    are ray_setup_reference's bit for bit."""
    cam = _camera("tilted")
    px, py = _rays()
    want = setup_k.ray_setup_reference(cam, *FILM, px, py, 9)
    needing = CameraSpec(*(getattr(cam, n).clone().requires_grad_(True)
                           for n in LEAVES))
    with torch.no_grad():
        quiet = setup_k.ray_setup(needing, *FILM, px, py, 9)
    plain = setup_k.ray_setup(cam, *FILM, px, py, 9)
    for got in (quiet, plain):
        for g, w in zip(got, want):
            assert g.grad_fn is None
            assert g.dtype == w.dtype and torch.equal(g, w)
