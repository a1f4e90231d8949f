"""The port's CUDA kernels on the card, held against their plain versions.

The forward and backward megakernels against forward_reference and
backward_reference on the same CUDA tensors, the served render and the
gradient of a render against the same computation on the CPU.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so it runs on a card machine without the JAX package's
dependencies; the repo's conftest imports jax, so run it there with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _doc(name, w, h):
    """A preset, or "cornell_mirror": Cornell with its diffuse sphere made
    a mirror (no preset has one)."""
    if name == "cornell_mirror":
        doc = presets.cornell_box(w, h)
        doc["objects"]["spheres"][0]["type"] = "mirror"
        return doc
    return getattr(presets, name)(w, h)


def _inputs(scene, w, h, sample, n_rays=None):
    px, py = kt.tile_coords(w, h, 0, scene.device)
    if n_rays is not None:
        px, py = px[:n_rays], py[:n_rays]
    o, d, hero, seed = kt.camera_planes(scene, w, h, px, py, sample)
    return kt.kernel_inputs(scene, o, d, hero, seed)


def _frac_within(got, want, tol=1e-4):
    rel = (got - want).abs() / want.abs().clamp(min=1e-2)
    return (rel < tol).all(dim=0).float().mean().item()


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("cornell_box", 2), ("simple_scene", 5),
    ("cornell_box_glassless", 8), ("occluder_scene", 3)])
def test_kernel_matches_plain_version(cuda, name, depth):
    """Both round every op separately (the kernel is built with
    --fmad=false), so at least 99.9% of rays agree to rel 1e-4."""
    scene, _ = scene_from_dict(getattr(presets, name)(128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 5)
    before = mk.launches
    got = mk.forward(static, depth, 1, *args)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    want = mk.forward_reference(static, depth, 1, *args)
    assert torch.isfinite(got).all()
    assert _frac_within(got, want) >= 0.999


def test_ragged_ray_count(cuda):
    """R that is not a multiple of the block size: tail threads masked."""
    scene, _ = scene_from_dict(presets.cornell_box(64, 64), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 64, 64, 2, n_rays=1000)
    got = mk.forward(static, 6, 1, *args)
    want = mk.forward_reference(static, 6, 1, *args)
    assert got.shape == (4, 1000)
    assert _frac_within(got, want) >= 0.999


def test_mixed_devices_raise(cuda):
    scene, _ = scene_from_dict(presets.cornell_box(16, 16), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    prims, rays, seeds, spect = _inputs(scene, 16, 16, 1)
    with pytest.raises(ValueError, match="is on"):
        mk.forward(static, 4, 1, prims.cpu(), rays, seeds, spect)


def test_card_render_matches_cpu_render(cuda):
    """The served path on the card vs the same render on the CPU: the
    two devices' exp/sin/cos may differ by an ulp, so a rare pixel's
    path can diverge; 99% of pixels within 2e-4 and the mean within
    1e-3."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6)
    cpu_scene, _ = scene_from_dict(presets.cornell_box(48, 32))
    card = api.render(cpu_scene.to(cuda), cfg)["accum_xyz"].cpu().numpy()
    host = api.render(cpu_scene, cfg)["accum_xyz"].numpy()
    close = np.isclose(card, host, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(card.mean() - host.mean()) <= 1e-3 * abs(host.mean())


def _dL(n_rays, device, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(
        g.standard_normal((4, n_rays)).astype(np.float32)).to(device)


def _assert_backward_close(got, want):
    """d_prims within 1e-3 of its largest entry; d_rays and d_spect: at
    least 99.9% of rays within rel 1e-3, the denominator floored at 1e-3
    of the plane's largest magnitude. All finite."""
    (gp, gr, gs), (wp, wr, ws) = got, want
    for g in got:
        assert torch.isfinite(g).all()
    assert (gp - wp).abs().max() <= 1e-3 * wp.abs().max()
    for g, w in ((gr, wr), (gs, ws)):
        den = torch.maximum(w.abs(), 1e-3 * w.abs().max())
        frac = ((g - w).abs() / den < 1e-3).all(dim=0).float().mean().item()
        assert frac >= 0.999, frac


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("cornell_box", 2), ("simple_scene", 5),
    ("cornell_box_glassless", 8), ("occluder_scene", 3),
    ("cornell_mirror", 6)])
def test_backward_kernel_matches_plain_version(cuda, name, depth):
    scene, _ = scene_from_dict(_doc(name, 128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 5)
    dL = _dL(args[1].shape[1], cuda)
    before = mk.launches_bwd
    got = mk.backward(static, depth, 1, *args, dL)
    torch.cuda.synchronize()
    assert mk.launches_bwd == before + 1
    want = mk.backward_reference(static, depth, 1, *args, dL)
    _assert_backward_close(got, want)


def test_backward_ragged_ray_count(cuda):
    scene, _ = scene_from_dict(presets.cornell_box(64, 64), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 64, 64, 2, n_rays=1000)
    dL = _dL(1000, cuda, seed=1)
    got = mk.backward(static, 6, 1, *args, dL)
    assert got[1].shape == (6, 1000) and got[2].shape == args[3].shape
    _assert_backward_close(got,
                           mk.backward_reference(static, 6, 1, *args, dL))


def test_backward_kernel_is_deterministic(cuda):
    """d_prims is summed in a fixed order (per-warp tables, then blocks):
    two calls give bit-equal results."""
    scene, _ = scene_from_dict(presets.cornell_box(128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 3)
    dL = _dL(args[1].shape[1], cuda, seed=2)
    first = mk.backward(static, 8, 1, *args, dL)
    second = mk.backward(static, 8, 1, *args, dL)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_card_gradient_matches_cpu(cuda):
    """The gradient of sum(render_sample ** 2) with respect to spectra and
    data1 exists on the card (TraceFn, backward kernel) and agrees with
    the same gradient on the CPU (plain versions)."""
    w, h = 48, 32
    cpu_scene, _ = scene_from_dict(presets.cornell_box(w, h))

    def grads(scene):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        (kt.render_sample(s, w, h, 1, max_depth=4) ** 2).sum().backward()
        return sp.grad, d1.grad

    before = mk.launches_bwd
    card = grads(cpu_scene.to(cuda))
    assert mk.launches_bwd == before + 1
    host = grads(cpu_scene)
    for c, h_ in zip(card, host):
        assert c is not None and c.is_cuda
        c, h_ = c.cpu().numpy(), h_.numpy()
        assert np.isfinite(c).all()
        scale = max(np.abs(h_).max(), 1e-6)
        np.testing.assert_allclose(c / scale, h_ / scale, rtol=1e-3,
                                   atol=1e-4)
