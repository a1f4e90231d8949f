"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so it runs on a card machine without the JAX package's
dependencies; the repo's conftest imports jax, so run it there with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

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
