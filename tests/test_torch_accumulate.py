"""The port's one loop over samples per tracer, behind ``tracer.api``.

``api.accumulate`` chooses ``tracer.kernel.accumulate_pixels`` or
``tracer.xla.accumulate_pixels``; every render and loss of a pixel set sums
its samples there. Here, on the CPU: a banded render (``ray_chunk``, a
ragged last band) is the whole-film render bit for bit on both tracers; a
banded kernel render builds its sample-invariant tables once per render
and adds each sample of each band in place where no gradient is wanted;
``render_mean_xyz`` under no grad, times spp, is ``render_accumulate``;
its gradients are those of the per-sample sum it replaced, bit for bit.
Films of 16x13 or smaller at depth 2.
"""

import dataclasses

import pytest
import torch

from computeraytracer_tpu_torch import RenderConfig
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.train import optimize as opt

W, H = 16, 13
DEPTH = 2
SPP = 2
# 4 rows a band (the chunk rounds down to whole rows): bands of 4, 4, 4, 1
CHUNK = 4 * W + 3


@pytest.fixture(scope="module")
def scene():
    return scene_from_dict(presets.cornell_box(W, H), device="cpu")[0]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_ragged_bands_are_the_whole_film(scene, kernel):
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                       first_sample=3, kernel=kernel)
    whole = api.render(scene, cfg)
    banded = api.render(scene, cfg.replace(ray_chunk=CHUNK))
    assert float(whole["accum_xyz"].sum()) > 0
    for k in ("accum_xyz", "mean_xyz", "srgb"):
        assert torch.equal(_bits(banded[k]), _bits(whole[k])), k


def test_banded_render_builds_tables_once_and_adds_in_place(scene,
                                                            monkeypatch):
    """The primitive table, the spectra table and the CIE window once a
    render, whatever the bands; the in-place build (here its plain model)
    once a sample of each band, and no CIE sum in torch."""
    calls = dict.fromkeys(("setup_operands", "pack_prims",
                           "cie_window_exp", "xyz_accumulate_reference",
                           "spectral_to_xyz_p"), 0)
    for mod, name in ((kt, "setup_operands"), (mk, "pack_prims"),
                      (spec, "cie_window_exp"),
                      (mk, "xyz_accumulate_reference"),
                      (spec, "spectral_to_xyz_p")):
        def counted(*a, _real=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                       ray_chunk=CHUNK)
    with torch.no_grad():
        api.render(scene, cfg)
    bands = -(-H // (CHUNK // W))
    assert calls == {"setup_operands": 1, "pack_prims": 1,
                     "cie_window_exp": 1,
                     "xyz_accumulate_reference": SPP * bands,
                     "spectral_to_xyz_p": 0}, calls


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_mean_times_spp_is_render_accumulate(scene, kernel):
    spp = 4  # a power of two: the mean times spp is exact
    with torch.no_grad():
        mean = opt.render_mean_xyz(scene, W, H, spp, DEPTH, first_sample=2,
                                   kernel=kernel)
    want = api.render_accumulate(scene, W, H, spp, DEPTH, first_sample=2,
                                 kernel=kernel)
    assert mean.shape == (H, W, 3) and mean.is_contiguous()
    assert torch.equal(_bits(mean * spp), _bits(want))


@pytest.mark.parametrize("backward", ["pallas", "pallas_taped"])
def test_loss_gradients_are_the_per_sample_sums(scene, backward):
    """render_mean_xyz sums the samples in (3, R) and permutes once; the
    loss and its gradients by spectra and data1 are those of the (H, W, 3)
    sum of each sample permuted, with the setup built once, bit for bit."""
    w, h = 8, 8
    small = scene_from_dict(presets.cornell_box(w, h), device="cpu")[0]
    target = torch.full((h, w, 3), 0.1)

    def loss_and_grads(summed_here):
        sp = small.spectra.clone().requires_grad_(True)
        d1 = small.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(small, spectra=sp, primitives=(
            dataclasses.replace(small.primitives, data1=d1)))
        if summed_here:
            static = mk.SceneStatic.from_scene(s)
            setup = kt.setup_operands(s, static, backward,
                                      *kt.tile_coords(w, h, 0, "cpu"))
            accum = torch.zeros((h, w, 3))
            for k in range(1, SPP + 1):
                accum = accum + kt.render_sample_planar(
                    s, w, h, k, DEPTH, 1, static, backward,
                    setup=setup).permute(1, 2, 0)
            img = accum / float(SPP)
        else:
            img = opt.render_mean_xyz(s, w, h, SPP, DEPTH, backward=backward)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        return loss.detach(), sp.grad, d1.grad

    got, want = loss_and_grads(False), loss_and_grads(True)
    assert (want[1] != 0).any()
    for g, w_ in zip(got, want):
        assert torch.equal(_bits(g), _bits(w_))


def test_unknown_kernel_is_refused_before_the_scene_is_read():
    for call in (lambda: api.accumulate(None, W, H, 1, kernel="triton"),
                 lambda: api.render_accumulate(None, W, H, 1,
                                               kernel="triton")):
        with pytest.raises(ValueError, match="unknown kernel"):
            call()
