"""The forward's XYZ epilogue on the CPU: its plain model, and the served
frame that adds every sample into its accumulator in place.

``kernels.megakernel.xyz_accumulate_reference`` (what the XYZ builds of
``csrc/megakernel_fwd_xyz.cu`` compute as each ray retires) against
``ops.spectrum.spectral_to_xyz_p`` followed by the frame's in-order
accumulation, bit for bit, at ragged ray counts, with zero and huge
radiance rows; ``tracer.kernel.accumulate_pixels`` over the whole film
(``render_accumulate``'s body) against the sum of
``render_sample_planar``'s images; which frames take
the in-place path (a scene without mesh parts, a kernel forward, no
gradient wanted) and that a fit step never does; ``forward_xyz``'s
refusals, the CPU among them. The kernels themselves are held to the same
model on a card: ``tests/test_torch_cuda.py``. 8x8 films at depth 2.
"""

import dataclasses

import pytest
import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.train import optimize

SIDE = 8
DEPTH = 2


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n_rays", [1, 31, 4097])
@pytest.mark.parametrize("spp", [1, 4])
def test_epilogue_model_is_the_cie_sum_accumulated(n_rays, spp):
    """spp samples added by the plain model into one accumulator equal
    ``accum = accum + spectral_to_xyz_p(cie, radiance)`` from zeros, bit
    for bit (NaN and infinity included), with a zero radiance row and rows
    large enough to overflow."""
    gen = torch.Generator().manual_seed(1000 * spp + n_rays)
    got = torch.zeros((3, n_rays))
    want = torch.zeros((3, n_rays))
    for s in range(spp):
        cie = 2.0 * torch.rand((12, n_rays), generator=gen)
        radiance = torch.rand((4, n_rays), generator=gen) * 10.0 ** (
            torch.randint(-30, 30, (4, n_rays), generator=gen).float())
        radiance[:, 0] = 0.0
        if n_rays > 1:
            radiance[:, -1] = 3e38
            radiance[s % 4, n_rays // 2] = 1e38
        mk.xyz_accumulate_reference(cie, radiance, got)
        want = want + spec.spectral_to_xyz_p(cie, radiance)
    assert torch.equal(_bits(got), _bits(want))
    if n_rays > 1:
        assert torch.isinf(got[:, -1]).all()


def _scene(kind):
    if kind == "triangle_rows":
        doc = presets.mesh_scene(SIDE, SIDE, 1)
    else:
        doc = getattr(presets, kind)(SIDE, SIDE)
    return scene_from_dict(doc, device="cpu")[0]


def _composed(scene, spp, first):
    static = mk.SceneStatic.from_scene(scene)
    accum = torch.zeros((3, SIDE, SIDE))
    for s in range(first, first + spp):
        accum = accum + kt.render_sample_planar(scene, SIDE, SIDE, s, DEPTH,
                                                1, static)
    return accum.permute(1, 2, 0).contiguous()


def _frame(scene, spp, first, backward):
    """render_accumulate's body, run eagerly -> (static, XYZ (H, W, 3))."""
    static, accum = kt.accumulate_pixels(scene, SIDE, SIDE, None, None, first,
                                         spp, DEPTH, 1, backward=backward)
    return static, kt._film(accum, SIDE, SIDE)


@pytest.mark.parametrize("kind,spp,first", [
    ("cornell_box", 3, 1), ("cornell_box", 2, 2**32 - 1),
    ("unoccluded_scene", 4, 5), ("triangle_rows", 2, 3)])
def test_cpu_frame_is_the_composition(kind, spp, first):
    """The frame adds each sample into its accumulator in place (the
    forward's plain version, then the epilogue's model): the sum of
    render_sample_planar's images, bit for bit."""
    scene = _scene(kind)
    assert not mk.SceneStatic.from_scene(scene).mesh_parts
    static, got = _frame(scene, spp, first, "pallas")
    want = _composed(scene, spp, first)
    assert float(want.sum()) > 0
    assert torch.equal(got, want)
    assert torch.equal(kt.render_accumulate(scene, SIDE, SIDE, spp, DEPTH,
                                            first_sample=first), want)


@pytest.fixture
def xyz_calls(monkeypatch):
    """Each call of the XYZ build or its plain model, recorded by name, the
    call passed on."""
    calls = []
    for name in ("forward_xyz", "xyz_accumulate_reference"):
        def spy(*args, _real=getattr(mk, name), _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(mk, name, spy)
    return calls


@pytest.mark.parametrize("case,in_place", [
    ("plain", True), ("none", True), ("pallas_taped", True),
    ("grad", False), ("xla", False), ("mesh_parts", False)])
def test_which_frames_add_in_place(xyz_calls, case, in_place):
    """A scene without mesh parts, a kernel forward (pallas, pallas_taped,
    none) and no gradient wanted: the epilogue's model once a sample (on
    the card the XYZ build's launch). A leaf that requires grad under grad
    mode, the eager tracer's backward and a scene with mesh parts sum
    render_sample_planar's images instead (the frame stays differentiable
    where a gradient is wanted)."""
    spp = 2
    backward = case if case in ("none", "pallas_taped", "xla") else "pallas"
    if case == "mesh_parts":
        scene = scene_from_dict(presets.tie_mesh_scene(SIDE, SIDE, "edges"),
                                device="cpu")[0]
    else:
        scene = _scene("cornell_box")
    if case == "grad":
        scene = dataclasses.replace(
            scene, spectra=scene.spectra.clone().requires_grad_(True))
    _, out = _frame(scene, spp, 1, backward)
    assert xyz_calls == ["xyz_accumulate_reference"] * (spp if in_place
                                                         else 0)
    assert out.requires_grad == (case == "grad")


def test_fit_step_takes_no_xyz_build(xyz_calls):
    """A fit step (make_train_step) traces through the radiance forward
    and its autograd: neither the XYZ build nor its model is called, and
    no XYZ launch is counted."""
    scene = _scene("unoccluded_scene")
    params0, static = optimize.split_scene(scene, ("spectra", "data1"))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    adam = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = optimize.make_train_step(static, adam, SIDE, SIDE, 2, DEPTH)
    before = mk.launches_xyz
    loss = step(params, torch.full((SIDE, SIDE, 3), 0.1), 1)
    assert torch.isfinite(torch.as_tensor(loss))
    assert not xyz_calls and mk.launches_xyz == before


def _xyz_operands(scene, static):
    px, py = kt.tile_coords(SIDE, SIDE, 0, "cpu")
    setup = kt.setup_operands(scene, static)
    o, d, hero, seed = kt.camera_planes(scene, SIDE, SIDE, px, py, 1)
    spect, cie = spec.gather_hero_tables(
        (setup.spect_table, setup.cie_table), hero)
    return [setup.prims, o.contiguous(), d, seed, spect, cie,
            torch.zeros((3, SIDE * SIDE)), mk._ray_counter("cpu")]


@pytest.mark.parametrize("fault,match", [
    ("mesh_parts", "without mesh parts"), ("accum", "accum: expected"),
    ("seeds", "seeds: expected"), ("cie", "cie: expected"),
    (None, "unsupported device")])
def test_forward_xyz_refuses(fault, match):
    """A scene with mesh parts, and operands of the wrong shape or dtype,
    are refused before anything runs; sound operands on the CPU too (the
    build launches on the card; its plain version is the forward's, then
    xyz_accumulate_reference)."""
    scene = _scene("cornell_box")
    static = mk.SceneStatic.from_scene(scene)
    args = _xyz_operands(scene, static)
    if fault == "mesh_parts":
        mscene = scene_from_dict(presets.tie_mesh_scene(SIDE, SIDE, "edges"),
                                 device="cpu")[0]
        static = mk.SceneStatic.from_scene(mscene)
    elif fault == "accum":
        args[6] = torch.zeros((3, SIDE * SIDE + 1))
    elif fault == "seeds":
        args[3] = args[3].to(torch.int32)
    elif fault == "cie":
        args[5] = args[5][:9]
    with pytest.raises(ValueError, match=match):
        mk.forward_xyz(static, DEPTH, 1, *args)
