"""When ``tracer.kernel.render_accumulate`` graphs a frame, and the key of
its frame graphs, on the CPU; and the ray setup's sample base.

The graph itself (captured once, replayed, images bit-equal to the eager
frame) runs only on a card: ``tests/test_torch_cuda.py``. Here:
``frame_graph_key`` is the same for the same scene and call, new for a
replaced scene tensor, an in-place edit of an integer tensor (whose
version counter it reads) and any change of the call's shape or knobs,
and unchanged by an in-place edit of a float tensor (the graph reads it
at its address); ``eager_reasons`` names the device, the backward and a
leaf that requires grad under grad mode; ``render_accumulate`` keeps no
entry for a scene with mesh parts; a CPU scene is never captured; the ray
setup at base b and sample k is the ray setup at sample b + k, through
``kernels.setup.ray_setup_reference`` and the kernel path's
``render_sample_planar``, and a base is refused where a camera gradient
is wanted. 8x8 films at depth 2.
"""

import dataclasses

import pytest
import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

SIDE = 8
DEPTH = 2
CALL = dict(width=SIDE, height=SIDE, spp=2, max_depth=DEPTH, rr_start=1,
            backward="pallas")


@pytest.fixture
def scene():
    return scene_from_dict(presets.unoccluded_scene(SIDE, SIDE),
                           device="cpu")[0]


def key(scene, **change):
    return kt.frame_graph_key(scene, **dict(CALL, **change))


def test_same_scene_twice_gives_the_same_key(scene):
    assert key(scene) == key(scene)
    # a new Scene object over the same tensors is the same frame
    assert key(dataclasses.replace(scene)) == key(scene)


@pytest.mark.parametrize("part,name", [(None, "spectra"), (None, "cie"),
                                       ("primitives", "data1"),
                                       ("primitives", "category"),
                                       ("lights", "prim_index"),
                                       ("camera", "eye")])
def test_a_replaced_scene_tensor_gives_a_new_key(scene, part, name):
    def replaced(holder):
        return dataclasses.replace(
            holder, **{name: getattr(holder, name).clone()})

    other = (replaced(scene) if part is None else dataclasses.replace(
        scene, **{part: replaced(getattr(scene, part))}))
    assert key(other) != key(scene)


@pytest.mark.parametrize("name", ["category", "material", "emission",
                                  "reflectance"])
def test_an_in_place_edit_of_an_integer_tensor_gives_a_new_key(scene, name):
    t = getattr(scene.primitives, name)
    before = key(scene)
    version = t._version
    t.add_(0)  # the same values, a new version
    assert t._version > version
    assert key(scene) != before


def test_an_in_place_edit_of_a_float_tensor_keeps_the_key(scene):
    """The graph reads the spectra and vertices at their addresses, so an
    edit in place shows in the next replay without a new capture."""
    before = key(scene)
    scene.spectra.mul_(0.5)
    scene.primitives.data1.add_(1.0)
    assert key(scene) == before


@pytest.mark.parametrize("change", [dict(spp=3), dict(max_depth=DEPTH + 1),
                                    dict(width=SIDE + 1),
                                    dict(height=SIDE + 1), dict(rr_start=2),
                                    dict(backward="pallas_taped")])
def test_a_change_of_the_call_gives_a_new_key(scene, change):
    assert key(scene, **change) != key(scene)


def test_a_cpu_scene_is_eager_for_its_device_alone(scene):
    assert kt.eager_reasons(scene, "pallas") == ("device",)
    assert kt.eager_reasons(scene, "none") == ("device",)


@pytest.mark.parametrize("backward", ["xla", "replay"])
def test_a_backward_without_the_kernel_forward_is_eager(scene, backward):
    assert "backward" in kt.eager_reasons(scene, backward)


@pytest.mark.parametrize("leaf", ["spectra", "data1", "fov"])
def test_a_leaf_that_requires_grad_gives_no_graph(scene, leaf):
    leaves = kt.scene_leaves(scene)
    k = [name for _, name in kt.SCENE_LEAVES].index(leaf)
    leaves[k] = leaves[k].clone().requires_grad_(True)
    wanting = kt.with_leaves(scene, leaves)
    assert "grad" in kt.eager_reasons(wanting, "pallas")
    with torch.no_grad():
        assert "grad" not in kt.eager_reasons(wanting, "pallas")
    assert "grad" not in kt.eager_reasons(scene, "pallas")


def test_a_scene_with_mesh_parts_gives_no_graph(monkeypatch):
    """A mesh scene's frames stay eager whatever ``eager_reasons`` says:
    render_accumulate keeps no entry for them, so its next call of the
    same key is eager again and nothing is captured."""
    mscene, _ = scene_from_dict(presets.tie_mesh_scene(SIDE, SIDE, "edges"),
                                device="cpu")
    assert mk.SceneStatic.from_scene(mscene).mesh_parts
    monkeypatch.setattr(kt, "eager_reasons", lambda scene, backward: ())
    monkeypatch.setattr(kt, "_frame_graphs", type(kt._frame_graphs)())
    captures, eager = kt.graph_captures, kt.graph_eager
    frames = [kt.render_accumulate(mscene, SIDE, SIDE, 1, DEPTH)
              for _ in range(2)]
    assert not kt._frame_graphs
    assert (kt.graph_captures, kt.graph_eager) == (captures, eager + 2)
    assert torch.equal(frames[0], frames[1])


def test_a_base_with_a_camera_gradient_is_refused(scene):
    """A camera gradient is taken at a host sample: the ray setup refuses
    a base where one is wanted, and takes it where none is."""
    px, py = kt.tile_coords(SIDE, SIDE, 0, "cpu")
    b = torch.tensor(1, dtype=torch.int64)
    cam = scene.camera
    fov = cam.fov.clone().requires_grad_(True)
    args = (cam.eye, cam.lookat, cam.up, fov, SIDE, SIDE, px, py, 1)
    with pytest.raises(ValueError, match="base"):
        setup_k.RaySetupFn.apply(*args, b)
    with torch.no_grad():
        got = setup_k.RaySetupFn.apply(*args, b)
    want = setup_k.RaySetupFn.apply(*args[:-1], 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach())


def test_a_cpu_scene_never_captures(scene):
    """Three calls of one key on the CPU: every frame eager, nothing kept,
    and the three frames equal."""
    captures, replays = kt.graph_captures, kt.graph_replays
    eager = kt.graph_eager
    n_entries = len(kt._frame_graphs)
    frames = [kt.render_accumulate(scene, SIDE, SIDE, 1, DEPTH)
              for _ in range(3)]
    assert (kt.graph_captures, kt.graph_replays) == (captures, replays)
    assert kt.graph_eager == eager + 3
    assert len(kt._frame_graphs) == n_entries
    assert all(torch.equal(f, frames[0]) for f in frames)


@pytest.mark.parametrize("base,sample", [(0, 1), (0, 7), (5, 0), (5, 3),
                                         (2**32 - 2, 1)])
def test_ray_setup_reference_at_a_base(scene, base, sample):
    """The ray setup at base b and sample k is the ray setup at b + k; a
    base of 0 changes nothing."""
    px, py = kt.tile_coords(SIDE, SIDE, 0, "cpu")
    b = torch.tensor(base, dtype=torch.int64)
    got = setup_k.ray_setup_reference(scene.camera, SIDE, SIDE, px, py,
                                      sample, b)
    want = setup_k.ray_setup_reference(scene.camera, SIDE, SIDE, px, py,
                                       base + sample)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    via = setup_k.ray_setup(scene.camera, SIDE, SIDE, px, py, sample, b)
    for g, w in zip(via, want):
        assert torch.equal(g, w)


def test_render_sample_planar_at_a_sample_base(scene):
    """The kernel path's sample at base 3 and sample 1 is its sample 4."""
    base = torch.tensor(3, dtype=torch.int64)
    got = kt.render_sample_planar(scene, SIDE, SIDE, 1, DEPTH,
                                  sample_base=base)
    assert torch.equal(got, kt.render_sample_planar(scene, SIDE, SIDE, 4,
                                                    DEPTH))
    with pytest.raises(ValueError, match="base"):
        kt.render_sample_planar(scene, SIDE, SIDE, 1, DEPTH,
                                backward="xla", sample_base=base)
