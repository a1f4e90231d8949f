"""Scene loading in the PyTorch port vs the JAX package.

Both packages load the same reference-schema documents; every array of
the loaded scene must be equal bit for bit, so the tracers compute on
identical numbers."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import data as tdata
from computeraytracer_tpu_torch.scene import load_scene
from computeraytracer_tpu_torch.scene import presets as tpresets
from computeraytracer_tpu_torch.scene import scene_from_dict

PRESETS = ["cornell_box", "simple_scene", "cornell_box_glassless",
           "unoccluded_scene", "occluder_scene"]


def _leaves(scene, module):
    """(name, array) for every leaf of a Scene of either package."""
    out = []
    for part, cls in (("primitives", module.ScenePrimitives),
                      ("lights", module.SceneLights),
                      ("camera", module.CameraSpec)):
        obj = getattr(scene, part)
        names = (cls._fields if hasattr(cls, "_fields")
                 else [f.name for f in dataclasses.fields(cls)])
        out += [(f"{part}.{n}", getattr(obj, n)) for n in names]
    return out + [("spectra", scene.spectra), ("cie", scene.cie)]


def _assert_same_scene(torch_scene, jax_scene):
    got = dict(_leaves(torch_scene, tdata))
    want = dict(_leaves(jax_scene, jdata))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert isinstance(g, torch.Tensor), name
        g = g.numpy()
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_documents_equal(name):
    assert getattr(tpresets, name)(24, 16) == getattr(jpresets, name)(24, 16)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_loads_bit_exact(name):
    doc = getattr(jpresets, name)(32, 24)
    js, jmeta = jax_scene_from_dict(doc)
    ts, tmeta = scene_from_dict(doc)
    assert tmeta == jmeta
    _assert_same_scene(ts, js)


@pytest.mark.parametrize("name", PRESETS)
def test_scene_from_jax_round_trip(name):
    doc = getattr(jpresets, name)(16, 16)
    js, _ = jax_scene_from_dict(doc)
    carried = tdata.scene_from_jax(js)
    _assert_same_scene(carried, js)
    # jnp leaves carry across to the same numbers as NumPy leaves
    _assert_same_scene(tdata.scene_from_jax(jdata.as_jax(js)), js)
    _assert_same_scene(carried.to("cpu"), js)


def test_load_scene_file_matches_dict(tmp_path):
    doc = jpresets.cornell_box(20, 10)
    path = tmp_path / "cornell.json"
    path.write_text(json.dumps(doc))
    ts, meta = load_scene(str(path))
    js, _ = jax_scene_from_dict(doc)
    assert (meta["width"], meta["height"]) == (20, 10)
    _assert_same_scene(ts, js)


def test_mesh_documents_raise():
    doc = jpresets.cornell_box(8, 8)
    doc["objects"]["meshes"] = [{
        "vertices": [[0, 0, 0], [1, 0, 0], [0, 1, 0]], "faces": [[0, 1, 2]],
        "emission": "dark", "reflectance": "white", "type": "diffuse"}]
    with pytest.raises(NotImplementedError, match="mesh slice"):
        scene_from_dict(doc)


@pytest.mark.parametrize("name", ["cornell_box", "simple_scene"])
def test_scene_static_and_prims_match(name):
    js, _ = jax_scene_from_dict(getattr(jpresets, name)(8, 8))
    ts, _ = scene_from_dict(getattr(tpresets, name)(8, 8))
    jst = jmk.SceneStatic.from_scene(js)
    tst = mk.SceneStatic.from_scene(ts)
    for field in ("rows", "categories", "materials", "emission_idx",
                  "reflectance_idx", "light_rows", "n_spectra",
                  "mesh_parts"):
        assert getattr(tst, field) == getattr(jst, field), field
    np.testing.assert_array_equal(
        mk.pack_prims(ts).numpy(),
        np.asarray(jmk.pack_prims(jdata.as_jax(js))))
