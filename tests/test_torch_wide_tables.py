"""Scenes of more unrolled rows than the kernels' shared tables hold
(``kernels.megakernel.MAX_PRIMS``), on the CPU.

- The untaped forward takes them: its plain version's blocked scan
  (``_scan_primitives``) gives the row-by-row scan's image at any block
  size, and the port's kernel path renders a seeded scene of the final
  scene of *Ray Tracing: The Next Week*'s procedure
  (``scripts/make_rtnw_final.py``, at a smaller count) as the benchmark's
  plain reference (``bench_h100/reference``) does. Its JAX comparison is
  in tests/test_torch_megakernel.py.
- So does the untaped forward of such a scene with mesh parts: the same
  scene with its ground as one triangle mesh renders as the reference
  does, and the generator's mesh is the committed ground's quads, each
  split in two.
- Every other build refuses them, naming its limit.
- The generator reproduces the committed ``rtnw-final`` and
  ``rtnw-final-mesh`` configurations.
"""

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from computeraytracer_tpu_torch import RenderConfig, scene_from_dict
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_h100.harness import check  # noqa: E402
from bench_h100.reference import ops as ref_ops  # noqa: E402
from bench_h100.reference import scene as ref_scene  # noqa: E402
from bench_h100.reference import tracer as ref_tracer  # noqa: E402


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_rtnw_final", ROOT / "scripts" / "make_rtnw_final.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _generator()
SIDE, DEPTH = 16, 4


@pytest.fixture(scope="module")
def small_doc():
    """6 x 6 ground boxes (216 patches), the light and 100 spheres (94
    white, the six feature spheres): 317 rows, at 16 x 16."""
    doc = GEN.final_scene(boxes_per_side=6, n_spheres=94, width=SIDE,
                          height=SIDE)
    n = len(doc["objects"]["patches"]) + len(doc["objects"]["spheres"])
    assert n == 317 > mk.MAX_PRIMS
    return doc


@pytest.fixture(scope="module")
def small_mesh_doc():
    """6 x 6 ground boxes as one mesh of 432 triangles, the light and 306
    spheres (300 white, the six feature spheres): 307 unrolled rows and a
    mesh part, at 16 x 16."""
    return GEN.final_scene(boxes_per_side=6, n_spheres=300, width=SIDE,
                           height=SIDE, ground_mesh=True)


def _scene(doc):
    scene, _ = scene_from_dict(doc, device="cpu")
    return scene, mk.SceneStatic.from_scene(scene)


def test_blocked_scan_is_the_row_by_row_scan(small_doc, monkeypatch):
    """The plain forward of a wide scene scans its rows in blocks; with one
    row a block (each folded into the running best in turn, the in-order
    scan) it gives the same image bit for bit as with 100 rows a block and
    with a block of each category's rows whole."""
    scene, static = _scene(small_doc)
    assert not static.mesh_parts and len(static.rows) == 317
    px, py = kt.tile_coords(SIDE, SIDE, 0, "cpu")
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, SIDE, SIDE, px, py, 3), static)
    want = mk.forward(static, DEPTH, 1, *args)
    assert float(want.abs().sum()) > 0
    for rows in (1, 100):
        monkeypatch.setattr(mk, "MESH_BLOCK", SIDE * SIDE * rows)
        assert torch.equal(mk.forward(static, DEPTH, 1, *args), want), rows


def test_kernel_path_renders_as_the_reference(small_doc):
    """api.render through the kernel path (its plain version on the CPU)
    against the benchmark's reference on the same samples. The tolerance
    is the render cells' comparison (bench_h100/harness/check.py, the
    checks of cornell-serve4): a pixel is off past 1e-3 relative in XYZ or
    sRGB, and at most 1% of pixels may be off, since a path that parts on
    a rounding difference between the two tracers changes its pixel."""
    _renders_as_the_reference(small_doc)


def test_kernel_path_renders_the_mesh_ground_as_the_reference(
        small_mesh_doc):
    """As above with the ground as one mesh part beside more rows than the
    shared tables hold: the untaped forward's mesh route (its plain
    version's blocked scan, then the part's) against the reference, whose
    triangle runs are scanned as rows."""
    _, static = _scene(small_mesh_doc)
    assert len(static.rows) > mk.MAX_PRIMS and len(static.mesh_parts) == 1
    _renders_as_the_reference(small_mesh_doc)


def _renders_as_the_reference(small_doc):
    scene, _ = _scene(small_doc)
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=2, max_depth=DEPTH,
                       rr_start=1, kernel="pallas", first_sample=5)
    out = api.render(scene, cfg)
    ref = ref_scene.build(small_doc, "cpu")
    px, py = ref_tracer.film_pixels(SIDE, SIDE, "cpu")
    acc = ref_tracer.accumulate(ref, SIDE, SIDE, px, py, 5, 2, DEPTH, 1)
    total = cfg.first_sample + cfg.spp - 1
    assert out["samples"] == total
    answers = [{"accum": out["accum_xyz"].reshape(-1, 3),
                "srgb": out["srgb"].reshape(-1, 3), "samples": total}]
    refs = [{"accum": acc, "srgb": ref_ops.xyz_to_srgb(acc / float(total)),
             "samples": total}]
    cell = type("Cell", (), {"check": {"pixel_tol": 1e-3}})()
    assert float(acc.sum()) > 0
    assert check.serve_numbers(cell, answers, refs)["bad_pixel_share"] <= 0.01


BUILDS = ("taped forward", "winner-taped forward", "retrace backward",
          "tape-fed backward", "shade step")


@pytest.mark.parametrize("build", BUILDS)
def test_other_builds_refuse_wide_scenes(small_doc, build):
    """Only the untaped forward passes MAX_PRIMS; every other build raises
    a message naming itself and the limit."""
    _, static = _scene(small_doc)
    mk._check_static(static, "forward")
    with pytest.raises(ValueError, match=f"the {build} holds at most "
                       f"{mk.MAX_PRIMS} unrolled primitives"):
        mk._check_static(static, build)


@pytest.mark.parametrize("build", BUILDS)
def test_other_builds_refuse_wide_mesh_scenes(small_mesh_doc, build):
    """With mesh parts beside more than MAX_PRIMS rows, the untaped
    forward (the "mesh forward") takes the scene and every other build
    raises a message naming itself, the limit and the builds that still
    refuse."""
    _, static = _scene(small_mesh_doc)
    mk._check_static(static, "mesh forward")
    with pytest.raises(ValueError, match=f"the {build} holds at most "
                       f"{mk.MAX_PRIMS} unrolled primitives .* the taped, "
                       f"winner-taped, XYZ and shade-step builds and both "
                       f"backward kernels do not"):
        mk._check_static(static, build)


def test_wide_mesh_forward_is_its_blocked_scans(small_mesh_doc, monkeypatch):
    """The forward of a wide scene with a mesh part on the CPU (its plain
    version: the unrolled rows' blocked scan, then the mesh part's) gives
    the same image at one row, 100 rows and whole categories a block, and
    its XYZ build and a fit refuse the scene before any work."""
    scene, static = _scene(small_mesh_doc)
    px, py = kt.tile_coords(SIDE, SIDE, 0, "cpu")
    o, d, hero, seed = kt.camera_planes(scene, SIDE, SIDE, px, py, 3)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    want = mk.forward(static, DEPTH, 1, *args, *arrays)
    assert float(want.abs().sum()) > 0
    for rows in (1, 100):
        monkeypatch.setattr(mk, "MESH_BLOCK", SIDE * SIDE * rows)
        assert torch.equal(mk.forward(static, DEPTH, 1, *args, *arrays),
                           want), rows
    with pytest.raises(ValueError, match="XYZ build traces scenes without "
                       "mesh parts"):
        mk.forward_xyz(static, DEPTH, 1, args[0], o, d, seed, args[3],
                       torch.zeros(12, SIDE * SIDE), torch.zeros(3, SIDE *
                                                                 SIDE),
                       torch.zeros(1, dtype=torch.int64))
    scene.spectra.requires_grad_(True)
    with pytest.raises(ValueError, match="winner-taped forward holds at "
                       "most"):
        kt.render_sample(scene, 4, 4, 1, 2)


def test_wrappers_refuse_wide_scenes(small_doc):
    """The taped and winner-taped forwards and the backward kernels refuse
    a wide scene before any work, and a differentiable trace refuses it
    before its forward; the untaped forward's CPU version takes it."""
    scene, static = _scene(small_doc)
    px, py = kt.tile_coords(4, 4, 0, "cpu")
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, 4, 4, px, py, 1),
                            static)
    assert mk.forward(static, 1, 1, *args).shape == (4, 16)
    for fn in (mk.forward_taped, mk.forward_winners):
        with pytest.raises(ValueError, match="kernel bounds"):
            fn(static, 1, 1, *args)
    with pytest.raises(ValueError, match="retrace backward holds at most"):
        mk.backward(static, 1, 1, *args, torch.zeros(4, 16))
    prims = args[0].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="retrace backward holds at most"):
        mk.TraceFn.apply(static, 1, 1, prims, *args[1:])
    with pytest.raises(ValueError, match="taped forward holds at most"):
        mk.TraceTapedFn.apply(static, 1, 1, prims, *args[1:])


def test_generator_reproduces_the_configuration():
    """scripts/make_rtnw_final.py with its seed writes the committed file:
    2,401 patches (400 boxes of six faces and the light), 1,006 spheres,
    one light, 800 x 800, depth 40."""
    path = ROOT / "bench_h100" / "configs" / "rtnw-final.json"
    text = path.read_text()
    assert GEN.dumps(GEN.config()) == text
    cfg = json.loads(text)
    objs = cfg["scene"]["objects"]
    assert len(objs["patches"]) == 2401 and len(objs["spheres"]) == 1006
    lights = [o for o in objs["patches"] + objs["spheres"]
              if o["type"] == "light"]
    assert len(lights) == 1 and lights[0]["origin"] == [123.0, 554.0, 147.0]
    assert (cfg["width"], cfg["height"], cfg["max_depth"]) == (800, 800, 40)
    assert cfg["reduced"] == [] and cfg["source"] == GEN.SOURCE
    assert list(cfg["scene"]["spectra"])[-1] == "dark"


def test_ground_mesh_is_the_committed_ground():
    """The generator's ground mesh covers exactly the committed rtnw-final's
    2,400 ground patches, in their order: each quad (o, e1, e2) gives the
    corners o, o+e1, o+e1+e2, o+e2 and the two triangles (o, o+e1,
    o+e1+e2) and (o, o+e1+e2, o+e2), whose normals point along e1 x e2;
    everything else is rtnw-final's, the light first."""
    plain = json.loads((ROOT / "bench_h100" / "configs"
                        / "rtnw-final.json").read_text())["scene"]
    doc = GEN.final_scene(ground_mesh=True)
    ground = [p for p in plain["objects"]["patches"]
              if p["reflectance"] == "ground"]
    light = [p for p in plain["objects"]["patches"] if p["type"] == "light"]
    assert len(ground) == 2400 and len(light) == 1
    assert doc["objects"]["patches"] == light
    assert doc["objects"]["spheres"] == plain["objects"]["spheres"]
    assert doc["spectra"] == plain["spectra"]
    assert doc["camera"] == plain["camera"]
    (mesh,) = doc["objects"]["meshes"]
    assert (mesh["reflectance"], mesh["emission"], mesh["type"]) == (
        "ground", "dark", "diffuse")
    v = torch.tensor(mesh["vertices"], dtype=torch.float64)
    f = torch.tensor(mesh["faces"])
    assert v.shape == (9600, 3) and f.shape == (4800, 3)
    o, e1, e2 = (torch.tensor([p[k] for p in ground], dtype=torch.float64)
                 for k in ("origin", "edge1", "edge2"))
    corners = torch.stack([o, o + e1, o + e1 + e2, o + e2], dim=1)
    assert torch.allclose(v.view(2400, 4, 3), corners, rtol=0, atol=1e-9)
    quad = torch.arange(2400)[:, None] * 4
    assert torch.equal(f.view(2400, 2, 3), torch.stack(
        [quad + torch.tensor([0, 1, 2]), quad + torch.tensor([0, 2, 3])],
        dim=1))
    tri = v[f]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    want = torch.linalg.cross(e1, e2).repeat_interleave(2, dim=0)
    assert ((n * want).sum(-1) > 0).all()


def test_generator_reproduces_the_mesh_configuration():
    """scripts/make_rtnw_final.py --ground-mesh writes the committed
    rtnw-final-mesh: one mesh part of 4,800 triangles (38 chunks) beside
    1,007 unrolled rows (the light and 1,006 spheres), one light, 800 x
    800, depth 40, nothing reduced."""
    path = ROOT / "bench_h100" / "configs" / "rtnw-final-mesh.json"
    text = path.read_text()
    assert GEN.dumps(GEN.config(ground_mesh=True)) == text
    cfg = json.loads(text)
    assert cfg["reduced"] == [] and cfg["source"] == GEN.SOURCE_MESH
    assert "ground_mesh" in cfg["assumed"]
    assert (cfg["width"], cfg["height"], cfg["max_depth"]) == (800, 800, 40)
    scene, static = _scene(cfg["scene"])
    assert len(static.rows) == 1007 and len(static.light_rows) == 1
    (part,) = static.mesh_parts
    assert (part.start, part.count, part.n_chunks) == (1007, 4800, 38)
