"""The reference's cluster scan of long triangle runs against its linear
scan: the same winners and distances, exact ties included."""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from bench_h100.harness import cells  # noqa: E402
from bench_h100.reference import ops  # noqa: E402
from bench_h100.reference import scene as ref_scene  # noqa: E402
from bench_h100.reference import tracer  # noqa: E402

BENCH = cells.load_benchmark()


def blob_doc(subdivisions):
    """The Cornell box's patches around a blob of 20 * 4^subdivisions
    triangles (``scenes/blob.py``), its spheres left out."""
    c = cells.cell(BENCH, "cornell-serve4")
    objects = c.config["scene"]["objects"]
    objects["spheres"] = []
    objects["meshes"] = [{
        "generator": "blob", "subdivisions": subdivisions, "amplitude": 0.25,
        "seed": 7, "scale": 140.0, "translate": [278.0, 180.0, 280.0],
        "emission": "dark", "reflectance": "white", "type": "diffuse"}]
    return cells.scene_doc(c)


def _both(prims, o, d, exclude):
    linear = tracer._search(prims, o, d, exclude, clustered_min=10 ** 9)
    clustered = tracer._search(prims, o, d, exclude, clustered_min=1)
    return linear, clustered


@pytest.mark.parametrize("subdivisions", [3, 4])
def test_cluster_scan_is_the_linear_scan(subdivisions):
    scene = ref_scene.build(blob_doc(subdivisions), "cpu")
    g = torch.Generator().manual_seed(subdivisions)
    n = 8000
    o = torch.rand(n, 3, generator=g) * torch.tensor([555.0, 548.0, 559.0])
    d = ops.safe_normalize(torch.randn(n, 3, generator=g))
    eye = torch.tensor([278.0, 273.0, -800.0])
    aim = (torch.tensor([278.0, 180.0, 280.0])
           + 120.0 * torch.randn(n // 2, 3, generator=g))
    o[:n // 2], d[:n // 2] = eye, ops.safe_normalize(aim - eye)
    exclude = torch.randint(-1, scene.prims.index.numel(), (n,), generator=g)
    exclude[::3] = -1
    (w0, t0), (w1, t1) = _both(scene.prims, o, d, exclude)
    assert torch.isfinite(t0).sum() > n // 2
    assert torch.equal(w0, w1) and torch.equal(t0, t1)


def test_cluster_scan_resolves_exact_ties_as_the_linear_scan():
    """A grid of squares at z = 400, each triangle twice under two rows,
    more than one cluster long: a ray along z through a vertex or an edge
    meets many triangles at the same distance, in several clusters; the
    last row wins."""
    step, cells_n, z = 20.0, 12, 400.0
    verts = [[100 + step * i, 100 + step * j, z]
             for j in range(cells_n + 1) for i in range(cells_n + 1)]
    faces = []
    for j in range(cells_n):
        for i in range(cells_n):
            v = j * (cells_n + 1) + i
            w = v + cells_n + 1
            faces += [[v, v + 1, w + 1], [v, w + 1, w]] * 2
    doc = blob_doc(1)
    # nothing else in the rays' way: the boxes stand between z = 0 and 400
    doc["objects"]["patches"] = []
    doc["objects"]["meshes"] = [{"vertices": verts, "faces": faces,
                                 "emission": "dark", "reflectance": "white",
                                 "type": "diffuse"}]
    scene = ref_scene.build(doc, "cpu")
    assert len(faces) > tracer.CLUSTER
    xs = 100 + step * torch.arange(cells_n + 1, dtype=torch.float32)
    # through vertical edges (x on the grid, y mid-cell) and vertices
    ex, ey = torch.meshgrid(xs, xs[:-1] + 10.0, indexing="xy")
    vx, vy = torch.meshgrid(xs, xs, indexing="xy")
    pts = torch.stack([torch.cat([ex.flatten(), vx.flatten()]),
                       torch.cat([ey.flatten(), vy.flatten()])], 1)
    o = torch.cat([pts, torch.zeros(len(pts), 1)], 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand_as(o).contiguous()
    exclude = torch.full((len(o),), -1)
    (w0, t0), (w1, t1) = _both(scene.prims, o, d, exclude)
    assert torch.isfinite(t0).all() and (t0 == z).all()
    assert torch.equal(w0, w1) and torch.equal(t0, t1)


def test_scan_of_no_rays():
    scene = ref_scene.build(blob_doc(2), "cpu")
    o = torch.zeros(0, 3)
    for clustered_min in (1, 10 ** 9):
        w, t = tracer._search(scene.prims, o, o, torch.zeros(0, dtype=int),
                              clustered_min=clustered_min)
        assert w.shape == (0,) and t.shape == (0,)
