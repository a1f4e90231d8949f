"""Bundled scenes as reference-schema dicts (port of
computeraytracer_tpu/scene/presets.py).

The builders are the JAX package's, line for line, so both packages
load identical scenes. ``tie_mesh_scene`` and ``tie_mesh_rays`` are the
port's own: a scene of exact ties under the mesh tie rule, and rays that
meet them, for the tests of the mesh traversal.
"""

from __future__ import annotations

import math

import numpy as np


def _cornell_spectra() -> dict:
    """Named spectra in insertion order white, green, red, light, dark,
    extinction — the LAST entry is the Beer-Lambert extinction."""
    return {
        "white": {
            "wavelength": [400, 450, 500, 550, 600, 650, 700],
            "value": [0.34, 0.61, 0.70, 0.73, 0.74, 0.73, 0.72],
        },
        "green": {
            "wavelength": [400, 450, 500, 530, 560, 600, 650, 700],
            "value": [0.09, 0.10, 0.31, 0.46, 0.39, 0.22, 0.15, 0.16],
        },
        "red": {
            "wavelength": [400, 450, 500, 550, 600, 650, 700],
            "value": [0.04, 0.05, 0.06, 0.09, 0.38, 0.60, 0.64],
        },
        "light": {
            "wavelength": [400, 500, 600, 700],
            "value": [15.0, 18.0, 15.6, 18.4],
        },
        "dark": {"wavelength": [400, 700], "value": [0.0, 0.0]},
        "extinction": {
            "wavelength": [400, 500, 600, 700],
            "value": [0.0, 0.01, 0.1, 0.01],
        },
    }


def _patch(origin, edge1, edge2, reflectance="white", emission="dark",
           type_="diffuse"):
    return {
        "origin": list(map(float, origin)),
        "edge1": list(map(float, edge1)),
        "edge2": list(map(float, edge2)),
        "emission": emission,
        "reflectance": reflectance,
        "type": type_,
    }


def _box_patches(base_corner, size, angle_deg, reflectance="white"):
    """Five faces (no bottom) of a y-rotated box, as planar patches."""
    sx, sy, sz = size
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)

    def rot(p):
        x, _, z = p
        return np.array(
            [base_corner[0] + c * x + s * z, base_corner[1] + p[1],
             base_corner[2] - s * x + c * z], np.float64)

    p000, p100 = rot((0, 0, 0)), rot((sx, 0, 0))
    p001, p101 = rot((0, 0, sz)), rot((sx, 0, sz))
    up = np.array([0.0, sy, 0.0])
    patches = [_patch(p000 + up, p100 - p000, p001 - p000, reflectance)]
    for q0, q1 in [(p000, p100), (p100, p101), (p101, p001), (p001, p000)]:
        patches.append(_patch(q0, q1 - q0, up, reflectance))
    return patches


def cornell_box(width: int = 512, height: int = 512) -> dict:
    """Classic 555-unit Cornell box: 5 walls + area light + two boxes +
    diffuse/glass spheres (18 primitives)."""
    S = 555.0
    patches = [
        # floor, ceiling
        _patch([0, 0, 0], [0, 0, S], [S, 0, 0], "white"),
        _patch([0, S, 0], [S, 0, 0], [0, 0, S], "white"),
        # area light, coplanar with the ceiling: visible only through
        # last-primitive-wins tie-breaking
        _patch([213, S, 227], [130, 0, 0], [0, 0, 105], "white", "light",
               "light"),
        # back wall, right (red) wall, left (green) wall
        _patch([0, 0, S], [S, 0, 0], [0, S, 0], "white"),
        _patch([S, 0, 0], [0, S, 0], [0, 0, S], "red"),
        _patch([0, 0, 0], [0, 0, S], [0, S, 0], "green"),
    ]
    patches += _box_patches((130, 0, 65), (165, 165, 165), -18.0)
    patches += _box_patches((265, 0, 295), (165, 330, 165), 15.0)
    spheres = [
        {"center": [188.0, 300.0, 300.0], "radius": 60.0,
         "emission": "dark", "reflectance": "red", "type": "diffuse"},
        {"center": [188.0, 240.0, 140.0], "radius": 75.0,
         "emission": "dark", "reflectance": "white", "type": "glass"},
    ]
    return {
        "camera": {
            "eye": [278, 273, -800], "lookat": [278, 273, 0],
            "up": [0, 1, 0], "focalLength": 0.7,
            "width": width, "height": height,
        },
        "objects": {"patches": patches, "spheres": spheres},
        "spectra": _cornell_spectra(),
    }


def simple_scene(width: int = 256, height: int = 256) -> dict:
    """Floor + back wall + one diffuse sphere + one rect light."""
    return {
        "camera": {
            "eye": [0, 1.0, 4.0], "lookat": [0, 1.0, 0],
            "up": [0, 1, 0], "focalLength": 0.9,
            "width": width, "height": height,
        },
        "objects": {
            "patches": [
                _patch([-3, 0, -3], [0, 0, 6], [6, 0, 0], "white"),
                _patch([-3, 0, -3], [6, 0, 0], [0, 4, 0], "white"),
                _patch([-0.8, 3.2, -1.2], [1.6, 0, 0], [0, 0, 1.6],
                       "white", "light", "light"),
            ],
            "spheres": [
                {"center": [0.0, 1.0, 0.0], "radius": 0.8,
                 "emission": "dark", "reflectance": "red", "type": "diffuse"},
            ],
        },
        "spectra": _cornell_spectra(),
    }


def unoccluded_scene(width: int = 256, height: int = 256) -> dict:
    """Floor + back wall + out-of-frustum rect light, no occluders."""
    doc = simple_scene(width, height)
    doc["objects"]["spheres"] = []
    doc["objects"]["patches"] = [
        _patch([-5, 0, -3], [0, 0, 10], [10, 0, 0], "white"),
        _patch([-5, 0, -3], [10, 0, 0], [0, 9, 0], "white"),
        _patch([-1.2, 5.0, -1.6], [2.4, 0, 0], [0, 0, 2.4],
               "white", "light", "light"),
    ]
    return doc


def occluder_scene(width: int = 256, height: int = 256) -> dict:
    """Floating diffuse occluder between light and floor."""
    doc = simple_scene(width, height)
    doc["objects"]["spheres"] = []
    doc["objects"]["patches"] = [
        _patch([-5, 0, -3], [0, 0, 10], [10, 0, 0], "white"),
        _patch([-5, 0, -3], [10, 0, 0], [0, 9, 0], "white"),
        _patch([-0.4, 3.2, -1.0], [0.8, 0, 0], [0, 0, 0.8],
               "white", "light", "light"),
        _patch([-0.4, 1.1, 0.6], [0.8, 0, 0], [0, 0.8, 0], "red"),
    ]
    return doc


def mesh_scene(width: int = 1024, height: int = 1024,
               subdivisions: int = 6) -> dict:
    """Cornell walls and light plus a procedural blob on the floor
    (scene/mesh.py displaced_blob, the stand-in for a scanned mesh).

    subdivisions=6 -> 81,920 triangles; 4 -> 5,120 (test-sized)."""
    from computeraytracer_tpu_torch.scene import mesh as mesh_ops

    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = []
    # drop the boxes; keep walls + light (first 6 patches)
    doc["objects"]["patches"] = doc["objects"]["patches"][:6]
    verts, faces = mesh_ops.displaced_blob(subdivisions)
    verts = mesh_ops.transform(verts, scale=140.0,
                               translate=(278.0, 180.0, 280.0))
    doc["objects"]["meshes"] = [{
        "vertices": verts.tolist(), "faces": faces.tolist(),
        "emission": "dark", "reflectance": "white", "type": "diffuse",
    }]
    return doc


TIE_LAYOUTS = ("edges", "packed", "split")
TIE_GRID = (20, 118, 90, 400)  # cell size, x and y of the first vertex, z
TIE_CELLS = 16  # cells along each side of the grid


def tie_mesh_scene(width: int = 256, height: int = 256,
                   layout: str = "split") -> dict:
    """Cornell walls and light plus a scene of exact ties for the mesh tie
    rule (t < best, or t == best and the higher id): a flat grid of 16 x
    16 squares, two triangles each, facing the camera in the plane
    z = 400, 20 units a cell, every vertex coordinate an integer. A ray
    along z meets every triangle of the grid at the same exact t, and one
    through a shared edge or vertex is inside every triangle there.

    layout:
    - "edges": each triangle once; ties only on shared edges and vertices;
    - "packed": each triangle twice in a row, under two ids (exact
      duplicates); the pairs start at even slots of the Morton order, so
      each pair lies in one chunk of 128;
    - "split": as "packed" with the first triangle three times, so that
      the pairs after it start at odd slots and every chunk boundary among
      them falls inside a pair: its two triangles lie in two chunks.
    """
    if layout not in TIE_LAYOUTS:
        raise ValueError(f"layout must be one of {TIE_LAYOUTS}, not "
                         f"{layout!r}")
    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = []
    doc["objects"]["patches"] = doc["objects"]["patches"][:6]
    step, x0, y0, z = TIE_GRID
    n = TIE_CELLS
    verts = [[x0 + step * i, y0 + step * j, z]
             for j in range(n + 1) for i in range(n + 1)]
    faces = []
    for j in range(n):
        for i in range(n):
            v = j * (n + 1) + i
            w = v + n + 1
            faces += [[v, v + 1, w + 1], [v, w + 1, w]]
    if layout != "edges":
        faces = [f for f in faces for _ in range(2)]
    if layout == "split":
        faces.insert(0, faces[0])
    doc["objects"]["meshes"] = [{
        "vertices": verts, "faces": faces,
        "emission": "dark", "reflectance": "white", "type": "diffuse",
    }]
    return doc


def tie_mesh_rays(n: int, seed: int = 0) -> np.ndarray:
    """(6, n) f32 rays [o, d] at tie_mesh_scene's grid, lane i of kind
    i % 8: along +z from z = 0 through a cell's interior (0), the middle
    of a horizontal (1), vertical (2) or diagonal (3) edge, or a vertex
    (4), each met at t = 400 exactly; along -z from z = 800 through an
    edge or vertex (5); from the camera's eye towards a point inside a
    cell, off its edges (7 and 4 units into the cell) (6); and from a
    random point in the box in a random direction (7). Cells and points
    are drawn from ``seed``. An oblique ray aims off the edges because
    there the inside test holds only under separately rounded products,
    which XLA on the CPU does not keep (it fuses them into FMAs)."""
    step, x0, y0, z = TIE_GRID
    g = np.random.default_rng(seed)
    a = g.integers(0, TIE_CELLS, n)
    b = g.integers(0, TIE_CELLS, n)
    kind = np.arange(n) % 8
    off = np.array([[5, 13], [10, 0], [0, 10], [10, 10], [0, 0]])
    pick = np.where(kind < 5, kind, g.integers(1, 5, n))
    px = x0 + step * a + off[pick, 0]
    py = y0 + step * b + off[pick, 1]
    o = np.stack([px, py, np.where(kind == 5, 2 * z, 0)]).astype(np.float64)
    d = np.zeros((3, n))
    d[2] = np.where(kind == 5, -1.0, 1.0)
    eye = np.array([278.0, 273.0, -800.0])[:, None]
    cam = kind == 6
    o[:, cam] = eye
    d[:, cam] = np.stack([x0 + step * a + 7, y0 + step * b + 4,
                          np.full(n, z)])[:, cam] - eye
    rnd = kind == 7
    o[:, rnd] = g.uniform([0, 0, 0], [556, 548, 559], (n, 3)).T[:, rnd]
    d[:, rnd] = g.standard_normal((3, n))[:, rnd]
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d]).astype(np.float32)


def cornell_box_glassless(width: int = 512, height: int = 512) -> dict:
    """Cornell variant without glass (pure-diffuse estimator tests)."""
    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = [s for s in doc["objects"]["spheres"]
                                 if s["type"] != "glass"]
    return doc
