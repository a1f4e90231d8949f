"""Bundled scenes as reference-schema dicts (port of
computeraytracer_tpu/scene/presets.py).

The builders are the JAX package's, line for line, so both packages
load identical scenes. ``mesh_scene`` arrives with the mesh slice.
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


def cornell_box_glassless(width: int = 512, height: int = 512) -> dict:
    """Cornell variant without glass (pure-diffuse estimator tests)."""
    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = [s for s in doc["objects"]["spheres"]
                                 if s["type"] != "glass"]
    return doc
