#!/usr/bin/env python3
"""Write the benchmark's configurations ``rtnw-final`` and
``rtnw-final-mesh``: the final scene of Peter Shirley's *Ray Tracing: The
Next Week* (v4, raytracing.github.io), ``final_scene(800, 10000, 40)``, as
a scene document of the reference schema.

    python3 scripts/make_rtnw_final.py [--ground-mesh] [--out PATH]

``--ground-mesh`` writes ``rtnw-final-mesh``: the same scene with its
ground boxes as one triangle mesh (below); the default path is
``bench_h100/configs/<name>.json``.

The book's procedure, with its random draws made by numpy from SEED in
the book's order (the 400 box heights, then the 1,000 sphere centers):
- 20 x 20 ground boxes, each 100 wide and deep, from y = 0 to a height
  uniform in [1, 101); each box is six patches, the book's ``box()``
  quads in its order and orientation (2,400 patches);
- one quad light, origin (123, 554, 147), edges (300, 0, 0) and
  (0, 0, 265), emission 7;
- six feature spheres: diffuse (0.7, 0.3, 0.1) at (400, 400, 200),
  radius 50; glass at (260, 150, 45), 50; metal at (0, 150, 145), 50; the
  glass boundary at (360, 150, 145), 70; the earth at (400, 200, 400),
  100; the noise sphere at (220, 280, 300), 80;
- 1,000 white (0.73) spheres of radius 10, centers uniform in [0, 165)^3,
  rotated 15 degrees about y and translated by (-100, 270, 395);
- the camera: 800 x 800, vfov 40 degrees (the schema's ``focalLength``
  is the vertical field of view in radians), eye (478, 278, -600),
  lookat (278, 278, 0), up (0, 1, 0); a black background (a miss adds
  nothing); depth 40.

What the schema cannot hold is substituted, and ``assumed`` lists each
substitution. ``final_scene(boxes_per_side=, n_spheres=, ...)`` makes the
same scene at a smaller count, for tests.

With ``ground_mesh``, the boxes' quads, in the book's order, are one
``"meshes"`` entry of material ``ground`` instead of patches: each quad
(o, e1, e2) gives its four corners o, o+e1, o+e1+e2, o+e2 and the two
triangles (o, o+e1, o+e1+e2) and (o, o+e1+e2, o+e2), split along the
diagonal from o and wound as e1 x e2 (4,800 triangles at 20 x 20 boxes).
The light stays a patch, now the first row.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "bench_h100" / "configs"
SEED = 20240831
SOURCE = ("Ray Tracing: The Next Week, v4 (raytracing.github.io), "
          "final_scene(800, 10000, 40): 400 ground boxes, 1,000 spheres of "
          "radius 10, a quad light, six feature spheres")
SOURCE_MESH = ("Ray Tracing: The Next Week, v4 (raytracing.github.io), "
               "final_scene(800, 10000, 40): its 400 ground boxes as one "
               "mesh of 4,800 triangles, 1,006 spheres, a quad light")
# RGB albedos and emissions as three bands: 400-489, 490-579, 580-700 nm
# (the 1 nm table the loaders resample to)
BANDS_NM = (400, 489, 490, 579, 580, 700)


def band_spectrum(r: float, g: float, b: float) -> dict:
    """An RGB colour as a spectrum of three bands: blue, green, red."""
    return {"wavelength": list(BANDS_NM), "value": [b, b, g, g, r, r]}


def constant_spectrum(v: float) -> dict:
    return {"wavelength": [400, 700], "value": [v, v]}


def box_faces(lo, hi) -> list:
    """The book's box(): six quads (origin, edge1, edge2), in its order."""
    dx, dy, dz = ([hi[0] - lo[0], 0.0, 0.0], [0.0, hi[1] - lo[1], 0.0],
                  [0.0, 0.0, hi[2] - lo[2]])
    neg = lambda v: [-c for c in v]  # noqa: E731
    return [([lo[0], lo[1], hi[2]], dx, dy),        # front
            ([hi[0], lo[1], hi[2]], neg(dz), dy),   # right
            ([hi[0], lo[1], lo[2]], neg(dx), dy),   # back
            ([lo[0], lo[1], lo[2]], dz, dy),        # left
            ([lo[0], hi[1], hi[2]], dx, neg(dz)),   # top
            ([lo[0], lo[1], lo[2]], dx, dz)]        # bottom


def _r(x) -> float:
    return float(round(float(x), 4)) + 0.0


def quad_mesh(quads) -> dict:
    """Quads (origin, edge1, edge2) as one mesh: each quad's corners o,
    o+e1, o+e1+e2, o+e2 and its triangles (o, o+e1, o+e1+e2), (o, o+e1+e2,
    o+e2), wound as e1 x e2."""
    vertices, faces = [], []
    for o, e1, e2 in quads:
        corners = (o, [a + b for a, b in zip(o, e1)],
                   [a + b + c for a, b, c in zip(o, e1, e2)],
                   [a + b for a, b in zip(o, e2)])
        k = len(vertices)
        vertices += [[_r(c) for c in v] for v in corners]
        faces += [[k, k + 1, k + 2], [k, k + 2, k + 3]]
    return {"vertices": vertices, "faces": faces, "emission": "dark",
            "reflectance": "ground", "type": "diffuse"}


def final_scene(boxes_per_side: int = 20, n_spheres: int = 1000,
                seed: int = SEED, width: int = 800, height: int = 800,
                ground_mesh: bool = False) -> dict:
    """The scene document; the ground keeps its 2,000 x 2,000 extent
    whatever boxes_per_side. ground_mesh: the ground as one triangle mesh
    (``quad_mesh``) instead of patches."""
    rng = np.random.default_rng(seed)
    w = 2000.0 / boxes_per_side
    heights = rng.uniform(1.0, 101.0, size=(boxes_per_side, boxes_per_side))
    centers = rng.uniform(0.0, 165.0, size=(n_spheres, 3))

    def patch(origin, e1, e2, spectrum, kind="diffuse", emission="dark"):
        return {"origin": [_r(c) for c in origin],
                "edge1": [_r(c) for c in e1], "edge2": [_r(c) for c in e2],
                "emission": emission, "reflectance": spectrum, "type": kind}

    def sphere(center, radius, spectrum, kind="diffuse"):
        return {"center": [_r(c) for c in center], "radius": float(radius),
                "emission": "dark", "reflectance": spectrum, "type": kind}

    ground = []
    for i in range(boxes_per_side):
        for j in range(boxes_per_side):
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            lo, hi = [x0, 0.0, z0], [x0 + w, _r(heights[i, j]), z0 + w]
            ground += [patch(o, e1, e2, "ground")
                       for o, e1, e2 in box_faces(lo, hi)]
    light = patch([123, 554, 147], [300, 0, 0], [0, 0, 265], "dark",
                  "light", "light")
    patches = [light] if ground_mesh else ground + [light]
    spheres = [sphere([400, 400, 200], 50, "orange"),
               sphere([260, 150, 45], 50, "clear", "glass"),
               sphere([0, 150, 145], 50, "metal", "mirror"),
               sphere([360, 150, 145], 70, "clear", "glass"),
               sphere([400, 200, 400], 100, "earth"),
               sphere([220, 280, 300], 80, "noise")]
    th = math.radians(15.0)
    cos, sin = math.cos(th), math.sin(th)
    for x, y, z in centers:
        # the book's rotate_y maps object to world as (cos x + sin z, y,
        # -sin x + cos z), then translate adds the offset
        spheres.append(sphere([cos * x + sin * z - 100.0, y + 270.0,
                               -sin * x + cos * z + 395.0], 10, "white"))
    spectra = {
        "ground": band_spectrum(0.48, 0.83, 0.53),
        "white": constant_spectrum(0.73),
        "light": constant_spectrum(7.0),
        "orange": band_spectrum(0.7, 0.3, 0.1),
        "metal": band_spectrum(0.8, 0.8, 0.9),
        "clear": constant_spectrum(1.0),
        "earth": band_spectrum(0.25, 0.3, 0.45),
        "noise": constant_spectrum(0.5),
        # last: also the extinction of glass (Beer-Lambert): clear glass
        "dark": constant_spectrum(0.0),
    }
    objects = {"patches": patches, "spheres": spheres}
    if ground_mesh:
        objects["meshes"] = [quad_mesh(
            (p["origin"], p["edge1"], p["edge2"]) for p in ground)]
    return {"camera": {"eye": [478, 278, -600], "lookat": [278, 278, 0],
                       "up": [0, 1, 0], "focalLength": math.radians(40.0),
                       "width": width, "height": height},
            "objects": objects, "spectra": spectra}


def config(ground_mesh: bool = False) -> dict:
    """The configuration file's object: rtnw-final, or with ground_mesh
    rtnw-final-mesh."""
    assumed = {
        "seed": f"numpy default_rng({SEED}): the box heights (row by "
                "row of the book's loop), then the sphere centers",
        "motion_blur": "dropped: the moving sphere stays at its first "
                       "center (400, 400, 200)",
        "media": "the two constant media (the blue subsurface and the "
                 "global fog) dropped; the boundary sphere stays as "
                 "clear glass",
        "textures": "the earth becomes the constant diffuse (0.25, 0.3, "
                    "0.45), the noise texture its mean, 0.5 grey",
        "metal": "metal (0.8, 0.8, 0.9) of fuzz 1.0 becomes the schema's "
                 "mirror, the port's only metal, which reflects all "
                 "light",
        "spectra": "RGB albedos and emissions become spectra of three "
                   "bands: blue 400-489 nm, green 490-579, red 580-700",
        "extinction": "the last spectrum, dark (0), is glass's "
                      "extinction: clear glass, as the book's",
        "rr_start": "Russian roulette past depth 1, as in cornell (the "
                    "book has none)",
        "precision": "float32, no matrix products (TF32 does not apply)",
    }
    if ground_mesh:
        assumed["ground_mesh"] = (
            "the 2,400 quads of the 400 ground boxes, in the book's order, "
            "as one mesh of material ground: each quad (o, e1, e2) split "
            "along its diagonal from o into the triangles (o, o+e1, "
            "o+e1+e2) and (o, o+e1+e2, o+e2), wound as e1 x e2; the light "
            "is the first patch")
    return {
        "source": SOURCE_MESH if ground_mesh else SOURCE,
        "reduced": [],
        "assumed": assumed,
        "precision": "float32",
        "width": 800,
        "height": 800,
        "max_depth": 40,
        "rr_start": 1,
        "scene": final_scene(ground_mesh=ground_mesh),
    }


def _mesh_lines(m: dict) -> str:
    """A mesh entry, one line per quad: its four corners, its two faces."""
    one = json.dumps
    head = {k: v for k, v in m.items() if k not in ("vertices", "faces")}
    v, f = m["vertices"], m["faces"]
    corners = ",\n".join("      " + ", ".join(one(x) for x in v[k:k + 4])
                         for k in range(0, len(v), 4))
    faces = ",\n".join("      " + ", ".join(one(x) for x in f[k:k + 2])
                       for k in range(0, len(f), 2))
    return ("    {" + one(head)[1:-1] + ",\n"
            '     "vertices": [\n' + corners + "\n     ],\n"
            '     "faces": [\n' + faces + "\n     ]}")


def dumps(cfg: dict) -> str:
    """The file's text: one line per primitive, per spectrum and per quad
    of a mesh."""
    one = lambda v: json.dumps(v)  # noqa: E731
    scene = cfg["scene"]
    top = [f' {one(k)}: {one(v)}' for k, v in cfg.items() if k != "scene"]

    def rows(items, indent):
        return (",\n".join(indent + x for x in items))

    objs = scene["objects"]
    meshes = ""
    if "meshes" in objs:
        meshes = (',\n   "meshes": [\n'
                  + ",\n".join(_mesh_lines(m) for m in objs["meshes"])
                  + "\n   ]")
    body = (' "scene": {\n'
            f'  "camera": {one(scene["camera"])},\n'
            '  "objects": {\n'
            '   "patches": [\n'
            + rows([one(p) for p in objs["patches"]], "    ") + "\n   ],\n"
            '   "spheres": [\n'
            + rows([one(s) for s in objs["spheres"]], "    ") + "\n   ]"
            + meshes + "\n"
            "  },\n"
            '  "spectra": {\n'
            + rows([f"{one(k)}: {one(v)}"
                    for k, v in scene["spectra"].items()], "   ")
            + "\n  }\n }")
    return "{\n" + ",\n".join(top + [body]) + "\n}\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ground-mesh", action="store_true",
                    help="write rtnw-final-mesh: the ground as one mesh")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = "rtnw-final-mesh" if args.ground_mesh else "rtnw-final"
    out = pathlib.Path(args.out) if args.out else CONFIGS / f"{name}.json"
    out.write_text(dumps(config(args.ground_mesh)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
