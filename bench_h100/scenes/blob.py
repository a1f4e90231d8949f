"""A procedural mesh generator, NumPy only (a scene document's mesh
entry names it as ``"generator": "blob"``).

A unit icosphere subdivided ``subdivisions`` times (20 * 4^s faces: 6
gives 81,920), displaced radially by a seeded sum of sinusoids along
random directions: a smooth, closed, irregular surface, the same numbers
as the repository's ``displaced_blob``. No configuration uses it: it is
no published scene. The tests drive the reference's mesh path with it.
"""

from __future__ import annotations

import numpy as np


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def _subdivide(verts, faces):
    """1 -> 4 midpoint subdivision, midpoints projected to the sphere."""
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (a, b) if a < b else (b, a)
        if key not in cache:
            m = 0.5 * (np.asarray(verts[a]) + np.asarray(verts[b]))
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts, np.float64), np.asarray(out, np.int64)


def displaced_blob(subdivisions: int, amplitude: float, seed: int):
    """(vertices (V, 3) float64, faces (F, 3) int64) of the blob."""
    v, f = _icosahedron()
    for _ in range(subdivisions):
        v, f = _subdivide(v, f)
    rng = np.random.default_rng(seed)
    r = np.ones(len(v))
    for octave in range(4):
        freq = 1.5 * (2.0 ** octave)
        for _ in range(3):
            dirn = rng.normal(size=3)
            dirn /= np.linalg.norm(dirn)
            phase = rng.uniform(0, 2 * np.pi)
            r += (amplitude / (2.0 ** octave) / 3.0) * np.sin(
                freq * v @ dirn + phase)
    return v * r[:, None], f


def mesh(entry: dict) -> dict:
    """A scene document's mesh entry that names this generator -> the
    entry with its vertices and faces."""
    v, f = displaced_blob(int(entry["subdivisions"]),
                          float(entry["amplitude"]), int(entry["seed"]))
    v = v * float(entry["scale"]) + np.asarray(entry["translate"], np.float64)
    out = {k: entry[k] for k in ("emission", "reflectance", "type")}
    out.update(vertices=v, faces=f)
    return out
