"""A scene document of the reference schema -> the reference's tensors.

Primitives are flattened patches first, then spheres, then the triangles
of each mesh, with a stable index; spectra are resampled to 1 nm over
400-700 nm in insertion order, and the last one is also the extinction of
glass (Beer-Lambert). Mesh entries hold vertices and faces (lists or
arrays). Every float tensor is made in the dtype asked for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_h100.reference import ops

_MATERIALS = {"diffuse": ops.DIFFUSE, "light": ops.LIGHT,
              "glass": ops.GLASS, "mirror": ops.MIRROR}


@dataclasses.dataclass(frozen=True)
class Prims:
    category: torch.Tensor
    data1: torch.Tensor
    data2: torch.Tensor
    data3: torch.Tensor
    emission: torch.Tensor
    reflectance: torch.Tensor
    material: torch.Tensor
    index: torch.Tensor
    # (category, first row, end row) of each run of one category
    runs: tuple


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: torch.Tensor
    lookat: torch.Tensor
    up: torch.Tensor
    fov: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Scene:
    prims: Prims
    light_prims: torch.Tensor     # (L,) primitive rows of the lights
    light_emission: torch.Tensor  # (L,) their emission spectra
    camera: Camera
    spectra: torch.Tensor         # (S, 301)
    cie: torch.Tensor             # (3, 471)

    @property
    def dtype(self):
        return self.spectra.dtype

    def with_leaves(self, spectra=None, data1=None):
        """The scene with spectra and the primitives' data1 replaced."""
        prims = self.prims
        if data1 is not None:
            prims = dataclasses.replace(prims, data1=data1)
        return dataclasses.replace(
            self, prims=prims,
            spectra=self.spectra if spectra is None else spectra)


def _runs(category: np.ndarray) -> tuple:
    runs, start = [], 0
    for i in range(1, len(category) + 1):
        if i == len(category) or category[i] != category[start]:
            runs.append((int(category[start]), start, i))
            start = i
    return tuple(runs)


def build(doc: dict, device, dtype=torch.float32) -> Scene:
    objs = doc["objects"]
    names = {name: i for i, name in enumerate(doc["spectra"])}
    spectra = np.stack([ops.resample_spectrum(s["wavelength"], s["value"])
                        for s in doc["spectra"].values()])
    cat, d1, d2, d3, emi, ref, mat = [], [], [], [], [], [], []

    def common(o, n):
        emi.append(np.full(n, names[o["emission"]]))
        ref.append(np.full(n, names[o["reflectance"]]))
        mat.append(np.full(n, _MATERIALS[o["type"]]))

    for p in objs.get("patches", []):
        cat.append(np.zeros(1))
        d1.append([p["origin"]]); d2.append([p["edge1"]])
        d3.append([p["edge2"]])
        common(p, 1)
    for s in objs.get("spheres", []):
        r = float(s["radius"])
        cat.append(np.ones(1))
        d1.append([s["center"]]); d2.append([[r, r, r]]); d3.append([[0.0] * 3])
        common(s, 1)
    for m in objs.get("meshes", []):
        v = np.asarray(m["vertices"], np.float32)
        f = np.asarray(m["faces"], np.int64)
        cat.append(np.full(len(f), 2))
        d1.append(v[f[:, 0]]); d2.append(v[f[:, 1]]); d3.append(v[f[:, 2]])
        common(m, len(f))

    def f32(rows):
        return np.concatenate([np.asarray(r, np.float32).reshape(-1, 3)
                               for r in rows])

    def i64(rows):
        return np.concatenate(rows).astype(np.int64)

    category = i64(cat)
    fl = dict(dtype=dtype, device=device)
    it = dict(dtype=torch.int64, device=device)
    prims = Prims(
        category=torch.tensor(category, **it),
        data1=torch.tensor(f32(d1), **fl), data2=torch.tensor(f32(d2), **fl),
        data3=torch.tensor(f32(d3), **fl),
        emission=torch.tensor(i64(emi), **it),
        reflectance=torch.tensor(i64(ref), **it),
        material=torch.tensor(i64(mat), **it),
        index=torch.arange(len(category), **it), runs=_runs(category))
    lights = torch.nonzero(prims.material == ops.LIGHT).reshape(-1)
    cam = doc["camera"]
    camera = Camera(*(torch.tensor(np.asarray(cam[k], np.float32), **fl)
                      for k in ("eye", "lookat", "up", "focalLength")))
    return Scene(prims=prims, light_prims=lights,
                 light_emission=prims.emission[lights], camera=camera,
                 spectra=torch.tensor(spectra, **fl),
                 cie=torch.tensor(ops.cie_1931_tables(), **fl))
