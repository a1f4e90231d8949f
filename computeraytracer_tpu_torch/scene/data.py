"""Scene representation as dataclasses of torch tensors.

Port of computeraytracer_tpu/scene/data.py. Same structure-of-arrays
layout and dtypes as the JAX package:
- category 0 (patch):    data1=origin, data2=edge1, data3=edge2
- category 1 (sphere):   data1=center, data2=(r, r, r), data3 unused
- category 2 (triangle): data1=v0, data2=v1, data3=v2

Every class has ``.to(device)``; the tracer computes on the device its
scene lies on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class _Tensors:
    """``.to(device)`` for a dataclass whose fields are tensors or
    dataclasses of tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class ScenePrimitives(_Tensors):
    category: torch.Tensor     # (P,) int32
    data1: torch.Tensor        # (P, 3) f32
    data2: torch.Tensor        # (P, 3) f32
    data3: torch.Tensor        # (P, 3) f32
    emission: torch.Tensor     # (P,) int32 spectrum index
    reflectance: torch.Tensor  # (P,) int32 spectrum index
    material: torch.Tensor     # (P,) int32 (config.DIFFUSE/LIGHT/...)
    index: torch.Tensor        # (P,) int32 stable global index

    @property
    def count(self) -> int:
        return self.category.shape[0]


@dataclasses.dataclass(frozen=True)
class SceneLights(_Tensors):
    """Emissive primitives; geometry stays in Scene.primitives."""

    prim_index: torch.Tensor  # (L,) int32 global primitive index
    emission: torch.Tensor    # (L,) int32 spectrum index

    @property
    def count(self) -> int:
        return self.prim_index.shape[0]


@dataclasses.dataclass(frozen=True)
class CameraSpec(_Tensors):
    eye: torch.Tensor     # (3,)
    lookat: torch.Tensor  # (3,)
    up: torch.Tensor      # (3,)
    fov: torch.Tensor     # () vertical FOV in radians ("focalLength")


@dataclasses.dataclass(frozen=True)
class Scene(_Tensors):
    primitives: ScenePrimitives
    lights: SceneLights
    camera: CameraSpec
    spectra: torch.Tensor  # (S, 301) f32; the LAST row is the
    #                        Beer-Lambert extinction spectrum
    cie: torch.Tensor      # (3, 471) f32

    @property
    def n_spectra(self) -> int:
        return self.spectra.shape[0]

    @property
    def device(self) -> torch.device:
        return self.spectra.device


def _tensor(x, dtype, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def build_primitives(patches, spheres) -> ScenePrimitives:
    """Flatten typed primitive lists into one tagged SoA list (CPU).

    Patches first, then spheres, with a stable global index — the JAX
    package's build_primitives. Triangles arrive with the mesh slice.
    """
    cats, d1, d2, d3, emi, ref, mat = [], [], [], [], [], [], []
    for p in patches:
        cats.append(0)
        d1.append(p["origin"]); d2.append(p["edge1"]); d3.append(p["edge2"])
        emi.append(p["emission"]); ref.append(p["reflectance"])
        mat.append(p["material"])
    for s in spheres:
        cats.append(1)
        r = float(s["radius"])
        d1.append(s["center"]); d2.append([r, r, r]); d3.append([0.0] * 3)
        emi.append(s["emission"]); ref.append(s["reflectance"])
        mat.append(s["material"])
    n = len(cats)
    if n == 0:
        raise ValueError("scene has no primitives")
    return ScenePrimitives(
        category=_tensor(cats, np.int32),
        data1=_tensor(np.reshape(np.array(d1, np.float32), (-1, 3)),
                      np.float32),
        data2=_tensor(np.reshape(np.array(d2, np.float32), (-1, 3)),
                      np.float32),
        data3=_tensor(np.reshape(np.array(d3, np.float32), (-1, 3)),
                      np.float32),
        emission=_tensor(emi, np.int32),
        reflectance=_tensor(ref, np.int32),
        material=_tensor(mat, np.int32),
        index=torch.arange(n, dtype=torch.int32),
    )


def extract_lights(prims: ScenePrimitives,
                   light_material: int = 1) -> SceneLights:
    """Filter emissive patches into the light list."""
    sel = torch.nonzero(prims.material == light_material).reshape(-1)
    if sel.numel() == 0:
        raise ValueError("scene has no lights")
    if not bool((prims.category[sel] == 0).all()):
        raise ValueError("only planar-patch lights are supported")
    return SceneLights(prim_index=sel.to(torch.int32),
                       emission=prims.emission[sel])


def scene_from_jax(scene, device=None) -> Scene:
    """Carry a JAX package Scene (NumPy or jax-array leaves) across.

    Every leaf goes through ``np.asarray``, so both packages compute on
    identical numbers; dtypes are kept. Needs no jax import here.
    """
    def t(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(device)

    def conv(cls, obj):
        return cls(**{f.name: t(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})

    return Scene(
        primitives=conv(ScenePrimitives, scene.primitives),
        lights=conv(SceneLights, scene.lights),
        camera=conv(CameraSpec, scene.camera),
        spectra=t(scene.spectra),
        cie=t(scene.cie),
    )
