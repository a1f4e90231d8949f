"""Scene ingestion: the reference JSON schema -> Scene of torch tensors.

Port of computeraytracer_tpu/scene/loader.py for patches and spheres:
- primitives flattened patches first, then spheres, with a stable index;
- spectrum name -> index by insertion order, materials
  diffuse=0/light=1/glass=2/mirror=3;
- spectra resampled to 301 samples at 1nm over 400-700nm;
- the LAST spectrum doubles as the Beer-Lambert extinction.

Documents with ``"meshes"`` raise NotImplementedError until the mesh
slice of the port lands.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.ops import spectrum as spec_ops
from computeraytracer_tpu_torch.scene import data as sd

_MATERIALS = {"diffuse": C.DIFFUSE, "light": C.LIGHT, "glass": C.GLASS,
              "mirror": C.MIRROR}


def _spectra_table(spectra_dict) -> tuple[np.ndarray, dict]:
    """Insertion-order name->index map + dense (S, 301) table."""
    name_to_index = {name: i for i, name in enumerate(spectra_dict)}
    rows = [spec_ops.resample_spectrum(s["wavelength"], s["value"])
            for s in spectra_dict.values()]
    return np.stack(rows).astype(np.float32), name_to_index


def scene_from_dict(doc: dict, cie: Optional[np.ndarray] = None,
                    device=None) -> tuple:
    """Build (Scene, meta) from a parsed scene JSON document.

    meta: {"width", "height", "spectrum_index": {name: idx}}. The scene
    is built on the CPU and moved to ``device``."""
    objects = doc.get("objects", {})
    if objects.get("meshes"):
        raise NotImplementedError(
            "triangle meshes are not ported yet: they arrive with the mesh "
            "slice of computeraytracer_tpu_torch")
    spectra, name_to_index = _spectra_table(doc["spectra"])

    def prim_common(obj):
        return dict(emission=name_to_index[obj["emission"]],
                    reflectance=name_to_index[obj["reflectance"]],
                    material=_MATERIALS[obj["type"]])

    patches = [dict(origin=p["origin"], edge1=p["edge1"], edge2=p["edge2"],
                    **prim_common(p))
               for p in objects.get("patches", [])]
    spheres = [dict(center=s["center"], radius=s["radius"], **prim_common(s))
               for s in objects.get("spheres", [])]
    prims = sd.build_primitives(patches, spheres)
    lights = sd.extract_lights(prims, C.LIGHT)

    cam = doc["camera"]
    camera = sd.CameraSpec(
        eye=torch.from_numpy(np.asarray(cam["eye"], np.float32)),
        lookat=torch.from_numpy(np.asarray(cam["lookat"], np.float32)),
        up=torch.from_numpy(np.asarray(cam["up"], np.float32)),
        fov=torch.from_numpy(np.asarray(cam["focalLength"], np.float32)),
    )
    if cie is None:
        cie = spec_ops.cie_1931_tables()
    scene = sd.Scene(
        primitives=prims,
        lights=lights,
        camera=camera,
        spectra=torch.from_numpy(np.asarray(spectra, np.float32)),
        cie=torch.from_numpy(np.array(cie, np.float32)),
    )
    if device is not None:
        scene = scene.to(device)
    meta = {"width": int(cam["width"]), "height": int(cam["height"]),
            "spectrum_index": name_to_index}
    return scene, meta


def load_scene(path: str, cie_path: Optional[str] = None, device=None):
    """Load a scene JSON file (reference schema). Returns (Scene, meta)."""
    with open(path) as f:
        doc = json.load(f)
    cie = None
    if cie_path is not None:
        with open(cie_path) as f:
            cie_doc = json.load(f)
        cie = np.stack([cie_doc["CIE_X"], cie_doc["CIE_Y"],
                        cie_doc["CIE_Z"]]).astype(np.float32)
    return scene_from_dict(doc, cie, device)
