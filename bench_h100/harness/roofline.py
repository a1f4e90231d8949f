"""The least time one frame or step of trace work could take on one H100:
the larger of its bytes over the memory bandwidth and its operations over
the float32 rate (NVIDIA's data sheet, SXM part, 700 W).

Counts come from the benchmark's own reference and the scene document,
never from the program, so they read the same work whatever kernels carry
it:
- operations: one closest-hit scan per live bounce and one shadow scan
  per next-event ray after a diffuse scatter, as the reference traces
  them; a scan costs 35 float operations per patch, sphere or unrolled
  triangle, and a mesh part of ``MESH_MIN`` triangles or more at least
  ceil(log2 T) box tests of 24 (three slabs), one triangle plane of 14
  and one inside test of 32 (a floor no traversal goes under). A fit
  step counts its forward's scans and twice as many for its backward.
- bytes: the scene's primitive table, spectra and CIE tables read once,
  and what the entry must write once: a render's accumulated XYZ, mean
  XYZ and sRGB images; a fit's target read, and its gradients and
  updated leaves written.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PRIM_TEST_OPS = 35
BOX_TEST_OPS = 24
TRI_PLANE_OPS = 14
TRI_INSIDE_OPS = 32
# triangles of a mesh below which its rows are scanned one by one
MESH_MIN = 256
PRIM_BYTES = 9 * 4 + 4 * 4   # three vectors, four integer columns
N_LAMBDA, CIE_N = 301, 471
BACKWARD_SCANS = 2


def scan_ops(doc: dict) -> int:
    """Float operations of one closest-hit or shadow scan of the scene."""
    objs = doc["objects"]
    rows = len(objs.get("patches", [])) + len(objs.get("spheres", []))
    ops = rows * PRIM_TEST_OPS
    for m in objs.get("meshes", []):
        n = len(m["faces"])
        if n >= MESH_MIN:
            ops += (math.ceil(math.log2(n)) * BOX_TEST_OPS + TRI_PLANE_OPS
                    + TRI_INSIDE_OPS)
        else:
            ops += n * PRIM_TEST_OPS
    return ops


def n_prims(doc: dict) -> int:
    objs = doc["objects"]
    return (len(objs.get("patches", [])) + len(objs.get("spheres", []))
            + sum(len(m["faces"]) for m in objs.get("meshes", [])))


def least(entry: str, counts: dict, doc: dict, width: int, height: int,
          trainable: tuple = ()) -> dict:
    """{seconds, bound_by, ops, bytes} of one unit whose reference trace
    made counts {closest, shadow} casts."""
    P = n_prims(doc)
    S = len(doc["spectra"])
    film = width * height * 3 * 4
    read = P * PRIM_BYTES + S * N_LAMBDA * 4 + 3 * CIE_N * 4
    ops = (counts["closest"] + counts["shadow"]) * scan_ops(doc)
    if entry == "render":
        nbytes = read + 3 * film
    else:
        leaves = {"spectra": S * N_LAMBDA * 4, "data1": P * 3 * 4}
        nbytes = read + film + 2 * sum(leaves[k] for k in trainable)
        ops *= 1 + BACKWARD_SCANS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return {"seconds": max(t_bytes, t_ops), "ops": ops, "bytes": nbytes,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
