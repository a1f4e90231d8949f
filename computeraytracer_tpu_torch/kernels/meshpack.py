"""Chunk BVH packing of triangle meshes (port of
computeraytracer_tpu/kernels/meshpack.py).

A mesh part is cut into chunks of 128 Morton-ordered triangles, each
with its AABB, under a complete binary BVH over groups of LEAF_CHUNKS
chunks. The tree is complete (groups padded to a power of two), so its
STRUCTURE (DFS order, skip links, leaf ranges) is a function of the
chunk count alone and is planned once on the host with NumPy
(``make_plan``); every BOX is a torch reduction over the live vertices
(``pack_from_plan``), on the vertices' device.

Packed layout (the JAX package's, array for array):
  tri_rows   (n_rows, 128) f32: each row holds 8 triangles x 16 words
             [v0.xyz, v1.xyz, v2.xyz, prim_id, unit normal.xyz, 3 pad];
             16 rows are one chunk; only real chunks are stored.
  chunk_bbox (n_chunks, 8) f32: [lo.xyz, hi.xyz, pad, pad].
  node_bbox  (n_nodes, 8) f32, DFS order: [lo.xyz, hi.xyz, pad, pad].
  node_meta  (n_nodes, 8) i32, DFS order: [skip, chunk_start, is_leaf,
             5 pad]; a leaf covers chunks [chunk_start,
             chunk_start + LEAF_CHUNKS).
Padding triangles have id -1 and zero geometry; empty padded chunks and
nodes get the degenerate far box lo == hi == BIG.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from computeraytracer_tpu_torch.ops.camera import sqrt

TRIS_PER_ROW = 8
LANES_PER_TRI = 16
ROWS_PER_CHUNK = 16
TRIS_PER_CHUNK = TRIS_PER_ROW * ROWS_PER_CHUNK  # 128
LEAF_CHUNKS = 4          # chunks per BVH leaf (512 triangles)
BIG = np.float32(3e37)   # degenerate empty-box coordinate


class MeshPlan(NamedTuple):
    """Host-side packing plan: Morton order and tree structure, a
    function of the initial geometry only."""

    order: np.ndarray        # (N,) Morton sort permutation of triangles
    n: int                   # real triangle count
    n_chunks: int            # padded chunk count = n_groups * LEAF_CHUNKS
    n_groups: int            # leaf groups (power of two)
    perm: np.ndarray         # (n_nodes,) level-stacked index per DFS slot
    meta: np.ndarray         # (n_nodes, 8) i32 [skip, chunk_start, leaf]

    @property
    def n_nodes(self) -> int:
        return self.meta.shape[0]


class MeshPack(NamedTuple):
    tri_rows: torch.Tensor    # (n_rows, 128) f32
    chunk_bbox: torch.Tensor  # (n_chunks, 8) f32
    node_bbox: torch.Tensor   # (n_nodes, 8) f32  (DFS order)
    node_meta: torch.Tensor   # (n_nodes, 8) i32  (DFS order)

    @property
    def n_chunks(self) -> int:
        return self.chunk_bbox.shape[0]

    @property
    def arrays(self):
        return (self.tri_rows, self.chunk_bbox, self.node_bbox,
                self.node_meta)


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z -> 30-bit Morton codes. q: (N, 3) uint32."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def _dfs_structure(n_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """DFS preorder of the complete binary tree over n_groups leaves.

    Returns (perm, meta): perm[d] = level-stacked index ((2^k - 1) + j)
    of the node at DFS slot d; meta[d] = [skip, chunk_start, is_leaf,
    0...], skip being the DFS index just past the node's subtree."""
    depth = int(n_groups).bit_length() - 1  # n_groups = 2^depth
    n_nodes = 2 * n_groups - 1
    perm = np.zeros(n_nodes, np.int64)
    meta = np.zeros((n_nodes, 8), np.int32)
    stack = [(0, 0)]  # (level, j)
    d = 0
    while stack:
        k, j = stack.pop()
        leaves_below = n_groups >> k
        subtree = 2 * leaves_below - 1
        perm[d] = (1 << k) - 1 + j
        is_leaf = k == depth
        meta[d, 0] = d + subtree                       # skip
        meta[d, 1] = j * leaves_below * LEAF_CHUNKS    # chunk_start
        meta[d, 2] = 1 if is_leaf else 0
        if not is_leaf:
            # preorder: left child next -> push right first
            stack.append((k + 1, 2 * j + 1))
            stack.append((k + 1, 2 * j))
        d += 1
    return perm, meta


def make_plan(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> MeshPlan:
    """Morton-sort triangle centroids and lay out the chunk BVH."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    n = v0.shape[0]

    cent = (v0 + v1 + v2) / 3.0
    lo, hi = cent.min(0), cent.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.minimum(((cent - lo) / ext) * 1023.0, 1023.0).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")

    n_chunks_real = max(1, -(-n // TRIS_PER_CHUNK))
    n_groups = 1
    while n_groups * LEAF_CHUNKS < n_chunks_real:
        n_groups *= 2
    n_chunks = n_groups * LEAF_CHUNKS
    perm, meta = _dfs_structure(n_groups)
    return MeshPlan(order=order, n=n, n_chunks=n_chunks,
                    n_groups=n_groups, perm=perm, meta=meta)


def pack_from_plan(plan: MeshPlan, v0, v1, v2, prim_ids) -> MeshPack:
    """Pack live geometry (torch tensors, (N, 3) f32, and (N,) ids) under
    a fixed plan, on the geometry's device. No gradient flows through the
    pack: the kernels treat it as a constant."""
    v0, v1, v2 = (torch.as_tensor(v).detach().to(torch.float32)
                  for v in (v0, v1, v2))
    dev = v0.device
    n, n_chunks = plan.n, plan.n_chunks
    n_pad = n_chunks * TRIS_PER_CHUNK
    order = torch.from_numpy(np.asarray(plan.order, np.int64)).to(dev)

    def padded(a):
        out = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
        out[:n] = a[order]
        return out

    v0s, v1s, v2s = padded(v0), padded(v1), padded(v2)
    ids = torch.full((n_pad,), -1.0, dtype=torch.float32, device=dev)
    ids[:n] = torch.as_tensor(prim_ids).to(dev)[order].to(torch.float32)

    # only REAL chunks get triangle storage: padded chunks sit behind far
    # boxes that the traversal never enters
    n_real = max(1, -(-n // TRIS_PER_CHUNK)) * TRIS_PER_CHUNK
    comp = torch.zeros((n_real, LANES_PER_TRI), dtype=torch.float32,
                       device=dev)
    comp[:, 0:3] = v0s[:n_real]
    comp[:, 3:6] = v1s[:n_real]
    comp[:, 6:9] = v2s[:n_real]
    comp[:, 9] = ids[:n_real]
    # words 10-12: the unit normal, with the kernels' formula; padding
    # triangles keep n == 0, which the plane test rejects as grazing
    e1 = v1s[:n_real] - v0s[:n_real]
    e2 = v2s[:n_real] - v0s[:n_real]
    n_raw = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    n_len2 = (n_raw[:, 0] * n_raw[:, 0] + n_raw[:, 1] * n_raw[:, 1]
              + n_raw[:, 2] * n_raw[:, 2])
    inv_len = 1.0 / sqrt(torch.clamp(n_len2, min=1e-30))
    comp[:, 10:13] = n_raw * inv_len[:, None]
    tri_rows = comp.reshape(n_real // TRIS_PER_ROW,
                            TRIS_PER_ROW * LANES_PER_TRI)

    # triangle AABBs -> chunk AABBs; padding triangles excluded through
    # +-inf, empty chunks collapsed to the degenerate far box
    corners = torch.stack([v0s, v1s, v2s], dim=1)
    valid = (ids >= 0)[:, None]
    inf = torch.tensor(float("inf"), device=dev)
    t_lo = torch.where(valid, corners.amin(1), inf)
    t_hi = torch.where(valid, corners.amax(1), -inf)
    c_lo = t_lo.reshape(n_chunks, TRIS_PER_CHUNK, 3).amin(1)
    c_hi = t_hi.reshape(n_chunks, TRIS_PER_CHUNK, 3).amax(1)
    empty = ~torch.isfinite(c_lo[:, :1])
    big = torch.tensor(float(BIG), device=dev)
    c_lo = torch.where(empty, big, c_lo)
    c_hi = torch.where(empty, big, c_hi)
    chunk_bbox = torch.zeros((n_chunks, 8), dtype=torch.float32, device=dev)
    chunk_bbox[:, 0:3] = c_lo
    chunk_bbox[:, 3:6] = c_hi

    # node boxes: reduction pyramid over the chunk boxes, root level first
    lvl_lo = [c_lo.reshape(plan.n_groups, LEAF_CHUNKS, 3).amin(1)]
    lvl_hi = [c_hi.reshape(plan.n_groups, LEAF_CHUNKS, 3).amax(1)]
    while lvl_lo[0].shape[0] > 1:
        lvl_lo.insert(0, lvl_lo[0].reshape(-1, 2, 3).amin(1))
        lvl_hi.insert(0, lvl_hi[0].reshape(-1, 2, 3).amax(1))
    perm = torch.from_numpy(np.asarray(plan.perm, np.int64)).to(dev)
    node_bbox = torch.zeros((plan.n_nodes, 8), dtype=torch.float32,
                            device=dev)
    node_bbox[:, 0:3] = torch.cat(lvl_lo, dim=0)[perm]
    node_bbox[:, 3:6] = torch.cat(lvl_hi, dim=0)[perm]
    node_meta = torch.from_numpy(np.asarray(plan.meta, np.int32)).to(dev)
    return MeshPack(tri_rows=tri_rows.contiguous(), chunk_bbox=chunk_bbox,
                    node_bbox=node_bbox, node_meta=node_meta)


def pack_mesh(v0, v1, v2, prim_ids) -> MeshPack:
    """One-shot pack (plan + pack) for concrete geometry."""
    plan = make_plan(*(torch.as_tensor(v).detach().cpu().numpy()
                       for v in (v0, v1, v2)))
    return pack_from_plan(plan, v0, v1, v2, prim_ids)


def plan_scene_mesh(scene, part) -> MeshPlan:
    """Plan of one SceneStatic mesh part (rows [start, start+count))."""
    p = scene.primitives
    s, c = part.start, part.count
    return make_plan(*(d[s:s + c].detach().cpu().numpy()
                       for d in (p.data1, p.data2, p.data3)))


def pack_scene_mesh(scene, part, plan: MeshPlan | None = None) -> MeshPack:
    """Pack one SceneStatic mesh part on the scene's device."""
    p = scene.primitives
    s, c = part.start, part.count
    if plan is None:
        plan = plan_scene_mesh(scene, part)
    return pack_from_plan(plan, p.data1[s:s + c], p.data2[s:s + c],
                          p.data3[s:s + c],
                          torch.arange(s, s + c, device=p.data1.device))
