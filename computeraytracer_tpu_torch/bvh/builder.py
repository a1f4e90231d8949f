"""Host-side BVH builder -> flattened skip-link arrays (port of
computeraytracer_tpu/bvh/builder.py, in NumPy as there, so that both
packages build the same arrays bit for bit).

- **Skip-link ("threaded") layout.** Nodes are stored in depth-first
  order; each node carries the index of the node to visit when its
  subtree is skipped (its DFS escape). Traversal then needs no stack:
  ``node = hit && !leaf ? node+1 : miss[node]``, one int of traversal
  state per ray (bvh/traverse.py).
- **Fixed-width leaves.** Each leaf stores up to ``max_leaf`` primitive
  ids, padded with -1 (``leaf_prims (N, K)``), so the in-leaf test is a
  K-wide vector op.
- **Binned SAH** (16 bins over the centroid extent, largest axis) with a
  median-split fallback. The C++ builder (native/) builds the same
  arrays for large meshes.

``to_device`` puts a ``BVHArrays`` (NumPy, or the JAX package's, whose
leaves go through ``np.asarray``) on a torch device as int32 / float32
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_BINS = 16
DEFAULT_MAX_LEAF = 4
# scene_bvh(backend="auto") builds natively from this many primitives.
NATIVE_MIN = 20_000


class BVHArrays(NamedTuple):
    """Flattened BVH, of NumPy arrays or (``to_device``) torch tensors.

    bbox_min/max: (N, 3) f32 node bounds
    miss:         (N,) i32 DFS escape index (N = terminate)
    leaf_prims:   (N, K) i32 primitive ids, -1 padded; inner nodes all -1
    """

    bbox_min: np.ndarray
    bbox_max: np.ndarray
    miss: np.ndarray
    leaf_prims: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


def primitive_bounds(category, data1, data2, data3):
    """Per-primitive AABBs for the tagged SoA layout (scene/data.py).

    patch: hull of {origin, +e1, +e2, +e1+e2}; triangle: hull of its
    three vertices {v0, v1, v2}; sphere: center +- radius.
    """
    category = np.asarray(category)
    d1 = np.asarray(data1, np.float32)
    d2 = np.asarray(data2, np.float32)
    d3 = np.asarray(data3, np.float32)
    corners = np.stack([d1, d1 + d2, d1 + d3, d1 + d2 + d3], axis=1)
    lo = corners.min(axis=1)
    hi = corners.max(axis=1)
    is_tri = (category == 2)[:, None]
    lo = np.where(is_tri, np.minimum(np.minimum(d1, d2), d3), lo)
    hi = np.where(is_tri, np.maximum(np.maximum(d1, d2), d3), hi)
    is_sphere = category == 1
    r = d2[:, 0:1]
    lo = np.where(is_sphere[:, None], d1 - r, lo)
    hi = np.where(is_sphere[:, None], d1 + r, hi)
    return lo.astype(np.float32), hi.astype(np.float32)


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, prims=None):
        self.lo, self.hi = lo, hi
        self.left = self.right = None
        self.prims = prims


def _build_node(ids, lo, hi, cent, max_leaf):
    node_lo = lo[ids].min(axis=0)
    node_hi = hi[ids].max(axis=0)
    n = len(ids)
    if n <= max_leaf:
        return _Node(node_lo, node_hi, prims=ids)

    c = cent[ids]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    axis = int(np.argmax(c_hi - c_lo))
    extent = c_hi[axis] - c_lo[axis]

    split_ids = None
    if extent > 1e-12:
        # binned SAH over the largest centroid axis
        rel = (c[:, axis] - c_lo[axis]) / extent
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        counts = np.bincount(bins, minlength=N_BINS)
        # per-bin bounds -> prefix/suffix areas
        b_lo = np.full((N_BINS, 3), np.inf, np.float32)
        b_hi = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(b_lo, bins, lo[ids])
        np.maximum.at(b_hi, bins, hi[ids])
        pre_lo = np.minimum.accumulate(b_lo, axis=0)
        pre_hi = np.maximum.accumulate(b_hi, axis=0)
        suf_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1]

        def area(alo, ahi):
            d = np.maximum(ahi - alo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        n_left = np.cumsum(counts)[:-1]
        n_right = n - n_left
        cost = (area(pre_lo, pre_hi)[:-1] * n_left
                + area(suf_lo, suf_hi)[1:] * n_right)
        valid = (n_left > 0) & (n_right > 0)
        if valid.any():
            cost = np.where(valid, cost, np.inf)
            best = int(np.argmin(cost))
            go_left = bins <= best
            split_ids = (ids[go_left], ids[~go_left])

    if split_ids is None:
        # median split (degenerate centroids / no valid SAH split)
        order = np.argsort(c[:, axis], kind="stable")
        half = n // 2
        split_ids = (ids[order[:half]], ids[order[half:]])

    node = _Node(node_lo, node_hi)
    node.left = _build_node(split_ids[0], lo, hi, cent, max_leaf)
    node.right = _build_node(split_ids[1], lo, hi, cent, max_leaf)
    return node


def _flatten(root, max_leaf):
    """Emit depth-first order with per-node DFS escape ("miss") links.

    A node's miss link is where traversal resumes when the node's box is
    not hit (or a leaf is done): the left child escapes to its right
    sibling, the right child inherits its parent's escape, the root
    escapes to N (terminate)."""
    bmin, bmax, miss, leafp = [], [], [], []
    sizes = _subtree_sizes(root)

    # iterative DFS; escape=None marks "patch with final N" (root spine)
    stack = [(root, None)]
    while stack:
        node, escape = stack.pop()
        i = len(bmin)
        bmin.append(node.lo)
        bmax.append(node.hi)
        miss.append(escape)
        if node.prims is not None:
            row = np.full(max_leaf, -1, np.int32)
            row[: len(node.prims)] = node.prims
            leafp.append(row)
        else:
            leafp.append(np.full(max_leaf, -1, np.int32))
            right_start = i + 1 + sizes[id(node.left)]
            # LIFO: push right first so left is emitted at i+1
            stack.append((node.right, escape))
            stack.append((node.left, right_start))

    n = len(bmin)
    miss_arr = np.asarray([n if e is None else e for e in miss], np.int32)
    return BVHArrays(
        bbox_min=np.asarray(bmin, np.float32),
        bbox_max=np.asarray(bmax, np.float32),
        miss=miss_arr,
        leaf_prims=np.asarray(leafp, np.int32),
    )


def _subtree_sizes(root) -> dict:
    """id(node) -> node count of its subtree, one post-order pass."""
    sizes = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node.prims is not None:
            sizes[id(node)] = 1
        elif expanded:
            sizes[id(node)] = (1 + sizes[id(node.left)]
                               + sizes[id(node.right)])
        else:
            stack.append((node, True))
            stack.append((node.left, False))
            stack.append((node.right, False))
    return sizes


def build_bvh(category, data1, data2, data3,
              max_leaf: int = DEFAULT_MAX_LEAF) -> BVHArrays:
    """Build a BVH over tagged primitives; returns flattened arrays."""
    import sys

    lo, hi = primitive_bounds(category, data1, data2, data3)
    cent = 0.5 * (lo + hi)
    ids = np.arange(lo.shape[0], dtype=np.int32)
    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(max(limit, 10000))
        root = _build_node(ids, lo, hi, cent, max_leaf)
        return _flatten(root, max_leaf)
    finally:
        sys.setrecursionlimit(limit)


def scene_bvh(scene, max_leaf: int = DEFAULT_MAX_LEAF,
              backend: str = "auto") -> BVHArrays:
    """Build the scene BVH on the host. backend: "numpy", "native" (C++),
    or "auto" (native from NATIVE_MIN primitives, where Python per-node
    overhead bites; the NumPy builder if the native build fails)."""
    p = scene.primitives
    args = tuple(_host(x) for x in (p.category, p.data1, p.data2,
                                    p.data3))
    n = args[0].shape[0]
    if backend == "native" or (backend == "auto" and n >= NATIVE_MIN):
        try:
            from computeraytracer_tpu_torch import native
            return native.build_bvh_native(*args, max_leaf=max_leaf)
        except Exception:
            if backend == "native":
                raise
    return build_bvh(*args, max_leaf)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(bvh, device) -> BVHArrays:
    """The BVH's arrays as tensors on device: float32 boxes, int32 links
    and leaves. Tensors already there are returned as they are."""
    def put(x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(np.asarray(x)))
        return x.to(device=device, dtype=dtype)

    return BVHArrays(bbox_min=put(bvh.bbox_min, torch.float32),
                     bbox_max=put(bvh.bbox_max, torch.float32),
                     miss=put(bvh.miss, torch.int32),
                     leaf_prims=put(bvh.leaf_prims, torch.int32))
