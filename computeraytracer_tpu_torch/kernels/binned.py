"""Mesh casts of the binned wavefront: plain torch versions, CUDA wrappers
and the orchestration around them (port of
computeraytracer_tpu/kernels/binned.py).

A binned cast finds each ray's closest mesh hit (or, for a shadow ray,
whether any triangle lies before the light) in three passes per mesh
part, then finishes the rays it could not settle with the exact walk:

1. candidates (``build_candidate_kernel``, binned.py:215): each ray's k
   nearest chunk AABBs by padded slab entry distance, culled by the
   occlusion bound, and ``t_next``, the entry distance of the first chunk
   left out. ``candidates`` pads the boxes to whole supernodes of
   ``SUP_CHUNKS``, pre-pads the bound by 8 ulp and marks inactive lanes
   with a bound of -inf; its ``candidate_kernel`` runs
   ``candidates_reference`` (the dense pass of binned.py:111, blocked
   over ``CAND_BLOCK`` chunks) on CPU tensors and launches
   ``csrc/candidates.cu`` on CUDA tensors.
2. pairs: the (ray, slot) pairs sorted by chunk id (``torch.sort`` on the
   u32-valued key held as int64, dead pairs last), scanned by
   ``pair_intersect`` (``build_pair_kernel``, binned.py:392; closest hit
   under the mesh tie rule) or ``pair_occluded``
   (``build_pair_kernel_occl``, binned.py:898; any hit at t <= t_light);
   CPU tensors run ``pair_reference`` / ``pair_occluded_reference``, CUDA
   tensors launch the two instantiations of ``csrc/pair.cu``.
3. reduce: the k slots folded with ``_merge_tie``; a ray is resolved when
   its hit precedes every omitted chunk (t <= t_next), or nothing was
   omitted.

``_walk_finish`` gathers the unresolved rays into one of two compaction
tiers (sorted by direction octant and origin Morton code) or, beyond the
larger, walks the whole film; every finish runs the seeded walk
(``build_walk_kernel``, binned.py:640): ``walk_reference`` on the CPU,
``csrc/walk.cu`` on the card. ``mesh_closest_hit`` / ``mesh_occluded`` run
one cast over every part; their ``_batched`` forms compact the live rays
to a prefix and cast it in batches when the population is sparse
(binned.py:1114-1299). The tracer's wavefront (``tracer.kernel
.wavefront_forward``) casts through them.

Seeds of the walk: t = -inf marks an inactive lane, which comes back
unchanged (binned.py:866 ``walk_compact``; the JAX ``walk_full`` fallback,
binned.py:803-817, seeds inactive rays with their stale winner and can
return real hits there, and the port's does not). A finite t with idx -1
bounds the cast: only hits at t <= bound are taken.

Host reads. Where the JAX package branches on a device value (``lax.cond``,
``while_loop``), the port reads the count on the host once: the live rays
of a cast (``count_live``: none, dense or the batch count) and the
unresolved rays of a pipeline (none, the tier or the full walk).
``host_reads`` counts them; nothing else here synchronises. ``cast_log``,
when set to a list, receives one entry per cast and per pipeline (read by
``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.ops import intersect as isect

T_MIN = mk.T_MIN
# Candidate chunks per ray (the JAX package's r5 choice: every pipeline cost
# scales with R * k, and rays with more candidates fall to the walk).
DEFAULT_K = 6
CAND_KS = (1, 4, 6)   # the k values csrc/candidates.cu is built for
CAND_BLOCK = 1024     # chunks per block of the dense candidate pass
SUP_CHUNKS = 16       # chunks per supernode of the candidate kernel
TILE = 1024           # the TPU's (8, 128) ray tile: sizes tiers and batches
PAIR_BLOCK = 8192     # pairs per block of the plain pair scans
PAD_BOX = 4 * 2.0 ** -23    # slab interval pad (Ize 2013)
PAD_BOUND = 8 * 2.0 ** -23  # pre-pad of the occlusion bound
DEAD_KEY = 0xFFFFFFFF       # sort key of a dead pair or an empty walk slot

# Launches of each kernel, counted where its wrapper launches it.
launches_walk = 0
launches_candidates = 0
launches_pair = 0
launches_pair_occl = 0

# Host reads of device counts (see the module docstring).
host_reads = 0

# None, or a list that receives the casts' entries: {"cast": "closest" or
# "any", "rays", "live", "batches"} per batched wrapper call (batches 0: the
# dense pipeline), then {"pipeline": kind, "rays", "parts", "live",
# "pairs", "unres", "finish"} per pipeline (live and pairs as device
# scalars; finish None, a tier size or "full").
cast_log = None


def _read(x) -> int:
    """One host read of a device count."""
    global host_reads
    host_reads += 1
    return int(x)


def count_live(mask: torch.Tensor) -> int:
    """The number of live lanes of a cast, read on the host."""
    return _read(mask.sum())


def _log(**entry):
    if cast_log is not None:
        cast_log.append(entry)


def logged_launches(log) -> dict:
    """The kernel launches that the casts of a ``cast_log`` list made: per
    pipeline, one candidate and one pair launch (``pair`` for a closest-hit
    cast, ``pair_occl`` for an any-hit one) per mesh part, and one walk when
    it finished unresolved rays."""
    n = dict.fromkeys(("candidates", "pair", "pair_occl", "walk"), 0)
    for e in log:
        if "pipeline" in e:
            n["candidates"] += e["parts"]
            n["pair" if e["pipeline"] == "closest" else "pair_occl"] += \
                e["parts"]
            n["walk"] += e["finish"] is not None
    return n


def _w(work, name):
    return None if work is None else work.get(name)


def new_work(device) -> dict:
    """Zeroed work counters for every kernel of a cast (the counting
    builds): {"candidates", "pair", "pair_any", "walk"} ->
    (mk.WORK_KINDS,) int64."""
    return {name: torch.zeros(mk.WORK_KINDS, dtype=torch.int64,
                              device=device)
            for name in ("candidates", "pair", "pair_any", "walk")}


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def _inv_dir(d):
    """Reciprocal direction of the slab tests: |d| < 1e-12 -> +-1e30."""
    tiny = d.abs() < 1e-12
    sign = torch.where(d < 0.0, -1.0, 1.0)
    return torch.where(tiny, sign * 1e30, 1.0 / torch.where(tiny, 1.0, d))


def _slab_t_enter(cbox_blk, o, d, t_bound, inv=None):
    """Padded entry distance of each ray into each box, +inf where the box
    is missed, exited before T_MIN or entered beyond t_bound (binned.py:72).

    cbox_blk (B, 8) [lo.xyz, hi.xyz, pad, pad]; o, d (3, R); t_bound (R,).
    Returns (B, R), chunk-major; the arithmetic of bounce.cuh
    ``slab_enter``: an axis the ray runs parallel to bounds nothing where
    lo <= o <= hi and misses the box elsewhere."""
    if inv is None:
        inv = _inv_dir(d)
    B, R = cbox_blk.shape[0], o.shape[1]
    t_enter = torch.full((B, R), -math.inf, dtype=torch.float32,
                         device=o.device)
    t_exit = torch.full((B, R), math.inf, dtype=torch.float32,
                        device=o.device)
    for c in range(3):
        lo, hi = cbox_blk[:, c, None], cbox_blk[:, 3 + c, None]
        par = (inv[c].abs() == 1e30)[None]
        inside = (lo <= o[c][None]) & (o[c][None] <= hi)
        t0 = torch.where(par, torch.where(inside, -math.inf, math.inf),
                         (lo - o[c][None]) * inv[c][None])
        t1 = torch.where(par, math.inf, (hi - o[c][None]) * inv[c][None])
        t_enter = torch.maximum(t_enter, torch.minimum(t0, t1))
        t_exit = torch.minimum(t_exit, torch.maximum(t0, t1))
    t_exit = t_exit + t_exit.abs() * PAD_BOX
    t_enter = t_enter - t_enter.abs() * PAD_BOX
    ok = ((t_enter <= t_exit) & (t_exit >= T_MIN)
          & (t_enter <= t_bound[None]) & (t_enter < math.inf))
    return torch.where(ok, t_enter, math.inf)


def _pad_bound(t_bound, R, device):
    if t_bound is None:
        return torch.full((R,), math.inf, dtype=torch.float32, device=device)
    return t_bound + t_bound.abs() * PAD_BOUND


def candidates_reference(rays7, chunk_bbox, k: int):
    """The candidate kernel's contract, as the dense pass of binned.py:111
    ``candidate_chunks``: rays7 (7, R) [o, d, bound] with the bound
    pre-padded (-inf: inactive lane), chunk_bbox (C, 8) the real chunk
    boxes -> (cand (k, R) i32, t_next (R,) f32).

    cand holds each lane's k smallest (t_enter, chunk id) pairs in
    ascending lexicographic order, padded with -1; t_next the (k+1)-th
    smallest t_enter, +inf when every candidate fit. An inactive lane
    enters no box: no candidates, t_next = +inf. Blocks of CAND_BLOCK
    chunks bound the (C, R) entry matrix: each block's entries are merged
    into the running k + 1 best by a stable sort (equal entries keep the
    lower id, which comes first)."""
    R = rays7.shape[1]
    dev = rays7.device
    o, d, bound = rays7[0:3], rays7[3:6], rays7[6]
    inv = _inv_dir(d)
    best_t = torch.full((k + 1, R), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((k + 1, R), -1, dtype=torch.int64, device=dev)
    for a in range(0, chunk_bbox.shape[0], CAND_BLOCK):
        blk = chunk_bbox[a:a + CAND_BLOCK]
        te = _slab_t_enter(blk, o, d, bound, inv)
        ids = torch.arange(a, a + blk.shape[0], device=dev)[:, None]
        all_t = torch.cat([best_t, te])
        all_i = torch.cat([best_i, ids.expand(blk.shape[0], R)])
        best_t, order = torch.sort(all_t, dim=0, stable=True)
        best_t = best_t[:k + 1]
        best_i = all_i.gather(0, order[:k + 1])
    cand = torch.where(torch.isfinite(best_t[:k]), best_i[:k], -1)
    return cand.to(torch.int32), best_t[k].contiguous()


WARP = 32  # lanes of a warp of csrc/candidates.cu
DENSE_LANES = 12  # csrc/candidates.cu: a supernode this many lanes enter
                  # is tested lane by lane, not drained


def _insert(entries_t, entries_i, k: int):
    """The k-slot insertion of csrc/candidates.cu (there each slot is
    placed by its own comparison, here by a compare-swap chain: the same
    slots), one entry per step along dim 0 of entries_t / entries_i (E,
    R), +inf / -1 where a ray has no entry (a padding entry changes
    nothing) -> (slot_t (k, R), slot_i (k, R), t_next (R,)): ascending by
    t_enter, equal entries by the lower chunk id, t_next the least evicted
    t_enter."""
    R = entries_t.shape[1]
    dev = entries_t.device
    slot_t = [torch.full((R,), math.inf, device=dev) for _ in range(k)]
    slot_i = [torch.full((R,), -1, dtype=torch.int64, device=dev)
              for _ in range(k)]
    t_next = torch.full((R,), math.inf, device=dev)
    for t_new, i_new in zip(entries_t, entries_i):
        for j in range(k):
            swap = (t_new < slot_t[j]) | ((t_new == slot_t[j])
                                          & (i_new < slot_i[j]))
            slot_t[j], t_new = (torch.where(swap, t_new, slot_t[j]),
                                torch.where(swap, slot_t[j], t_new))
            slot_i[j], i_new = (torch.where(swap, i_new, slot_i[j]),
                                torch.where(swap, slot_i[j], i_new))
        t_next = torch.minimum(t_next, t_new)
    return torch.stack(slot_t), torch.stack(slot_i), t_next


def candidates_drained_reference(rays7, chunk_bbox, k: int, order=None):
    """Plain model of the warp-drained schedule of csrc/candidates.cu,
    used by no path on the card: rays7 (7, R) and chunk_bbox (C, 8) as
    ``candidates_reference``'s -> (cand (k, R) i32, t_next (R,) f32,
    schedule dict), equal to ``candidates_reference``.

    Lanes are rays r, warps the WARP consecutive lanes. Per group of 32
    supernodes: each active lane's mask of the supernodes it enters
    (``schedule["masks"]``, (n_groups, R) int64); first the dense
    supernodes, entered by DENSE_LANES lanes of the warp or more, in
    ascending order, each lane that entered one testing its chunks for
    its own ray; then the warp's other (lane, supernode) items in rank
    order (by lane, then supernode), taken two per pass, each tested
    against its owner's ray on the supernode's SUP_CHUNKS chunk boxes. The
    entries that pass queue at their owner in the order they are found
    (chunks ascending within a supernode), and the owner inserts them in
    that order. ``order``, a torch.Generator, shuffles each ray's queue
    first instead (the insertion is order-free). ``schedule``: the masks,
    the chunk loop's warp trips (``warp_trips``: a dense supernode's
    chunks and the drain's passes, summed over warps) and its chunk tests
    (``lane_trips``)."""
    R = rays7.shape[1]
    dev = rays7.device
    C = chunk_bbox.shape[0]
    o, d, bound = rays7[0:3], rays7[3:6], rays7[6]
    active = bound > -math.inf
    cboxes, sboxes = _supernodes(chunk_bbox)
    n_sup = sboxes.shape[0]
    inv = _inv_dir(d)
    entered = ((_slab_t_enter(sboxes, o, d, bound, inv) < math.inf)
               & active[None]).cpu()
    te = _slab_t_enter(cboxes, o, d, bound, inv).cpu()
    n_groups = -(-n_sup // 32)
    masks = torch.zeros((n_groups, R), dtype=torch.int64)
    for s in range(n_sup):
        masks[s // 32] |= entered[s].to(torch.int64) << (s % 32)
    mask_of = masks.tolist()
    passed = (te < math.inf).T.tolist()  # (R, n_sup * SUP_CHUNKS)
    real = [max(min(SUP_CHUNKS, C - s * SUP_CHUNKS), 0) for s in range(n_sup)]
    queues = [[] for _ in range(R)]
    warp_trips = lane_trips = 0
    for w0 in range(0, R, WARP):
        lanes = range(w0, min(w0 + WARP, R))
        for g in range(n_groups):
            dense = 0
            for b in range(min(32, n_sup - 32 * g)):
                n = sum((mask_of[g][r] >> b) & 1 for r in lanes)
                if n < DENSE_LANES:
                    continue
                dense |= 1 << b
                s = 32 * g + b
                warp_trips += real[s]
                for r in lanes:
                    if (mask_of[g][r] >> b) & 1:
                        lane_trips += real[s]
                        c0 = s * SUP_CHUNKS
                        queues[r] += [c for c in range(c0, c0 + real[s])
                                      if passed[r][c]]
            items = [(r, 32 * g + b) for r in lanes for b in range(32)
                     if ((mask_of[g][r] & ~dense) >> b) & 1]
            for p in range(0, len(items), 2):
                warp_trips += 1
                for r, s in items[p:p + 2]:
                    c0 = s * SUP_CHUNKS
                    lane_trips += real[s]
                    queues[r] += [c for c in range(c0, c0 + real[s])
                                  if passed[r][c]]
    if order is not None:
        queues = [[q[i] for i in torch.randperm(len(q), generator=order)]
                  for q in queues]
    E = max((len(q) for q in queues), default=0)
    ids = torch.full((E, R), -1, dtype=torch.int64)
    for r, q in enumerate(queues):
        ids[:len(q), r] = torch.tensor(q, dtype=torch.int64)
    ent_t = torch.where(ids >= 0, te.gather(0, ids.clamp(min=0)), math.inf)
    _, slot_i, t_next = _insert(ent_t, ids, k)
    schedule = {"masks": masks, "warp_trips": warp_trips,
                "lane_trips": lane_trips}
    return (slot_i.to(torch.int32).to(dev), t_next.to(dev), schedule)


def candidate_trips(rays7, chunk_bbox) -> dict:
    """The candidate pass's chunk-loop trips on rays7 (7, R) and chunk_bbox
    (C, 8), from the lanes' supernode masks alone (any device): the chunk
    tests (``lane_trips``), the chunk loop's warp trips of csrc/
    candidates.cu (``warp_trips``: per warp and group of 32 supernodes,
    the chunks of each supernode that DENSE_LANES lanes or more entered,
    and half its other entered items, rounded up: the drain's passes) and
    the one-thread pass's chunk-loop trips
    (``warp_trips_one_thread``: the real chunks of every supernode that any
    lane of a warp entered). SIMT efficiency is lane trips over 32 per
    warp trip."""
    R = rays7.shape[1]
    C = chunk_bbox.shape[0]
    dev = rays7.device
    _, sboxes = _supernodes(chunk_bbox)
    n_sup = sboxes.shape[0]
    G = -(-n_sup // 32)
    W = -(-R // WARP)
    entered = ((_slab_t_enter(sboxes, rays7[0:3], rays7[3:6], rays7[6])
                < math.inf) & (rays7[6] > -math.inf)[None])
    entered = torch.nn.functional.pad(
        entered, (0, W * WARP - R, 0, 32 * G - n_sup)).reshape(
            G, 32, W, WARP).to(torch.int64)
    real = (C - SUP_CHUNKS * torch.arange(32 * G, device=dev)).clamp(
        0, SUP_CHUNKS).reshape(G, 32, 1, 1)
    lanes = entered.sum(dim=3, keepdim=True)          # (G, 32, W, 1)
    dense = lanes >= DENSE_LANES
    items = torch.where(dense, 0, lanes).sum(dim=(1, 3))
    return {"lane_trips": int((entered * real).sum()),
            "warp_trips": int((dense * real).sum() + ((items + 1) // 2).sum()),
            "warp_trips_one_thread": int(
                (entered.amax(dim=3, keepdim=True) * real).sum())}


def _supernodes(chunk_bbox):
    """(cboxes (n_sup * SUP_CHUNKS, 8), sboxes (n_sup, 8)): the chunk boxes
    padded to whole supernodes with meshpack.BIG boxes, and each
    supernode's box over its chunks (binned.py:353-361)."""
    C = chunk_bbox.shape[0]
    c_pad = -(-C // SUP_CHUNKS) * SUP_CHUNKS
    cboxes = chunk_bbox
    if c_pad != C:
        fill = torch.zeros((c_pad - C, 8), dtype=torch.float32,
                           device=chunk_bbox.device)
        fill[:, 0:6] = float(meshpack.BIG)
        cboxes = torch.cat([chunk_bbox, fill])
    grp = cboxes.reshape(-1, SUP_CHUNKS, 8)
    sboxes = torch.zeros((grp.shape[0], 8), dtype=torch.float32,
                         device=chunk_bbox.device)
    sboxes[:, 0:3] = grp[:, :, 0:3].amin(dim=1)
    sboxes[:, 3:6] = grp[:, :, 3:6].amax(dim=1)
    return cboxes.contiguous(), sboxes


def candidates(chunk_bbox, rays, t_bound=None, k: int | None = None,
               active=None, work: torch.Tensor | None = None):
    """Candidate pass of one mesh part (binned.py:345
    ``candidate_chunks_pallas``): chunk_bbox (C, 8) the part's real chunk
    boxes, rays (6, R) [o, d], t_bound (R,) the occlusion bound, active
    (R,) bool -> (cand (k, R) i32, t_next (R,) f32), the contract of
    ``candidates_reference``.

    The bound is pre-padded by 8 ulp, so that a bound from differently
    rounded arithmetic never drops the true winner's chunk, and inactive
    lanes get -inf; ``candidate_kernel`` runs the pass."""
    k = DEFAULT_K if k is None else int(k)
    R = rays.shape[-1] if rays.dim() == 2 else -1
    mk._check_tensor("rays", rays, (6, R), torch.float32, rays.device)
    bound = _pad_bound(t_bound, R, rays.device)
    if active is not None:
        bound = torch.where(active, bound, -math.inf)
    return candidate_kernel(torch.cat([rays, bound[None]]), chunk_bbox, k,
                            work=work)


def candidate_kernel(rays7, chunk_bbox, k: int,
                     work: torch.Tensor | None = None):
    """The candidate kernel's wrapper: rays7 (7, R) [o, d, bound] (bound
    pre-padded, -inf inactive), chunk_bbox (C, 8) -> (cand (k, R) i32,
    t_next (R,) f32), the contract of ``candidates_reference``.

    CPU tensors run ``candidates_reference``; CUDA tensors launch
    csrc/candidates.cu over the boxes padded to whole supernodes; a failed
    build or launch raises. k is one of CAND_KS, on either device.
    ``work``, a zeroed (mk.WORK_KINDS,) int64 CUDA tensor, selects the
    build that also adds its active rays and slab tests to it (columns 0
    and 1)."""
    global launches_candidates
    R = rays7.shape[-1] if rays7.dim() == 2 else -1
    dev = rays7.device
    mk._check_tensor("rays7", rays7, (7, R), torch.float32, dev)
    mk._check_tensor("chunk_bbox", chunk_bbox, (chunk_bbox.shape[0], 8),
                     torch.float32, dev)
    if k not in CAND_KS:
        raise ValueError(f"k = {k}: the candidate kernel is built for k in "
                         f"{CAND_KS}")
    if work is not None:
        mk._check_tensor("work", work, (mk.WORK_KINDS,), torch.int64, dev)
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("work counts are taken on the card: the plain "
                             "version counts nothing")
        return candidates_reference(rays7, chunk_bbox, k)
    mk._require_cuda(dev)
    fn = mk._fn("candidates", "candidates")
    cboxes, sboxes = _supernodes(chunk_bbox)
    cand = torch.empty((k, R), dtype=torch.int32, device=dev)
    t_next = torch.empty((R,), dtype=torch.float32, device=dev)
    mk._launch("candidates", fn, dev, rays7.data_ptr(), cboxes.data_ptr(),
               sboxes.data_ptr(), cand.data_ptr(), t_next.data_ptr(), R,
               chunk_bbox.shape[0], sboxes.shape[0], k,
               None if work is None else work.data_ptr())
    launches_candidates += 1
    return cand, t_next


# ---------------------------------------------------------------------------
# pair scans
# ---------------------------------------------------------------------------


def _pair_scan(pair_f, pair_i, tri_rows, fn):
    """Run fn(lanes, o, d, exclude, blk) over the live pairs in blocks of
    PAIR_BLOCK, blk (n, 128, 16) the triangles of each pair's chunk. A
    pair is live when its chunk id is in [0, n_chunks)."""
    n_chunks = tri_rows.shape[0] // meshpack.ROWS_PER_CHUNK
    tri = tri_rows.reshape(n_chunks, meshpack.TRIS_PER_CHUNK,
                           meshpack.LANES_PER_TRI)
    chunk = pair_i[0].to(torch.int64)
    live = torch.nonzero((chunk >= 0) & (chunk < n_chunks))[:, 0]
    for a in range(0, live.shape[0], PAIR_BLOCK):
        lanes = live[a:a + PAIR_BLOCK]
        col = lambda x: x[lanes][:, None]
        o = tuple(col(pair_f[c]) for c in range(3))
        d = tuple(col(pair_f[3 + c]) for c in range(3))
        fn(lanes, o, d, col(pair_i[1].to(torch.int64)), tri[chunk[lanes]])


def _pair_valid(o, d, exclude, blk):
    """(t, flip, valid) of every triangle of each pair's chunk: the
    walk's per-triangle tests (megakernel._scan_mesh_part), range t >=
    T_MIN."""
    w = lambda k: blk[:, :, k]
    v0, v1, v2 = (w(0), w(1), w(2)), (w(3), w(4), w(5)), (w(6), w(7), w(8))
    tid = blk[:, :, 9].to(torch.int64)
    t, flip, grazing = isect.plane_t((w(10), w(11), w(12)), v0, o, d)
    wt = isect.watertight_setup(o, d)
    valid = ((exclude != tid) & (tid >= 0) & ~grazing
             & isect.watertight_inside(wt, v0, v1, v2) & (t >= T_MIN))
    return t, flip, valid, tid


def pair_reference(pair_f, pair_i, tri_rows):
    """Plain closest hit of each (ray, chunk) pair: pair_f (7, P) [o, d,
    unused], pair_i (2, P) i32 [chunk (-1 dead), exclude], tri_rows
    (n_chunks * 16, 128) -> (out_f (4, P) [t, n.xyz], out_i (1, P) i32).

    Over the chunk's 128 triangles, the least (t, -id) of the valid hits
    (the mesh tie rule), its normal facing the ray; (+inf, 0, -1) where
    nothing is hit, the chunk is dead or at or beyond n_chunks."""
    P = pair_f.shape[1]
    out_f = torch.zeros((4, P), dtype=torch.float32, device=pair_f.device)
    out_f[0] = math.inf
    out_i = torch.full((1, P), -1, dtype=torch.int32, device=pair_f.device)

    def scan(lanes, o, d, exclude, blk):
        t, flip, valid, tid = _pair_valid(o, d, exclude, blk)
        tv = torch.where(valid, t, math.inf)
        t_best = tv.amin(dim=1)
        cand = valid & (tv == t_best[:, None])
        id_best = torch.where(cand, tid, -1).amax(dim=1)
        j = (cand & (tid == id_best[:, None])).to(torch.int8).argmax(dim=1)
        rows = torch.arange(blk.shape[0], device=blk.device)
        sgn = torch.where(flip[rows, j], -1.0, 1.0)
        hit = id_best >= 0
        out_f[0, lanes] = torch.where(hit, t_best, math.inf)
        for c in range(3):
            out_f[1 + c, lanes] = torch.where(hit, sgn * blk[rows, j, 10 + c],
                                              0.0)
        out_i[0, lanes] = id_best.to(torch.int32)

    _pair_scan(pair_f, pair_i, tri_rows, scan)
    return out_f, out_i


def pair_occluded_reference(pair_f, pair_i, tri_rows):
    """Plain any-hit of each (ray, chunk) pair: pair_f (7, P) [o, d,
    t_light], pair_i and tri_rows as ``pair_reference``'s -> flag (1, P)
    i32, 1 where a valid hit has t <= t_light (exactly where the closest
    hit's t <= t_light)."""
    P = pair_f.shape[1]
    flag = torch.zeros((1, P), dtype=torch.int32, device=pair_f.device)

    def scan(lanes, o, d, exclude, blk):
        t, _, valid, _ = _pair_valid(o, d, exclude, blk)
        hit = (valid & (t <= pair_f[6, lanes][:, None])).any(dim=1)
        flag[0, lanes] = hit.to(torch.int32)

    _pair_scan(pair_f, pair_i, tri_rows, scan)
    return flag


def pair_scan_order_reference(pair_f, pair_i, tri_rows, any_hit: bool):
    """Plain model of the order in which csrc/pair.cu scans a pair's
    chunk, used by no path on the card: the 128 triangles one at a time;
    for each, its id (padding, the excluded triangle), the grazing test,
    the watertight inside test and only then, for a triangle the ray
    passes through, the plane's t and its range: T_MIN <= t and (t, id)
    beating the running best under the tie rule, or, for any_hit, t <=
    t_light, where the scan stops. -> pair_reference's outputs (any_hit
    False) or pair_occluded_reference's flag (True), which it equals: a
    hit needs every test, whatever their order."""
    P = pair_f.shape[1]
    dev = pair_f.device
    out_f = torch.zeros((4, P), dtype=torch.float32, device=dev)
    out_f[0] = math.inf
    out_i = torch.full((1, P), -1, dtype=torch.int32, device=dev)
    flag = torch.zeros((1, P), dtype=torch.int32, device=dev)

    def scan(lanes, o, d, exclude, blk):
        o, d = tuple(x[:, 0] for x in o), tuple(x[:, 0] for x in d)
        wt = isect.watertight_setup(o, d)
        n = lanes.shape[0]
        best_t = torch.full((n,), math.inf, device=dev)
        best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_n = [torch.zeros(n, device=dev) for _ in range(3)]
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        t_light = pair_f[6, lanes]
        for j in range(meshpack.TRIS_PER_CHUNK):
            w = lambda k: blk[:, j, k]
            tid = w(9).to(torch.int64)
            n0 = (w(10), w(11), w(12))
            p0 = (w(0), w(1), w(2))
            ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
            flip = ndotd > 0.0
            grazing = torch.where(flip, -ndotd, ndotd).abs() < 1e-4
            test = (tid >= 0) & (tid != exclude[:, 0]) & ~grazing & ~done
            test &= isect.watertight_inside(wt, p0, (w(3), w(4), w(5)),
                                            (w(6), w(7), w(8)))
            t, _, _ = isect.plane_t(n0, p0, o, d)
            if any_hit:
                done |= test & (t >= T_MIN) & (t <= t_light)
                continue
            take = test & (t >= T_MIN) & ((t < best_t) | ((t == best_t)
                                                          & (tid > best_i)))
            best_t = torch.where(take, t, best_t)
            best_i = torch.where(take, tid, best_i)
            sgn = torch.where(flip, -1.0, 1.0)
            for c in range(3):
                best_n[c] = torch.where(take, sgn * n0[c], best_n[c])
        flag[0, lanes] = done.to(torch.int32)
        out_f[0, lanes] = best_t
        for c in range(3):
            out_f[1 + c, lanes] = best_n[c]
        out_i[0, lanes] = best_i.to(torch.int32)

    _pair_scan(pair_f, pair_i, tri_rows, scan)
    return flag if any_hit else (out_f, out_i)


def _check_pairs(pair_f, pair_i, tri_rows, work):
    P = pair_f.shape[-1] if pair_f.dim() == 2 else -1
    dev = pair_f.device
    for name, t, shape, dtype in (
            ("pair_f", pair_f, (7, P), torch.float32),
            ("pair_i", pair_i, (2, P), torch.int32),
            ("tri_rows", tri_rows, (tri_rows.shape[0], 128), torch.float32)):
        mk._check_tensor(name, t, shape, dtype, dev)
    if tri_rows.shape[0] % meshpack.ROWS_PER_CHUNK:
        raise ValueError(f"tri_rows: {tri_rows.shape[0]} rows is not a whole "
                         f"number of {meshpack.ROWS_PER_CHUNK}-row chunks")
    if dev.type == "cuda" and tri_rows.data_ptr() % 16:
        raise ValueError("tri_rows: the pair kernels read 16-byte aligned "
                         "triangle records")
    if work is not None:
        mk._check_tensor("work", work, (mk.WORK_KINDS,), torch.int64, dev)
        if dev.type == "cpu":
            raise ValueError("work counts are taken on the card: the plain "
                             "version counts nothing")
    return P, dev


def pair_intersect(pair_f, pair_i, tri_rows, work: torch.Tensor | None = None):
    """Closest hit of each (ray, chunk) pair -> (out_f (4, P), out_i
    (1, P)), the contract of ``pair_reference``. CPU tensors run it; CUDA
    tensors launch ``pair_closest`` of csrc/pair.cu; a failed build or
    launch raises. ``work`` (a zeroed (mk.WORK_KINDS,) int64 CUDA tensor)
    selects the build that adds its live pairs, plane tests and inside
    tests (columns 0, 2, 3)."""
    global launches_pair
    P, dev = _check_pairs(pair_f, pair_i, tri_rows, work)
    if dev.type == "cpu":
        return pair_reference(pair_f, pair_i, tri_rows)
    mk._require_cuda(dev)
    fn = mk._fn("pair", "pair_closest")
    out_f = torch.empty((4, P), dtype=torch.float32, device=dev)
    out_i = torch.empty((1, P), dtype=torch.int32, device=dev)
    mk._launch("pair_closest", fn, dev, pair_f.data_ptr(), pair_i.data_ptr(),
               tri_rows.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), P,
               tri_rows.shape[0] // meshpack.ROWS_PER_CHUNK,
               None if work is None else work.data_ptr())
    launches_pair += 1
    return out_f, out_i


def pair_occluded(pair_f, pair_i, tri_rows, work: torch.Tensor | None = None):
    """Any hit at t <= t_light of each (ray, chunk) pair -> flag (1, P)
    i32, the contract of ``pair_occluded_reference``. CPU tensors run it;
    CUDA tensors launch ``pair_any`` of csrc/pair.cu; ``work`` as
    ``pair_intersect``'s."""
    global launches_pair_occl
    P, dev = _check_pairs(pair_f, pair_i, tri_rows, work)
    if dev.type == "cpu":
        return pair_occluded_reference(pair_f, pair_i, tri_rows)
    mk._require_cuda(dev)
    fn = mk._fn("pair", "pair_any")
    flag = torch.empty((1, P), dtype=torch.int32, device=dev)
    mk._launch("pair_any", fn, dev, pair_f.data_ptr(), pair_i.data_ptr(),
               tri_rows.data_ptr(), flag.data_ptr(), P,
               tri_rows.shape[0] // meshpack.ROWS_PER_CHUNK,
               None if work is None else work.data_ptr())
    launches_pair_occl += 1
    return flag


# Sections of the pair scans' timed build (csrc/pair.cu S_*).
PAIR_SECTIONS = ("head", "plane_t", "inside", "update", "loop")


def pair_sections(pair_f, pair_i, tri_rows, any_hit: bool) -> torch.Tensor:
    """The timed build of a pair scan (``pair_timed`` of csrc/pair.cu; CUDA
    only, never on the main path, counts no launch): each of
    PAIR_SECTIONS' clock64() cycles summed over lanes, (5,) int64."""
    P, dev = _check_pairs(pair_f, pair_i, tri_rows, None)
    mk._require_cuda(dev)
    fn = mk._fn("pair", "pair_timed")
    out_f = torch.empty((4, P), dtype=torch.float32, device=dev)
    out_i = torch.empty((1, P), dtype=torch.int32, device=dev)
    times = torch.zeros(len(PAIR_SECTIONS), dtype=torch.int64, device=dev)
    mk._launch("pair_timed", fn, dev, pair_f.data_ptr(), pair_i.data_ptr(),
               tri_rows.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), P,
               tri_rows.shape[0] // meshpack.ROWS_PER_CHUNK, int(any_hit),
               times.data_ptr())
    return times


def _pairs(cand, rays, exclude, t_pair=None):
    """The (ray, slot) pairs of cand (k, R), sorted by chunk id with the
    dead ones last: (pair_f (7, P) [o, d, t_pair or 0], pair_i (2, P)
    [chunk, exclude], perm (P,)), pair p holding flat slot perm[p] (slot
    s of ray r at s * R + r)."""
    k, R = cand.shape
    flat = cand.reshape(-1).to(torch.int64)
    key = torch.where(flat >= 0, flat, DEAD_KEY)
    key_s, perm = torch.sort(key, stable=True)
    ray = perm % R
    extra = (torch.zeros_like(rays[0]) if t_pair is None else t_pair)[ray]
    pair_f = torch.cat([rays[:, ray], extra[None]])
    chunk = torch.where(key_s == DEAD_KEY, -1, key_s).to(torch.int32)
    pair_i = torch.stack([chunk, exclude.to(torch.int32)[ray]])
    return pair_f, pair_i, perm


def _unsort(x, perm, k, R):
    """Pair outputs (c, P) back in (c, k, R) slot order."""
    out = torch.empty_like(x)
    out[:, perm] = x
    return out.reshape(x.shape[0], k, R)


def _merge_tie(t_a, i_a, n_a, t_b, i_b, n_b):
    """Fold winner b into winner a with the mesh tie rule (binned.py:531);
    n_a, n_b (3, R)."""
    take = (t_b < t_a) | ((t_b == t_a) & (i_b > i_a))
    return (torch.where(take, t_b, t_a), torch.where(take, i_b, i_a),
            torch.where(take[None], n_b, n_a))


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------


def _part(mesh_arrays, pi):
    arrs = mesh_arrays[mk.ARRAYS_PER_PART * pi:mk.ARRAYS_PER_PART * (pi + 1)]
    tri_rows = arrs[0]
    # only real chunks have triangle rows; the padding boxes never compete
    return tri_rows, arrs[1][:tri_rows.shape[0] // meshpack.ROWS_PER_CHUNK]


def mesh_winner(tri_rows, chunk_bbox, rays, exclude, t_bound=None,
                k: int | None = None, active=None, work=None):
    """Closest hit of each ray against one mesh part, binned
    (binned.py:540): tri_rows and its real chunk boxes, rays (6, R),
    exclude (R,) i32, t_bound (R,) the occlusion bound, active (R,) bool
    -> (t (R,), idx (R,) i32, nrm (3, R), resolved (R,) bool, live pairs
    (a device scalar)). A ray is resolved when its hit precedes every
    omitted candidate chunk (t <= t_next) or none was omitted."""
    k = DEFAULT_K if k is None else int(k)
    R = rays.shape[1]
    cand, t_next = candidates(chunk_bbox, rays, t_bound, k, active,
                              work=_w(work, "candidates"))
    pair_f, pair_i, perm = _pairs(cand, rays, exclude)
    out_f, out_i = pair_intersect(pair_f, pair_i, tri_rows,
                                  work=_w(work, "pair"))
    f = _unsort(out_f, perm, k, R)
    i = _unsort(out_i, perm, k, R)[0]
    dev = rays.device
    t_w = torch.full((R,), math.inf, dtype=torch.float32, device=dev)
    i_w = torch.full((R,), -1, dtype=torch.int32, device=dev)
    n_w = torch.zeros((3, R), dtype=torch.float32, device=dev)
    for s in range(k):
        t_w, i_w, n_w = _merge_tie(t_w, i_w, n_w, f[0, s], i[s], f[1:, s])
    resolved = torch.where(torch.isfinite(t_next), t_w <= t_next, True)
    return t_w, i_w, n_w, resolved, (cand >= 0).sum()


def _spread3(v):
    """8-bit values to every third bit (meshpack._morton3)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _finish_tiers(R: int):
    """The compaction budgets of _walk_finish (binned.py:793-794)."""
    return sorted({TILE * max(1, R // (32 * TILE)),
                   TILE * max(1, R // (8 * TILE))})


def _walk_finish(static, mesh_arrays, rays, exclude, unres, out_f, out_i,
                 work=None):
    """Finish the unresolved rays with the seeded walk (binned.py:776):
    out_f (4, R) [t, n.xyz] / out_i (1, R) the binned winners, which seed
    the walk -> (out_f, out_i, finish, unresolved count). Rays not
    unresolved pass through.

    finish: None (nothing unresolved), the compaction tier u (the
    unresolved rays gathered into u slots sorted by direction octant and
    8-bit origin Morton code, walked, and scattered back), or "full" (more
    than the largest tier: every ray walked, the resolved ones seeded t =
    -inf so that they come back unchanged)."""
    R = rays.shape[1]
    n_unres = _read(unres.sum())
    if n_unres == 0:
        return out_f, out_i, None, 0
    dev = rays.device
    tier = next((u for u in _finish_tiers(R) if n_unres <= u), None)
    if tier is None:
        seed_f = torch.cat([torch.where(unres, out_f[0], -math.inf)[None],
                            out_f[1:]])
        seed_i = torch.stack([torch.where(unres, out_i[0], -1),
                              exclude.to(torch.int32)])
        wf, wi = walk(static, rays, seed_f, seed_i, *mesh_arrays,
                      work=_w(work, "walk"))
        return (torch.where(unres, wf, out_f), torch.where(unres, wi, out_i),
                "full", n_unres)
    u = tier
    # gather: slot pos holds the pos-th unresolved ray, in ray order
    pos = torch.cumsum(unres, 0) - 1
    idxs0 = torch.zeros((u + 1,), dtype=torch.int64, device=dev)
    idxs0[torch.where(unres, pos, u)] = torch.arange(R, device=dev)
    idxs0 = idxs0[:u]
    valid0 = torch.arange(u, device=dev) < n_unres
    og, dg = rays[0:3, idxs0], rays[3:6, idxs0]
    key = torch.zeros((u,), dtype=torch.int64, device=dev)
    for c in range(3):
        oc = torch.where(valid0, og[c], 0.0)
        lo = torch.where(valid0, oc, math.inf).amin()
        hi = torch.where(valid0, oc, -math.inf).amax()
        q = torch.clamp((oc - lo) / torch.clamp(hi - lo, min=1e-20) * 255.0,
                        0.0, 255.0).to(torch.int64)
        key = key | (_spread3(q) << c)
        key = key | torch.where(dg[c] < 0.0, 1 << (24 + c), 0)
    key = torch.where(valid0, key, DEAD_KEY)
    order = torch.sort(key, stable=True)[1]
    idxs, valid = idxs0[order], valid0[order]
    seed_f = torch.cat([torch.where(valid, out_f[0, idxs], -math.inf)[None],
                        out_f[1:, idxs]])
    seed_i = torch.stack([torch.where(valid, out_i[0, idxs], -1),
                          exclude.to(torch.int32)[idxs]])
    wf, wi = walk(static, rays[:, idxs].contiguous(), seed_f, seed_i,
                  *mesh_arrays, work=_w(work, "walk"))
    # masked scatter-back: invalid slots land on a discarded column
    tgt = torch.where(valid, idxs, R)
    buf_f = torch.cat([out_f, out_f.new_zeros((4, 1))], dim=1)
    buf_i = torch.cat([out_i, out_i.new_zeros((1, 1))], dim=1)
    buf_f[:, tgt] = wf
    buf_i[:, tgt] = wi
    return (buf_f[:, :R].contiguous(), buf_i[:, :R].contiguous(), u,
            n_unres)


def mesh_closest_hit(static, mesh_arrays, rays, exclude, t_bound=None,
                     k: int | None = None, active=None, work=None):
    """Closest mesh hit of each ray over every mesh part (binned.py:727):
    rays (6, R), exclude (R,) i32, t_bound (R,) the occlusion bound (a
    chunk entered beyond it is never a candidate), active (R,) bool ->
    (out_f (4, R) f32 [t, n.xyz], out_i (1, R) i32 [idx]).

    Each part's binned winner folds in under the mesh tie rule; rays that
    some part left unresolved are finished by the seeded walk. The result
    is the walk's from an empty seed up to the bound's cull, which drops
    only provably losing chunks; inactive lanes return (+inf, 0, -1).
    ``work``: ``new_work``'s counters, or None."""
    R = rays.shape[1]
    dev = rays.device
    t_w = torch.full((R,), math.inf, dtype=torch.float32, device=dev)
    i_w = torch.full((R,), -1, dtype=torch.int32, device=dev)
    n_w = torch.zeros((3, R), dtype=torch.float32, device=dev)
    resolved = torch.ones((R,), dtype=torch.bool, device=dev)
    pairs = 0
    for pi in range(len(static.mesh_parts)):
        t_p, i_p, n_p, res, n_pairs = mesh_winner(
            *_part(mesh_arrays, pi), rays, exclude, t_bound, k, active, work)
        t_w, i_w, n_w = _merge_tie(t_w, i_w, n_w, t_p, i_p, n_p)
        resolved = resolved & res
        pairs = pairs + n_pairs
    out_f, out_i, finish, n_unres = _walk_finish(
        static, mesh_arrays, rays, exclude, ~resolved,
        torch.cat([t_w[None], n_w]), i_w[None], work)
    _log(pipeline="closest", rays=R, parts=len(static.mesh_parts),
         live=R if active is None else active.sum(), pairs=pairs,
         unres=n_unres, finish=finish)
    return out_f, out_i


def mesh_occluded_part(tri_rows, chunk_bbox, rays, exclude, t_su,
                       k: int | None = None, active=None, work=None):
    """Occlusion of each ray by one mesh part, binned (binned.py:1019):
    as ``mesh_winner``, with t_su (R,) the exact light distance (the cull
    bound, and the pair scan's predicate) -> (hit (R,) bool: some triangle
    at T_MIN <= t <= t_su; resolved (R,) bool; live pairs). A lane that
    found an occluder is resolved; a lane without one only when no
    candidate was omitted."""
    k = DEFAULT_K if k is None else int(k)
    R = rays.shape[1]
    cand, t_next = candidates(chunk_bbox, rays, t_su, k, active,
                              work=_w(work, "candidates"))
    pair_f, pair_i, perm = _pairs(cand, rays, exclude, t_su)
    flag = pair_occluded(pair_f, pair_i, tri_rows, work=_w(work, "pair_any"))
    hit = (_unsort(flag, perm, k, R)[0] != 0).any(dim=0)
    return hit, hit | ~torch.isfinite(t_next), (cand >= 0).sum()


def mesh_occluded(static, mesh_arrays, rays, exclude, t_su,
                  k: int | None = None, active=None, work=None):
    """Whether a mesh triangle lies at T_MIN <= t <= t_su along each ray
    (binned.py:1077) -> occl (R,) bool, exactly the flag the closest-hit
    cast derives as (idx >= 0) & (t <= t_su): an any-hit found settles the
    ray, and the unresolved rays without one are finished by the walk
    seeded empty."""
    R = rays.shape[1]
    dev = rays.device
    hit = torch.zeros((R,), dtype=torch.bool, device=dev)
    resolved = torch.ones((R,), dtype=torch.bool, device=dev)
    pairs = 0
    for pi in range(len(static.mesh_parts)):
        h_p, res_p, n_pairs = mesh_occluded_part(
            *_part(mesh_arrays, pi), rays, exclude, t_su, k, active, work)
        hit = hit | h_p
        resolved = resolved & res_p
        pairs = pairs + n_pairs
    unres = ~hit & ~resolved
    empty_f = torch.zeros((4, R), dtype=torch.float32, device=dev)
    empty_f[0] = math.inf
    empty_i = torch.full((1, R), -1, dtype=torch.int32, device=dev)
    out_f, out_i, finish, n_unres = _walk_finish(
        static, mesh_arrays, rays, exclude, unres, empty_f, empty_i, work)
    _log(pipeline="any", rays=R, parts=len(static.mesh_parts),
         live=R if active is None else active.sum(), pairs=pairs,
         unres=n_unres, finish=finish)
    return hit | ((out_i[0] >= 0) & (out_f[0] <= t_su))


def _batched(pipeline, kind, rays, exclude, t, active, batch, threshold,
             n_live, empty):
    """The live-compacted batching of binned.py:1114-1299 around
    pipeline(rays, exclude, t, active) -> tensors (c, R).

    Batches are batch rays rounded to whole tiles. Populations above
    threshold, and every population when batch is None or covers the
    film, run the pipeline once over the film. Otherwise the live rays
    are moved to a prefix (a sort on the ray id with bit 31 marking the
    dead ones), cast in ceil(live / batch) batches and scattered back;
    dead rays return ``empty`` ((c, 1) fill per output). n_live, when
    given, is the live count already read."""
    R = rays.shape[1]
    if batch is not None:
        batch = max(TILE, (batch // TILE) * TILE)
    if batch is None or active is None or batch >= R:
        _log(cast=kind, rays=R, live=n_live, batches=0)
        return pipeline(rays, exclude, t, active)
    if n_live is None:
        n_live = count_live(active)
    if threshold is not None and threshold < R and n_live > threshold:
        _log(cast=kind, rays=R, live=n_live, batches=0)
        return pipeline(rays, exclude, t, active)
    dev = rays.device
    nb = -(-n_live // batch)
    _log(cast=kind, rays=R, live=n_live, batches=nb)
    rid = torch.arange(R, device=dev)
    key = torch.where(active, rid, rid | (1 << 31))
    live_ids = torch.sort(key)[1][:n_live]
    r_pad = nb * batch
    rays_s = torch.zeros((6, r_pad), dtype=torch.float32, device=dev)
    rays_s[3] = 1.0
    rays_s[:, :n_live] = rays[:, live_ids]
    ex_s = torch.full((r_pad,), -1, dtype=torch.int32, device=dev)
    ex_s[:n_live] = exclude[live_ids]
    t_s = torch.zeros((r_pad,), dtype=torch.float32, device=dev)
    t_s[:n_live] = t[live_ids]
    outs = None
    for b in range(nb):
        s = slice(b * batch, (b + 1) * batch)
        act = torch.arange(b * batch, (b + 1) * batch, device=dev) < n_live
        got = pipeline(rays_s[:, s].contiguous(), ex_s[s], t_s[s], act)
        if outs is None:
            outs = [torch.empty((g.shape[0], r_pad), dtype=g.dtype,
                                device=dev) for g in got]
        for o, g in zip(outs, got):
            o[:, s] = g
    res = []
    for o, fill in zip(outs, empty):
        full = fill.to(o.dtype).to(dev).expand(o.shape[0], R).clone()
        full[:, live_ids] = o[:, :n_live]
        res.append(full)
    return tuple(res)


def mesh_closest_hit_batched(static, mesh_arrays, rays, exclude,
                             t_bound=None, k: int | None = None, active=None,
                             batch: int | None = None,
                             threshold: int | None = None,
                             n_live: int | None = None, work=None):
    """``mesh_closest_hit`` whose cost follows the live population
    (binned.py:1182): a population of at most threshold live rays is
    compacted and cast in batches of ``batch`` rays (see ``_batched``), a
    denser one in one piece. The result is ``mesh_closest_hit``'s bit for
    bit: every quantity is per lane. Dead rays return (+inf, 0, -1)."""
    R = rays.shape[1]
    if t_bound is None:
        t_bound = torch.full((R,), math.inf, dtype=torch.float32,
                             device=rays.device)

    def pipeline(r, ex, tb, act):
        return mesh_closest_hit(static, mesh_arrays, r, ex, tb, k, act, work)

    empty = (torch.tensor([[math.inf], [0.0], [0.0], [0.0]]),
             torch.tensor([[-1]], dtype=torch.int32))
    return _batched(pipeline, "closest", rays, exclude, t_bound, active,
                    batch, threshold, n_live, empty)


def mesh_occluded_batched(static, mesh_arrays, rays, exclude, t_su,
                          k: int | None = None, active=None,
                          batch: int | None = None,
                          threshold: int | None = None,
                          n_live: int | None = None, work=None):
    """``mesh_occluded`` with the batching of ``mesh_closest_hit_batched``
    (binned.py:1114) -> occl (R,) bool; dead rays are not occluded."""

    def pipeline(r, ex, tsu, act):
        return (mesh_occluded(static, mesh_arrays, r, ex, tsu, k, act,
                              work)[None],)

    (occl,) = _batched(pipeline, "any", rays, exclude, t_su, active, batch,
                       threshold, n_live, (torch.tensor([[False]]),))
    return occl[0]


# ---------------------------------------------------------------------------
# the seeded walk
# ---------------------------------------------------------------------------


def walk_reference(static: mk.SceneStatic, rays: torch.Tensor,
                   seed_f: torch.Tensor, seed_i: torch.Tensor, *mesh_arrays):
    """Plain torch seeded walk -> (out_f (4, R), out_i (1, R)): for each
    active lane (seed t > -inf), the closest hit over every mesh part that
    beats the seed (t < best, or t == best and a higher id), skipping the
    triangle seed_i[1]; the seed where none does. Inactive lanes return
    their seed. Only the active lanes are scanned."""
    out_f = seed_f.clone()
    out_i = seed_i[0:1].clone()
    lanes = torch.nonzero(seed_f[0] > -math.inf)[:, 0]
    o = tuple(rays[c, lanes] for c in range(3))
    d = tuple(rays[3 + c, lanes] for c in range(3))
    exclude = seed_i[1, lanes].to(torch.int64)
    wt = isect.watertight_setup(o, d)
    best_t = seed_f[0, lanes]
    best_i = seed_i[0, lanes].to(torch.int64)
    nrm = tuple(seed_f[1 + c, lanes] for c in range(3))
    zero = torch.zeros_like(best_t)
    pos = (zero, zero, zero)  # not an output
    for k in range(len(static.mesh_parts)):
        best_t, best_i, pos, nrm = mk._scan_mesh_part(
            mesh_arrays[mk.ARRAYS_PER_PART * k], o, d, exclude, wt, best_t,
            best_i, pos, nrm)
    out_f[:, lanes] = torch.stack([best_t, *nrm])
    out_i[0, lanes] = best_i.to(torch.int32)
    return out_f, out_i


def walk(static: mk.SceneStatic, rays: torch.Tensor, seed_f: torch.Tensor,
         seed_i: torch.Tensor, *mesh_arrays,
         work: torch.Tensor | None = None):
    """Seeded walk over every mesh part -> (out_f (4, R) f32 [t, n.xyz],
    out_i (1, R) i32 [idx]), the contract of ``walk_reference``.

    CPU tensors run ``walk_reference``; CUDA tensors launch the kernel of
    csrc/walk.cu, built at first use; a failed build or launch raises.
    ``work``, a zeroed (mk.WORK_KINDS,) int64 CUDA tensor, selects the
    build that also adds its casts (active lanes), box tests, triangle
    plane tests, triangle inside tests, chunk scans, the lanes that ran
    them (a warp's 32 lanes scan each entered chunk together) and the
    inside tests those scans need to it."""
    global launches_walk
    if not static.mesh_parts:
        raise ValueError("the walk casts against mesh parts; the scene has "
                         "none")
    R = rays.shape[-1] if rays.dim() == 2 else -1
    dev = rays.device
    for name, t, shape, dtype in (
            ("rays", rays, (6, R), torch.float32),
            ("seed_f", seed_f, (4, R), torch.float32),
            ("seed_i", seed_i, (2, R), torch.int32)):
        mk._check_tensor(name, t, shape, dtype, dev)
    mk._check_parts(static, mesh_arrays, dev)
    if work is not None:
        mk._check_tensor("work", work, (mk.WORK_KINDS,), torch.int64, dev)
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("work counts are taken on the card: the plain "
                             "version counts nothing")
        return walk_reference(static, rays, seed_f, seed_i, *mesh_arrays)
    mk._require_cuda(dev)
    fn = mk._fn("walk", "walk")
    out_f = torch.empty((4, R), dtype=torch.float32, device=dev)
    out_i = torch.empty((1, R), dtype=torch.int32, device=dev)
    ptrs, info = mk._part_tables(static, mesh_arrays)
    mk._launch("walk", fn, dev, rays.data_ptr(), seed_f.data_ptr(),
               seed_i.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), R,
               len(static.mesh_parts), ctypes.addressof(ptrs),
               ctypes.addressof(info),
               None if work is None else work.data_ptr())
    launches_walk += 1
    return out_f, out_i
