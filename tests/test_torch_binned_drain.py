"""The schedules of the binned casts' kernels, as plain models on the CPU.

csrc/candidates.cu drains each warp's entered (lane, supernode) items two
per pass and returns the entries that pass to their owner lane, which
inserts them; csrc/pair.cu runs the watertight inside test before the
plane's division. Neither order may change a result. Here:
- ``binned.candidates_drained_reference``, the model of the drained
  schedule (each lane's supernode bitmask per group of 32 supernodes, the
  supernodes that most lanes of a warp entered tested lane by lane, the
  drain's item order for the others, the owner's insertion in the order
  its entries come), bit-equal to
  ``candidates_reference`` and to the JAX ``binned.candidate_chunks`` on
  incoherent seeded rays, k = 1, 4 and 6, 38 supernodes (two mask words),
  inactive lanes, a ragged last warp and chunk boxes with equal entry
  distances (duplicated boxes, and boxes that share their near faces);
- its insertion order-free: random orders of each lane's entries give the
  same slots and t_next;
- its trip counts against counts taken from its masks alone, and
  ``binned.candidate_trips`` (the same counts, vectorised) against them;
- ``binned.pair_scan_order_reference``, the model of the pair loop's test
  order, bit-equal to ``pair_reference`` and ``pair_occluded_reference``
  on ``tie_mesh_scene`` (exact ties inside one chunk and across chunks)
  with ``tie_mesh_rays``, and on any-hit pairs whose closest hit lies
  exactly at t_light or one ulp beyond it.
tests/test_torch_cuda.py holds the kernels against the same references
on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import binned as jbinned
from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

R = 1000   # 31 whole warps and a ragged one of 8 lanes
C = 600    # 38 supernodes: two mask words


def _tie_boxes(n, g):
    """(n, 8) f32 chunk boxes, each run of SUP_CHUNKS around a centre of its
    own in [-2, 2]^3, as a BVH's leaf order places them: random boxes,
    every fifth a copy of the one before it (equal entry distances for
    every ray), every seventh sharing the near corner of the one before it
    with a larger far corner (equal entry distances for rays whose
    direction components are all positive)."""
    centre = np.repeat(g.uniform(-2, 2, (-(-n // bn.SUP_CHUNKS), 3)),
                       bn.SUP_CHUNKS, axis=0)[:n]
    lo = centre + g.uniform(-0.5, 0.5, (n, 3))
    hi = lo + g.uniform(0.05, 0.4, (n, 3))
    for i in range(1, n):
        if i % 5 == 0:
            lo[i], hi[i] = lo[i - 1], hi[i - 1]
        elif i % 7 == 0:
            lo[i] = lo[i - 1]
            hi[i] = np.maximum(hi[i], hi[i - 1])
    box = np.zeros((n, 8), np.float32)
    box[:, 0:3], box[:, 3:6] = lo, hi
    return box


@pytest.fixture(scope="module")
def case():
    return _case()


def _case():
    """Seeded rays around the tie boxes: 8 coherent warps, then incoherent
    rays (a quarter of them with positive direction components); bounds,
    and a fifth of the lanes inactive."""
    g = np.random.default_rng(11)
    box = _tie_boxes(C, g)
    o = g.uniform(-3, 3, (3, R))
    d = g.normal(size=(3, R))
    d[:, ::4] = np.abs(d[:, ::4])
    o[:, ::4] = g.uniform(-3, -2, (3, R))[:, ::4]
    # 8 warps of coherent rays from one corner, which most of their lanes
    # take through the same supernodes
    o[:, :256] = -3 + g.uniform(-0.05, 0.05, (3, 256))
    d[:, :256] = 1 + g.uniform(-0.1, 0.1, (3, 256))
    d /= np.linalg.norm(d, axis=0)
    o, d = o.astype(np.float32), d.astype(np.float32)
    tb = g.uniform(0.5, 10, R).astype(np.float32)
    act = g.uniform(size=R) >= 0.2
    padded = torch.from_numpy(tb) + torch.from_numpy(tb).abs() * bn.PAD_BOUND
    bound = torch.where(torch.from_numpy(act), padded, -torch.inf)
    rays7 = torch.cat([torch.from_numpy(o), torch.from_numpy(d),
                       bound[None]])
    return {"box": box, "bbox": torch.from_numpy(box), "o": o, "d": d,
            "tb": tb, "act": act, "rays7": rays7}


@pytest.mark.parametrize("k", [1, 4, 6])
def test_drained_model_is_the_reference_and_jax(case, k):
    """The drained schedule's slots and t_next equal candidates_reference's
    bit for bit, and the JAX candidate_chunks' on the active lanes (the
    JAX pass has no active mask; its inactive lanes are not compared)."""
    cand, t_next, sched = bn.candidates_drained_reference(
        case["rays7"], case["bbox"], k)
    want = bn.candidates_reference(case["rays7"], case["bbox"], k)
    assert torch.equal(cand, want[0]) and torch.equal(t_next, want[1])
    act = case["act"]
    jc, jt = jbinned.candidate_chunks(
        jnp.asarray(case["box"]), tuple(jnp.asarray(x) for x in case["o"]),
        tuple(jnp.asarray(x) for x in case["d"]), jnp.asarray(case["tb"]),
        k=k)
    jc, jt = np.asarray(jc).T, np.asarray(jt)
    assert (cand.numpy()[:, act] == jc[:, act]).all()
    assert (t_next.numpy()[act] == jt[act]).all()
    assert (cand[:, ~torch.from_numpy(act)] == -1).all()
    assert torch.isinf(t_next[~torch.from_numpy(act)]).all()
    # the case reaches what it is for: full slots, overflow, two mask
    # words, and exact ties between entries of one lane
    assert (cand >= 0).sum(0).max() == k and torch.isfinite(t_next).any()
    assert (sched["masks"][1] != 0).any()
    inv = bn._inv_dir(case["rays7"][3:6])
    te = bn._slab_t_enter(case["bbox"], case["rays7"][0:3],
                          case["rays7"][3:6], case["rays7"][6], inv)
    ent = torch.sort(te, dim=0).values
    assert ((ent[1:] == ent[:-1]) & torch.isfinite(ent[1:])).any()


def test_drained_insertion_is_order_free(case):
    """Random orders of each lane's entries give the slots and t_next of
    the drain's own order, for every k."""
    for k in (1, 4, 6):
        want = bn.candidates_drained_reference(case["rays7"], case["bbox"],
                                               k)
        for seed in range(3):
            got = bn.candidates_drained_reference(
                case["rays7"], case["bbox"], k,
                order=torch.Generator().manual_seed(seed))
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_drained_trip_counts(case):
    """The model's trips against counts from its masks alone: a supernode
    that DENSE_LANES lanes of a warp or more entered takes one warp trip
    per chunk, the other items of each warp and group half a trip each,
    rounded up (the drain's passes); chunk tests are the real chunks of
    each entered supernode (16, or 8 in the last of the 38); the one-thread
    pass ran a trip per chunk of every supernode that any lane of a warp
    entered, more than the drain's."""
    _, _, sched = bn.candidates_drained_reference(case["rays7"],
                                                  case["bbox"], 6)
    masks = sched["masks"]
    G = masks.shape[0]
    bits = torch.stack([(masks >> b) & 1 for b in range(32)])  # (32, G, R)
    chunks = (C - bn.SUP_CHUNKS * torch.arange(32 * G)).clamp(
        0, bn.SUP_CHUNKS).reshape(G, 32).T[:, :, None]      # (32, G, 1)
    passes = lane_trips = one_thread = n_dense = n_items = 0
    for w0 in range(0, R, bn.WARP):
        warp = bits[:, :, w0:w0 + bn.WARP]
        lanes = warp.sum(2, keepdim=True)                    # (32, G, 1)
        dense = lanes >= bn.DENSE_LANES
        n_dense += int(dense.sum())
        n_items += int(torch.where(dense, 0, lanes).sum())
        passes += int((dense * chunks).sum())
        passes += int(((torch.where(dense, 0, lanes).sum((0, 2)) + 1)
                       // 2).sum())
        lane_trips += int((warp * chunks).sum())
        one_thread += int((warp.amax(2, keepdim=True) * chunks).sum())
    assert (sched["warp_trips"], sched["lane_trips"]) == (passes, lane_trips)
    assert bn.candidate_trips(case["rays7"], case["bbox"]) == {
        "lane_trips": lane_trips, "warp_trips": passes,
        "warp_trips_one_thread": one_thread}
    assert passes < one_thread and n_dense > 0 and n_items > 0
    assert not masks[:, ~torch.from_numpy(case["act"])].any()


@pytest.fixture(scope="module", params=presets.TIE_LAYOUTS)
def tie_pairs(request):
    """Every (ray, chunk) pair of 256 tie_mesh_rays on tie_mesh_scene's one
    mesh part (exact ties inside a chunk and across chunks), a fifth of the
    rays excluding their unexcluded winner, plus dead pairs (chunk -1 and
    beyond the real chunks); for the any-hit scan, t_light at exactly the
    pair's closest hit on even pairs and one ulp short of it on odd ones."""
    scene, _ = scene_from_dict(presets.tie_mesh_scene(64, 64,
                                                      request.param),
                               device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=256)
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    tri_rows, _ = bn._part(arrays, 0)
    n_chunks = tri_rows.shape[0] // 16
    rays = torch.from_numpy(presets.tie_mesh_rays(256, seed=3))
    n = rays.shape[1]
    chunk = torch.arange(n_chunks).repeat_interleave(n)
    ray = torch.arange(n).repeat(n_chunks)
    pair_f = torch.cat([rays[:, ray], torch.zeros(1, ray.shape[0])])
    pair_i = torch.stack([chunk, torch.full_like(chunk, -1)]).to(torch.int32)
    first = bn.pair_reference(pair_f, pair_i, tri_rows)[1][0]
    pair_i[1] = torch.where(ray % 5 == 1, first, -1)
    dead = torch.tensor([-1, n_chunks, n_chunks + 3], dtype=torch.int32)
    pair_f = torch.cat([pair_f, pair_f[:, :3]], dim=1)
    pair_i = torch.cat([pair_i, torch.stack([dead, pair_i[1, :3]])], dim=1)
    t_hit = bn.pair_reference(pair_f, pair_i, tri_rows)[0][0]
    odd = torch.arange(t_hit.shape[0]) % 2 == 1
    pair_f[6] = torch.where(
        torch.isfinite(t_hit),
        torch.where(odd, torch.nextafter(t_hit, torch.tensor(-math.inf)),
                    t_hit), 1e3)
    return pair_f, pair_i, tri_rows


def test_pair_scan_order_is_the_reference(tie_pairs):
    """The inside-first order gives pair_reference's t, normals and ids and
    pair_occluded_reference's flags bit for bit, exact ties and hits at
    exactly t_light included."""
    pair_f, pair_i, tri_rows = tie_pairs
    got = bn.pair_scan_order_reference(pair_f, pair_i, tri_rows, False)
    want = bn.pair_reference(pair_f, pair_i, tri_rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flag = bn.pair_scan_order_reference(pair_f, pair_i, tri_rows, True)
    assert torch.equal(flag, bn.pair_occluded_reference(pair_f, pair_i,
                                                        tri_rows))
    hit = want[1][0] >= 0
    assert hit.sum() > 100 and not hit[-3:].any()
    # hits at exactly t_light count, one ulp short they do not
    odd = torch.arange(hit.shape[0]) % 2 == 1
    assert flag[0][hit & ~odd].all() and (flag[0][hit & odd] == 0).any()
    # exact ties: some pair's winner is not the chunk's first hit at its t
    assert _tied_winners(pair_f, pair_i, tri_rows, want) > 0


def _tied_winners(pair_f, pair_i, tri_rows, want):
    """Pairs with more than one valid triangle at the winning t."""
    n_chunks = tri_rows.shape[0] // 16
    live = (pair_i[0] >= 0) & (pair_i[0] < n_chunks)
    tied = 0
    for p in torch.nonzero(live & (want[1][0] >= 0))[:, 0].tolist():
        one_f = pair_f[:, p:p + 1].clone()
        one_i = pair_i[:, p:p + 1].clone()
        one_i[1] = want[1][0, p]  # exclude the winner: another at its t?
        again = bn.pair_reference(one_f, one_i, tri_rows)[0][0, 0]
        tied += bool(again == want[0][0, p])
    return tied
