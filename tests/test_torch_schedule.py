"""The refill schedule of the forward kernel, held on the CPU.

On the card, a scene without mesh parts runs the forward on persistent
warps that refill their dead lanes (csrc/forward.cuh refill_fwd_kernel):
each lane keeps its own ray, depth and carry, and takes a new ray from one
counter when its warp has REFILL_AT dead lanes. Held here:

- ``forward_refill_reference``, the plain model of that control flow (a
  pool of lanes, one ray counter, per-lane depth, dead tape rows written
  when a ray dies), bit-equal to ``forward_reference`` and
  ``forward_taped_reference`` at Cornell 32^2: a ray's result depends
  only on its own inputs, whichever lane traces it and when. Its lane
  trips are the tape's trips;
- ``schedule_efficiency`` on hand-made trip arrays, and the one-thread
  schedule's efficiency from the tape (``trips_from_tape``);
- the mean trips per ray from the tape against the JAX package's
  ``utils/profiling.py`` ``measure_mean_depth`` (within 1% relative: the
  eager XLA tracer fuses FMAs on the CPU, which flips a few Russian
  roulette draws: 2.79297 against 2.78613, 7 trips in 1,024);
- the constants and counters against the kernel's source, and the
  wrapper's checks of ``trips``: the plain version counts nothing.

The kernel itself is held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import pytest
import torch

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.utils import profiling as jprofiling
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 32
RR_START = 1
FORWARD = (pathlib.Path(__file__).resolve().parents[1]
           / "computeraytracer_tpu_torch" / "kernels" / "csrc"
           / "forward.cuh")


def _cornell(n_rays=None):
    scene, _ = scene_from_dict(presets.cornell_box(W, H), device="cpu")
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(W, H, 0, "cpu")
    if n_rays is not None:
        px, py = px[:n_rays], py[:n_rays]
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, W, H, px, py, 1))
    return static, args


@pytest.mark.parametrize("lanes,threshold,max_depth,n_rays,taped", [
    (96, 8, 8, 1000, True),
    (32, 1, 8, 500, False),
    (32, 8, 0, None, True),
    (96, 1, 0, 1000, False)])
def test_refill_model_is_bit_equal(lanes, threshold, max_depth, n_rays,
                                   taped):
    """Radiance (and tape) bit-equal to the one-thread schedule's plain
    versions; the lane trips are the tape's trips, and no warp trip is
    below its lane trips."""
    static, args = _cornell(n_rays)
    want_f = mk.forward_taped_reference(static, max_depth, RR_START, *args)
    assert torch.equal(want_f[0], mk.forward_reference(
        static, max_depth, RR_START, *args))
    got = mk.forward_refill_reference(static, max_depth, RR_START, *args,
                                      lanes=lanes, threshold=threshold,
                                      taped=taped)
    lane_trips, warp_trips = got[-1]
    assert torch.equal(got[0], want_f[0])
    if taped:
        assert torch.equal(got[1], want_f[1])
        assert torch.equal(got[2], want_f[2])
    assert lane_trips == int(mk.trips_from_tape(want_f[2]).sum())
    assert lane_trips <= warp_trips and warp_trips % mk.WARP == 0
    if max_depth == 0:
        assert lane_trips == args[1].shape[1]


@pytest.mark.parametrize("trips,width,want", [
    ([1] * 64, 32, 1.0),
    ([9] + [1] * 31, 32, 40 / (9 * 32)),
    ([2] * 33, 32, 66 / (2 * 2 * 32)),
    ([1, 2, 3, 4, 4, 4, 4, 4], 4, 26 / 32)])
def test_schedule_efficiency(trips, width, want):
    """Lane trips over warp trips, a warp running as many trips as its
    longest ray; the last warp's missing lanes are idle slots."""
    got = mk.schedule_efficiency(torch.tensor(trips), width)
    assert got == pytest.approx(want, rel=1e-12)


def test_mean_trips_match_jax_mean_depth():
    """Cornell 32^2, sample 1, depth 8: the tape's mean trips per ray
    against the JAX package's measure_mean_depth, within 1% relative;
    the one-thread schedule idles about half its lane slots."""
    static, args = _cornell()
    _, _, tape_i = mk.forward_taped_reference(static, 8, RR_START, *args)
    trips = mk.trips_from_tape(tape_i)
    jscene, _ = jax_scene_from_dict(jpresets.cornell_box(W, H))
    want = jprofiling.measure_mean_depth(jscene, W, H, sample=1, max_depth=8,
                                         rr_start=RR_START)
    got = trips.double().mean().item()
    assert abs(got - want) <= 1e-2 * want
    assert int(trips.min()) >= 1 and int(trips.max()) <= 9
    assert 0.3 < mk.schedule_efficiency(trips) < 0.7


def test_constants_are_the_kernels():
    """REFILL_AT and the trip counters name the kernel's constants."""
    src = FORWARD.read_text()
    assert int(re.search(r"constexpr int REFILL_AT = (\d+);",
                         src).group(1)) == mk.REFILL_AT
    enum = re.search(r"enum \{\s*(TRIP_LANES.*?)\};", src, re.S).group(1)
    values = dict((k, int(v)) for k, v in re.findall(r"(TRIP_\w+) = (\d+)",
                                                      enum))
    assert values.pop("TRIP_KINDS") == len(mk.TRIP_COUNTS)
    names = {"TRIP_LANES": "lane_trips", "TRIP_WARPS": "warp_trips"}
    assert [names[k] for k in sorted(values, key=values.get)] == list(
        mk.TRIP_COUNTS)


@pytest.mark.parametrize("bad", ["cpu", "length", "mesh_parts"])
def test_trips_checks(bad):
    """trips selects the card's counting build: on CPU tensors, with a
    tensor of the wrong length, or on a scene with mesh parts (the
    one-thread schedule), the wrapper raises."""
    doc = (presets.mesh_scene(4, 4, 2) if bad == "mesh_parts"
           else presets.cornell_box(4, 4))
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(4, 4, 0, "cpu")
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, 4, 4, px, py, 1),
                            static)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    n = len(mk.TRIP_COUNTS) + (1 if bad == "length" else 0)
    match = {"cpu": "on the card", "length": "expected",
             "mesh_parts": "without mesh parts"}[bad]
    with pytest.raises(ValueError, match=match):
        mk.forward(static, 2, RR_START, *args, *arrays,
                   trips=torch.zeros(n, dtype=torch.int64))
