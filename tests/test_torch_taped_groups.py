"""The group schedule of the taped forward, held on the CPU.

On the card, the taped="full" forward of a scene without mesh parts or
triangle rows runs on persistent warps whose lanes take rays and retire
them in groups of GROUP (csrc/forward.cuh group_taped_kernel): a group
holds GROUP consecutive, GROUP-aligned ray ids at one depth, writes its
tape row at that depth in every trip (a dead lane its final carry with
active = 0), and refills once all its rays have died, so that every tape
store is whole 32-byte sectors. Held here:

- ``forward_refill_reference(group=GROUP)``, the plain model of that
  control flow, bit-equal to ``forward_taped_reference`` (which
  tests/test_torch_taped.py holds to the JAX package's tape) at Cornell
  32^2: radiance and both tape planes, at depth 8 and 0, a ragged last
  group (R = 1003), pools of one and three warps and no Russian roulette
  (rr_start = max_depth). Its lane trips are the tape's trips, and
  groups of GROUP rays keep more lane slots busy than warps of 32;
- GROUP against the kernel's source;
- the taped wrapper's checks of ``trips``: the plain version counts
  nothing, and triangle rows run the refill schedule, which it does not
  count.

The kernel itself is held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import pytest
import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 32
FORWARD = (pathlib.Path(__file__).resolve().parents[1]
           / "computeraytracer_tpu_torch" / "kernels" / "csrc"
           / "forward.cuh")


def _cornell(n_rays, w=W, h=H):
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(w, h, 0, "cpu")
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, w, h, px[:n_rays], py[:n_rays], 1))
    return static, args


@pytest.mark.parametrize("lanes,max_depth,n_rays,rr_start", [
    (96, 8, 1000, 1), (32, 8, 1003, 1), (96, 0, 1003, 1), (96, 8, 1003, 8)])
def test_group_model_is_bit_equal(lanes, max_depth, n_rays, rr_start):
    """Radiance and both tape planes bit-equal to the one-thread
    schedule's plain version; the lane trips are the tape's trips and no
    warp trip count is below them. On the same trips, groups of GROUP
    consecutive rays keep more lane slots busy than warps of 32 (the
    schedule model; the card's counting build is held to it at 512^2 in
    tests/test_torch_cuda.py)."""
    static, args = _cornell(n_rays)
    want = mk.forward_taped_reference(static, max_depth, rr_start, *args)
    got = mk.forward_refill_reference(static, max_depth, rr_start, *args,
                                      lanes=lanes, group=mk.GROUP,
                                      taped=True)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    lane_trips, warp_trips = got[3]
    trips = mk.trips_from_tape(want[2])
    assert lane_trips == int(trips.sum())
    assert lane_trips <= warp_trips and warp_trips % mk.WARP == 0
    if max_depth == 0:
        assert lane_trips == n_rays
    else:
        assert (mk.schedule_efficiency(trips, mk.GROUP)
                > mk.schedule_efficiency(trips))


def test_group_constant_is_the_kernels():
    """GROUP names the kernel's constant: 16 4-byte words, two 32-byte
    sectors."""
    src = FORWARD.read_text()
    got = int(re.search(r"constexpr int GROUP = (\d+);", src).group(1))
    assert got == mk.GROUP == 16


@pytest.mark.parametrize("bad", ["cpu", "length", "dtype", "triangle_rows",
                                 "group"])
def test_taped_trips_checks(bad):
    """trips selects the card's counting build of the group schedule: on
    CPU tensors, with a tensor of the wrong length or type, or on a scene
    with triangle rows, the wrapper raises; the model takes only groups
    that divide a warp."""
    doc = (presets.mesh_scene(4, 4, 1) if bad == "triangle_rows"
           else presets.cornell_box(4, 4))
    scene, _ = scene_from_dict(doc, device="cpu")
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(4, 4, 0, "cpu")
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, 4, 4, px, py, 1),
                            static)
    if bad == "group":
        with pytest.raises(ValueError, match="divisor"):
            mk.forward_refill_reference(static, 2, 1, *args, group=12,
                                        taped=True)
        return
    n = len(mk.TRIP_COUNTS) + (1 if bad == "length" else 0)
    dtype = torch.int32 if bad == "dtype" else torch.int64
    match = {"cpu": "on the card", "length": "expected", "dtype": "expected",
             "triangle_rows": "without triangle rows"}[bad]
    with pytest.raises(ValueError, match=match):
        mk.forward_taped(static, 2, 1, *args,
                         trips=torch.zeros(n, dtype=dtype))
