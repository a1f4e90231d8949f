"""The port's CUDA kernels on the card, held against their plain versions.

The forward and backward megakernels against forward_reference and
backward_reference on the same CUDA tensors, the served render and the
gradient of a render against the same computation on the CPU; the taped
forward against the plain forward kernel and the retrace kernel's tape,
the tape-fed backward against the retrace kernel (bit for bit: the same
reverse sweep on the same tape), the mesh mode of the forward against
its plain version, the winner-taped forward against its plain version,
both backward kernels on a scene with triangle rows, and the gradient of
a mesh render through the guided replay against the CPU's; the wavefront's
shade step, walk, candidate and pair kernels against their plain versions,
the binned casts against the walk, and the wavefront against the mesh
kernel; the walk with ragged and idle warps, and the walk and the mesh
forwards on a scene of exact ties (presets.tie_mesh_scene), where the
lanes of a warp scan each chunk together; the retrace kernel as the taped
forward's launch followed by the tape-fed kernel's sweep, bit for bit,
both kernels' d_prims across runs, and both kernels on a scene of 10
spectra; the refill schedule of the forward (persistent warps that refill
their dead lanes) against its plain version at ragged ray counts and edge
cases, in the triangle rows' taped forward, across launches, and its
counting build against the tape's trips; the taped forward's group
schedule (lanes that take and retire rays in groups of sixteen) against
its plain version at ragged ray counts and edge cases, across launches,
its counting build against the tape's trips, and the tape-fed kernel on
its tape against the retrace kernel, whose replay it is; the warp-drained candidate
kernel over several groups of supernodes, coherent and incoherent warps
and boxes with equal entry distances, its counted chunk-loop trips equal
to its plain model's, and the pair kernels on unsorted pairs of tie
chunks with dead pairs among them; the eager tracer on the card (no
kernel) against the CPU and the kernel path, its gradient oracle against
the retrace kernel, and the BVH traversal against the brute-force scan;
the screen warp of the visibility gradients around kernels 1, 3 and 4
against the plain versions; a world of one on NCCL (parallel/) against the
single-process render and gradient; the per-sample setup's kernels (the
ray setup at three cameras, its camera operands' checks, its backward to
the camera, the hero gather of one or two tables in one launch and its
fixed-order column sums)
against their plain versions, their launches on the training path and
the gradient's bit-equality across runs; the camera gradients of renders
through the ray setup's backward kernel against the CPU's; the setup
operands built once per render and per loss; the forward's global-table
build (scenes past the shared tables) against the shared build and its
plain version, its frame graph and its launch counter, and its mesh build
(mesh parts beside them) against its plain version, on the served render's
mesh route and on its own counter; the forward's XYZ
builds (shared and global-table) against the forward followed by the
plain epilogue model, the served frame against the composition of the
radiance plane, the CIE sum and the accumulation, and a fit step that
launches no XYZ build; the finish kernel (a rendered frame's mean and sRGB)
against its plain version on the card for both layouts of the sum, the
render's outputs on a replayed key new tensors of their own, one finish
launch a frame (autograd recording it or not), and the card's mean
the CPU's division of the same sum.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so it runs on a card machine without the JAX package's
dependencies; the repo's conftest imports jax, so run it there with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _doc(name, w, h):
    """A preset, or "cornell_mirror": Cornell with its diffuse sphere made
    a mirror (no preset has one)."""
    if name == "cornell_mirror":
        doc = presets.cornell_box(w, h)
        doc["objects"]["spheres"][0]["type"] = "mirror"
        return doc
    return getattr(presets, name)(w, h)


def _inputs(scene, w, h, sample, n_rays=None):
    px, py = kt.tile_coords(w, h, 0, scene.device)
    if n_rays is not None:
        px, py = px[:n_rays], py[:n_rays]
    o, d, hero, seed = kt.camera_planes(scene, w, h, px, py, sample)
    return kt.kernel_inputs(scene, o, d, hero, seed)


def _frac_within(got, want, tol=1e-4):
    rel = (got - want).abs() / want.abs().clamp(min=1e-2)
    return (rel < tol).all(dim=0).float().mean().item()


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("cornell_box", 2), ("simple_scene", 5),
    ("cornell_box_glassless", 8), ("occluder_scene", 3)])
def test_kernel_matches_plain_version(cuda, name, depth):
    """Both round every op separately (the kernel is built with
    --fmad=false), so at least 99.9% of rays agree to rel 1e-4."""
    scene, _ = scene_from_dict(getattr(presets, name)(128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 5)
    before = mk.launches
    got = mk.forward(static, depth, 1, *args)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    want = mk.forward_reference(static, depth, 1, *args)
    assert torch.isfinite(got).all()
    assert _frac_within(got, want) >= 0.999


def test_ragged_ray_count(cuda):
    """R that is not a multiple of the block size: tail threads masked."""
    scene, _ = scene_from_dict(presets.cornell_box(64, 64), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 64, 64, 2, n_rays=1000)
    got = mk.forward(static, 6, 1, *args)
    want = mk.forward_reference(static, 6, 1, *args)
    assert got.shape == (4, 1000)
    assert _frac_within(got, want) >= 0.999


def test_mixed_devices_raise(cuda):
    scene, _ = scene_from_dict(presets.cornell_box(16, 16), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    prims, rays, seeds, spect = _inputs(scene, 16, 16, 1)
    with pytest.raises(ValueError, match="is on"):
        mk.forward(static, 4, 1, prims.cpu(), rays, seeds, spect)


def test_card_render_matches_cpu_render(cuda):
    """The served path on the card vs the same render on the CPU: the
    two devices' exp/sin/cos may differ by an ulp, so a rare pixel's
    path can diverge; 99% of pixels within 2e-4 and the mean within
    1e-3."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6)
    cpu_scene, _ = scene_from_dict(presets.cornell_box(48, 32), device="cpu")
    card = api.render(cpu_scene.to(cuda), cfg)["accum_xyz"].cpu().numpy()
    host = api.render(cpu_scene, cfg)["accum_xyz"].numpy()
    close = np.isclose(card, host, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(card.mean() - host.mean()) <= 1e-3 * abs(host.mean())


def _dL(n_rays, device, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(
        g.standard_normal((4, n_rays)).astype(np.float32)).to(device)


def _assert_backward_close(got, want):
    """d_prims within 1e-3 of its largest entry; d_rays and d_spect: at
    least 99.9% of rays within rel 1e-3, the denominator floored at 1e-3
    of the plane's largest magnitude. All finite."""
    (gp, gr, gs), (wp, wr, ws) = got, want
    for g in got:
        assert torch.isfinite(g).all()
    assert (gp - wp).abs().max() <= 1e-3 * wp.abs().max()
    for g, w in ((gr, wr), (gs, ws)):
        den = torch.maximum(w.abs(), 1e-3 * w.abs().max())
        frac = ((g - w).abs() / den < 1e-3).all(dim=0).float().mean().item()
        assert frac >= 0.999, frac


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("cornell_box", 2), ("simple_scene", 5),
    ("cornell_box_glassless", 8), ("occluder_scene", 3),
    ("cornell_mirror", 6)])
def test_backward_kernel_matches_plain_version(cuda, name, depth):
    scene, _ = scene_from_dict(_doc(name, 128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 5)
    dL = _dL(args[1].shape[1], cuda)
    before = mk.launches_bwd
    got = mk.backward(static, depth, 1, *args, dL)
    torch.cuda.synchronize()
    assert mk.launches_bwd == before + 1
    want = mk.backward_reference(static, depth, 1, *args, dL)
    _assert_backward_close(got, want)


def test_backward_ragged_ray_count(cuda):
    scene, _ = scene_from_dict(presets.cornell_box(64, 64), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 64, 64, 2, n_rays=1000)
    dL = _dL(1000, cuda, seed=1)
    got = mk.backward(static, 6, 1, *args, dL)
    assert got[1].shape == (6, 1000) and got[2].shape == args[3].shape
    _assert_backward_close(got,
                           mk.backward_reference(static, 6, 1, *args, dL))


def test_backward_kernel_is_deterministic(cuda):
    """d_prims is summed in a fixed order (per-warp tables, then blocks):
    two calls give bit-equal results."""
    scene, _ = scene_from_dict(presets.cornell_box(128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, 3)
    dL = _dL(args[1].shape[1], cuda, seed=2)
    first = mk.backward(static, 8, 1, *args, dL)
    second = mk.backward(static, 8, 1, *args, dL)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_card_gradient_matches_cpu(cuda):
    """The gradient of sum(render_sample ** 2) with respect to spectra and
    data1 exists on the card (TraceFn, backward kernel) and agrees with
    the same gradient on the CPU (plain versions)."""
    w, h = 48, 32
    cpu_scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")

    def grads(scene):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        (kt.render_sample(s, w, h, 1, max_depth=4) ** 2).sum().backward()
        return sp.grad, d1.grad

    before = mk.launches_bwd
    card = grads(cpu_scene.to(cuda))
    assert mk.launches_bwd == before + 1
    host = grads(cpu_scene)
    for c, h_ in zip(card, host):
        assert c is not None and c.is_cuda
        c, h_ = c.cpu().numpy(), h_.numpy()
        assert np.isfinite(c).all()
        scale = max(np.abs(h_).max(), 1e-6)
        np.testing.assert_allclose(c / scale, h_ / scale, rtol=1e-3,
                                   atol=1e-4)


def _taped_case(cuda, name, depth, sample=4):
    scene, _ = scene_from_dict(_doc(name, 128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    args = _inputs(scene, 128, 96, sample)
    return static, args, _dL(args[1].shape[1], cuda, seed=3)


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("simple_scene", 5), ("cornell_mirror", 6),
    ("occluder_scene", 3)])
def test_taped_forward_kernel(cuda, name, depth):
    """The taped kernel's radiance is the plain kernel's, bit for bit, and
    its tape is the retrace kernel's phase-A tape, bit for bit; against
    forward_taped_reference the int planes are equal and the float planes
    within rel 1e-4 (floored at 1e-2 of the plane's scale) on at least
    99.9% of rays."""
    static, args, dL = _taped_case(cuda, name, depth)
    before = (mk.launches, mk.launches_taped)
    rad, tape_f, tape_i = mk.forward_taped(static, depth, 1, *args)
    torch.cuda.synchronize()
    assert (mk.launches, mk.launches_taped) == (before[0], before[1] + 1)
    assert torch.equal(rad, mk.forward(static, depth, 1, *args))
    retrace = (torch.full_like(tape_f, float("nan")),
               torch.full_like(tape_i, -7))
    mk.backward(static, depth, 1, *args, dL, tape=retrace)
    assert torch.equal(tape_f, retrace[0])
    assert torch.equal(tape_i, retrace[1])
    want_rad, want_f, want_i = mk.forward_taped_reference(static, depth, 1,
                                                          *args)
    R = rad.shape[1]
    ints = (tape_i == want_i).reshape(-1, R).all(dim=0)
    f, w = tape_f.reshape(-1, 16, R), want_f.reshape(-1, 16, R)
    scale = w.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    rel = (f - w).abs() / torch.maximum(w.abs(), 1e-2 * scale)
    floats = (rel < 1e-4).all(dim=0).all(dim=0)
    assert (ints & floats).float().mean().item() >= 0.999
    assert _frac_within(rad, want_rad) >= 0.999


@pytest.mark.parametrize("name,depth", [
    ("cornell_box", 8), ("cornell_box", 2), ("simple_scene", 5),
    ("cornell_mirror", 6), ("occluder_scene", 3)])
def test_tape_fed_kernel_is_the_retrace_kernel(cuda, name, depth):
    """The tape-fed kernel on the taped forward's tape gives the retrace
    kernel's cotangents bit for bit, and matches its plain version."""
    static, args, dL = _taped_case(cuda, name, depth)
    _, tape_f, tape_i = mk.forward_taped(static, depth, 1, *args)
    before = (mk.launches_bwd, mk.launches_bwd_tape)
    got = mk.backward_from_tape(static, depth, 1, args[0], args[3], tape_f,
                                tape_i, dL)
    torch.cuda.synchronize()
    assert (mk.launches_bwd, mk.launches_bwd_tape) == (before[0],
                                                       before[1] + 1)
    want = mk.backward(static, depth, 1, *args, dL)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = mk.backward_from_tape_reference(static, depth, 1, args[0],
                                            args[3], tape_f, tape_i, dL)
    _assert_backward_close(got, plain)


def _film_case(cuda, kind, side=1024):
    """Kernel operands of a whole side x side film: Cornell at depth 8, or
    mesh_scene(subdivisions=1), 80 triangle rows, at depth 3."""
    if kind == "cornell_box":
        doc, depth = presets.cornell_box(side, side), 8
    else:
        doc, depth = presets.mesh_scene(side, side, 1), 3
    scene, _ = scene_from_dict(doc, device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert not static.mesh_parts
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, *kt.tile_coords(side, side, 0, cuda), 1), static)
    return static, depth, args, _dL(args[1].shape[1], cuda, seed=5)


@pytest.mark.parametrize("kind", ["cornell_box", "triangle_rows"])
def test_retrace_is_taped_forward_then_tape_fed(cuda, kind):
    """The retrace kernel launches the taped forward's kernel, then the
    tape-fed kernel's sweep: on the full film its tape is forward_taped's
    and its cotangents are backward_from_tape's on that tape, bit for bit.
    It counts one backward launch and no taped forward."""
    static, depth, args, dL = _film_case(cuda, kind)
    _, tape_f, tape_i = mk.forward_taped(static, depth, 1, *args)
    want = mk.backward_from_tape(static, depth, 1, args[0], args[3], tape_f,
                                 tape_i, dL)
    before = (mk.launches_taped, mk.launches_bwd, mk.launches_bwd_tape)
    replay = (torch.full_like(tape_f, float("nan")),
              torch.full_like(tape_i, -7))
    got = mk.backward(static, depth, 1, *args, dL, tape=replay)
    torch.cuda.synchronize()
    assert (mk.launches_taped, mk.launches_bwd, mk.launches_bwd_tape) == (
        before[0], before[1] + 1, before[2])
    assert torch.equal(replay[0], tape_f) and torch.equal(replay[1], tape_i)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["retrace", "tape_fed"])
def test_backward_d_prims_bit_equal_across_runs(cuda, kernel):
    """Each kernel's d_prims (the warps' slot-grouped folds, the blocks'
    fixed-order sum) is bit-equal over two runs, at Cornell 512^2."""
    static, depth, args, dL = _film_case(cuda, "cornell_box", 512)
    if kernel == "retrace":
        run = lambda: mk.backward(static, depth, 1, *args, dL)
    else:
        _, tape_f, tape_i = mk.forward_taped(static, depth, 1, *args)
        run = lambda: mk.backward_from_tape(static, depth, 1, args[0],
                                            args[3], tape_f, tape_i, dL)
    first, second = run(), run()
    assert float(first[0].abs().max()) > 0
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _refill_case(cuda, kind="cornell_box", side=64, n_rays=None):
    """Kernel operands of the refill schedule's scenes: Cornell, Cornell
    with its camera turned away from the box (every ray misses on its
    first trip), or mesh_scene(subdivisions=1), 80 triangle rows; the
    first n_rays rays of a side x side film."""
    if kind == "triangle_rows":
        doc = presets.mesh_scene(side, side, 1)
    else:
        doc = presets.cornell_box(side, side)
    if kind == "looking_away":
        doc["camera"]["lookat"] = [278, 273, -1600]
    scene, _ = scene_from_dict(doc, device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert not static.mesh_parts
    px, py = kt.tile_coords(side, side, 0, cuda)
    if n_rays is not None:
        px, py = px[:n_rays], py[:n_rays]
    return static, kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px, py, 1), static)


@pytest.mark.parametrize("kind,n_rays,max_depth,rr_start", [
    ("cornell_box", 1, 8, 1), ("cornell_box", 31, 8, 1),
    ("cornell_box", 33, 8, 1), ("cornell_box", 1000, 8, 1),
    ("cornell_box", None, 0, 1), ("cornell_box", None, 8, 8),
    ("looking_away", None, 8, 1), ("triangle_rows", None, 3, 1)])
def test_refill_kernel_is_bit_equal(cuda, kind, n_rays, max_depth,
                                    rr_start):
    """The refill schedule (a scene without mesh parts) against the plain
    version, bit for bit: ragged counts that leave lanes and warps
    without a ray, max_depth 0, rays that all die on their first trip,
    no Russian roulette (rr_start = max_depth), and triangle rows. One
    launch counts one forward."""
    static, args = _refill_case(cuda, kind, n_rays=n_rays)
    before = (mk.launches, mk.launches_mesh)
    got = mk.forward(static, max_depth, rr_start, *args)
    torch.cuda.synchronize()
    mesh = kind == "triangle_rows"
    assert (mk.launches, mk.launches_mesh) == (before[0] + (not mesh),
                                               before[1] + mesh)
    want = mk.forward_reference(static, max_depth, rr_start, *args)
    assert torch.equal(got, want)
    if kind == "looking_away":
        assert not got.any()


@pytest.mark.parametrize("n_rays", [33, 1000, None])
def test_refill_taped_kernel_is_bit_equal(cuda, n_rays):
    """The taped forward of triangle rows runs the refill schedule: its
    radiance and both tape planes are forward_taped_reference's bit for
    bit (the dead rows written when a ray dies), and the retrace kernel's
    replay writes the same tape."""
    static, args = _refill_case(cuda, "triangle_rows", n_rays=n_rays)
    rad, tape_f, tape_i = mk.forward_taped(static, 3, 1, *args)
    want = mk.forward_taped_reference(static, 3, 1, *args)
    torch.cuda.synchronize()
    assert torch.equal(rad, want[0])
    assert torch.equal(tape_f, want[1]) and torch.equal(tape_i, want[2])
    replay = (torch.full_like(tape_f, float("nan")),
              torch.full_like(tape_i, -7))
    mk.backward(static, 3, 1, *args, _dL(rad.shape[1], cuda), tape=replay)
    assert torch.equal(replay[0], tape_f) and torch.equal(replay[1], tape_i)


@pytest.mark.parametrize("kind", ["cornell_box", "triangle_rows"])
def test_refill_kernel_counting_build(cuda, kind):
    """At 512^2, two launches are bit-equal (which lane traces a ray, and
    when, varies), the counting build's radiance is the kernel's, its lane
    trips are the tape's trips exactly, and its warp trips are a multiple
    of 32 at least the lane trips."""
    static, args = _refill_case(cuda, kind, side=512)
    depth = 3 if kind == "triangle_rows" else 8
    first = mk.forward(static, depth, 1, *args)
    second = mk.forward(static, depth, 1, *args)
    trips = torch.zeros(len(mk.TRIP_COUNTS), dtype=torch.int64,
                        device=cuda)
    counted = mk.forward(static, depth, 1, *args, trips=trips)
    _, _, tape_i = mk.forward_taped(static, depth, 1, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(counted, first)
    lane_trips, warp_trips = trips.tolist()
    assert lane_trips == int(mk.trips_from_tape(tape_i).sum())
    assert warp_trips % 32 == 0 and warp_trips >= lane_trips


@pytest.mark.parametrize("kind,n_rays,max_depth,rr_start", [
    ("cornell_box", 1, 8, 1), ("cornell_box", 7, 8, 1),
    ("cornell_box", 8, 8, 1), ("cornell_box", 9, 8, 1),
    ("cornell_box", 15, 8, 1), ("cornell_box", 16, 8, 1),
    ("cornell_box", 17, 8, 1), ("cornell_box", 1000, 8, 1),
    ("cornell_box", 1003, 8, 1),
    ("cornell_box", None, 0, 1), ("cornell_box", None, 8, 8),
    ("looking_away", None, 8, 1)])
def test_group_taped_kernel_is_bit_equal(cuda, kind, n_rays, max_depth,
                                         rr_start):
    """The taped forward of a scene without triangle rows runs the group
    schedule: its radiance and both tape planes are
    forward_taped_reference's bit for bit at ray counts that leave a group,
    a warp or a block part empty, at max_depth 0, without Russian roulette
    and with rays that all die on their first trip. One launch counts one
    taped forward."""
    static, args = _refill_case(cuda, kind, n_rays=n_rays)
    assert not static.mesh_mode
    before = (mk.launches, mk.launches_taped)
    got = mk.forward_taped(static, max_depth, rr_start, *args)
    torch.cuda.synchronize()
    assert (mk.launches, mk.launches_taped) == (before[0], before[1] + 1)
    want = mk.forward_taped_reference(static, max_depth, rr_start, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind == "looking_away":
        assert not got[0].any()


def test_group_taped_kernel_counting_build(cuda):
    """At 512^2, depth 8, two launches of the group schedule are bit-equal
    (which warp traces a group, and when, varies); its counting build
    writes the same radiance and tape, its lane trips are the tape's trips
    exactly, and its warp trips are a multiple of 32 whose share of busy
    lanes beats warps of 32 consecutive rays."""
    static, args = _refill_case(cuda, side=512)
    first = mk.forward_taped(static, 8, 1, *args)
    second = mk.forward_taped(static, 8, 1, *args)
    trips = torch.zeros(len(mk.TRIP_COUNTS), dtype=torch.int64,
                        device=cuda)
    counted = mk.forward_taped(static, 8, 1, *args, trips=trips)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, counted):
        assert torch.equal(a, b) and torch.equal(a, c)
    lane_trips, warp_trips = trips.tolist()
    tape_trips = mk.trips_from_tape(first[2])
    assert lane_trips == int(tape_trips.sum())
    assert warp_trips % 32 == 0 and warp_trips >= lane_trips
    assert lane_trips / warp_trips > mk.schedule_efficiency(tape_trips)


@pytest.mark.parametrize("n_rays", [1000, 1003])
def test_group_tape_fed_is_the_retrace_kernel(cuda, n_rays):
    """On the group schedule's tape, a ragged last group included, the
    tape-fed kernel gives the retrace kernel's cotangents bit for bit, and
    the retrace kernel's replay, the same build, writes the same tape."""
    static, args = _refill_case(cuda, n_rays=n_rays)
    _, tape_f, tape_i = mk.forward_taped(static, 8, 1, *args)
    dL = _dL(n_rays, cuda, seed=3)
    replay = (torch.full_like(tape_f, float("nan")),
              torch.full_like(tape_i, -7))
    want = mk.backward(static, 8, 1, *args, dL, tape=replay)
    got = mk.backward_from_tape(static, 8, 1, args[0], args[3], tape_f,
                                tape_i, dL)
    torch.cuda.synchronize()
    assert torch.equal(replay[0], tape_f) and torch.equal(replay[1], tape_i)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _wide_cornell(w, h):
    """Cornell with four spectra added, two of them read by walls: S = 10,
    each ray's d_spect column 40 rows."""
    doc = presets.cornell_box(w, h)
    doc["spectra"].update({
        f"pad{i}": {"wavelength": [400, 550, 700],
                    "value": [0.2 + 0.1 * i, 0.5, 0.6 - 0.1 * i]}
        for i in range(4)})
    doc["objects"]["patches"][0]["reflectance"] = "pad0"
    doc["objects"]["patches"][1]["reflectance"] = "pad1"
    return doc


def test_backward_kernels_on_many_spectra(cuda):
    """Both backward kernels on a scene of 10 spectra: within the plain
    version's tolerances, bit-equal on one tape, and the added rows get a
    gradient."""
    scene, _ = scene_from_dict(_wide_cornell(128, 96), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert static.n_spectra == 10
    args = _inputs(scene, 128, 96, 3)
    dL = _dL(args[1].shape[1], cuda, seed=6)
    got = mk.backward(static, 6, 1, *args, dL)
    _assert_backward_close(got, mk.backward_reference(static, 6, 1, *args,
                                                      dL))
    _, tape_f, tape_i = mk.forward_taped(static, 6, 1, *args)
    taped = mk.backward_from_tape(static, 6, 1, args[0], args[3], tape_f,
                                  tape_i, dL)
    for g, w in zip(taped, got):
        assert torch.equal(g, w)
    for row in static.reflectance_idx[:2]:
        assert got[2][4 * row:4 * row + 4].abs().max() > 0


def test_card_taped_gradient_matches_cpu(cuda):
    """render_sample(backward="pallas_taped") on the card: one taped
    forward and one tape-fed backward, no retrace, and the CPU's
    gradient."""
    w, h = 48, 32
    cpu_scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")

    def grads(scene):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        (kt.render_sample(s, w, h, 1, max_depth=4, backward="pallas_taped")
         ** 2).sum().backward()
        return sp.grad, d1.grad

    before = (mk.launches, mk.launches_taped, mk.launches_bwd,
              mk.launches_bwd_tape)
    card = grads(cpu_scene.to(cuda))
    assert (mk.launches, mk.launches_taped, mk.launches_bwd,
            mk.launches_bwd_tape) == (before[0], before[1] + 1, before[2],
                                      before[3] + 1)
    host = grads(cpu_scene)
    for c, h_ in zip(card, host):
        c, h_ = c.cpu().numpy(), h_.numpy()
        assert np.isfinite(c).all()
        scale = max(np.abs(h_).max(), 1e-6)
        np.testing.assert_allclose(c / scale, h_ / scale, rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("subdivisions,mesh_min,depth", [
    (3, 256, 3), (2, 64, 8), (1, 256, 3), (4, 256, 2)])
def test_mesh_kernel_matches_plain_version(cuda, subdivisions, mesh_min,
                                           depth):
    """The mesh mode (mesh parts traversed per ray, triangle rows in the
    unrolled scan) against its plain version: at least 99.9% of rays
    within rel 1e-4, all finite."""
    scene, _ = scene_from_dict(presets.mesh_scene(96, 64, subdivisions),
                               device=cuda)
    static = mk.SceneStatic.from_scene(scene, mesh_min=mesh_min)
    assert static.mesh_mode
    px, py = kt.tile_coords(96, 64, 0, cuda)
    o, d, hero, seed = kt.camera_planes(scene, 96, 64, px, py, 2)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    before = (mk.launches, mk.launches_mesh)
    got = mk.forward(static, depth, 1, *args, *arrays)
    torch.cuda.synchronize()
    assert (mk.launches, mk.launches_mesh) == (before[0], before[1] + 1)
    want = mk.forward_reference(static, depth, 1, *args, *arrays)
    assert torch.isfinite(got).all()
    assert _frac_within(got, want) >= 0.999
    assert got.abs().max() > 0


def test_card_mesh_render(cuda):
    """A mesh render on the card: one mesh-mode launch per sample, and
    the CPU's image to 2e-4 on 99% of pixels."""
    cfg = RenderConfig(width=32, height=24, spp=2, max_depth=3)
    cpu_scene, _ = scene_from_dict(presets.mesh_scene(32, 24, 3),
                                   device="cpu")
    before = mk.launches_mesh
    card = api.render(cpu_scene.to(cuda), cfg)["accum_xyz"].cpu().numpy()
    assert mk.launches_mesh == before + 2
    host = api.render(cpu_scene, cfg)["accum_xyz"].numpy()
    close = np.isclose(card, host, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.99


def test_mesh_kernel_counting_build(cuda):
    """forward(..., work=) runs the mesh kernel's counting build: the same
    radiance bit for bit, and counts that add up across launches."""
    scene, _ = scene_from_dict(presets.mesh_scene(48, 32, 3), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(48, 32, 0, cuda)
    o, d, hero, seed = kt.camera_planes(scene, 48, 32, px, py, 1)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    want = mk.forward(static, 3, 1, *args, *arrays)
    work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=cuda)
    got = mk.forward(static, 3, 1, *args, *arrays, work=work)
    assert torch.equal(got, want)
    casts, boxes, planes, inside, scans, lanes, needed = counts = \
        work.tolist()
    assert casts >= 48 * 32          # a closest-hit scan per camera ray
    assert boxes >= casts            # each cast tests the root box
    assert planes > 0 and 0 < inside <= planes
    # the inside tests any scan order needs are among those the lanes made
    assert 0 < needed <= inside
    # every chunk scan ran on 1 to 32 lanes, and tested its triangles once
    assert 0 < scans <= lanes <= 32 * scans
    assert planes <= 128 * scans
    mk.forward(static, 3, 1, *args, *arrays, work=work)
    assert work.tolist() == [2 * c for c in counts]


def _mesh_case(cuda, subdivisions, mesh_min, w=64, h=48, sample=2):
    scene, _ = scene_from_dict(presets.mesh_scene(w, h, subdivisions),
                               device=cuda)
    static = mk.SceneStatic.from_scene(scene, mesh_min=mesh_min)
    px, py = kt.tile_coords(w, h, 0, cuda)
    o, d, hero, seed = kt.camera_planes(scene, w, h, px, py, sample)
    args = kt.kernel_inputs(scene, o, d, hero, seed, static)
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    return static, args, arrays


@pytest.mark.parametrize("scene_kind,depth", [
    ("mesh_part", 3), ("triangle_rows", 3), ("cornell_box", 8)])
def test_winners_kernel_matches_plain_version(cuda, scene_kind, depth):
    """The winner-taped forward (build_forward(taped=True)): its radiance
    is the untaped kernel's bit for bit, and its tapes are
    forward_winners_reference's, in the mesh mode (a mesh part, or
    triangle rows) and in the plain mode."""
    if scene_kind == "cornell_box":
        scene, _ = scene_from_dict(presets.cornell_box(64, 48), device=cuda)
        static = mk.SceneStatic.from_scene(scene)
        args, arrays = _inputs(scene, 64, 48, 2), []
    else:
        static, args, arrays = _mesh_case(
            cuda, 2 if scene_kind == "mesh_part" else 1,
            64 if scene_kind == "mesh_part" else 256)
        assert bool(static.mesh_parts) == (scene_kind == "mesh_part")
    before = (mk.launches, mk.launches_mesh, mk.launches_winners)
    rad, t_idx, t_sh = mk.forward_winners(static, depth, 1, *args, *arrays)
    torch.cuda.synchronize()
    assert (mk.launches, mk.launches_mesh, mk.launches_winners) == (
        before[0], before[1], before[2] + 1)
    assert torch.equal(rad, mk.forward(static, depth, 1, *args, *arrays))
    want = mk.forward_winners_reference(static, depth, 1, *args, *arrays)
    assert torch.equal(t_idx, want[1]) and torch.equal(t_sh, want[2])
    assert _frac_within(rad, want[0]) >= 0.999
    assert (t_idx[0] >= 0).any() and (t_sh >= 0).any()


def test_triangle_row_backward_kernels(cuda):
    """Both backward kernels on a scene with 80 triangle rows, whose
    replay and recompute scan them in the mesh mode (a backward that
    skipped them would trace other paths): each within its plain
    version's tolerances, the two bit-equal on one tape, and the mesh
    rows' vertices get a gradient."""
    static, args, arrays = _mesh_case(cuda, 1, 256)
    assert not arrays and 2 in static.categories
    dL = _dL(args[1].shape[1], cuda, seed=4)
    got = mk.backward(static, 3, 1, *args, dL)
    _assert_backward_close(got, mk.backward_reference(static, 3, 1, *args,
                                                      dL))
    rad, tape_f, tape_i = mk.forward_taped(static, 3, 1, *args)
    assert torch.equal(rad, mk.forward(static, 3, 1, *args))
    want_rad, _, want_i = mk.forward_taped_reference(static, 3, 1, *args)
    assert (tape_i == want_i).all(dim=0).float().mean().item() >= 0.999
    taped = mk.backward_from_tape(static, 3, 1, args[0], args[3], tape_f,
                                  tape_i, dL)
    for g, w in zip(taped, got):
        assert torch.equal(g, w)
    tri = [k for k, c in enumerate(static.categories) if c == 2]
    assert got[0][tri, :9].abs().max() > 0


def test_card_mesh_gradient_matches_cpu(cuda):
    """The gradient of sum(render_sample ** 2) of a scene with a mesh part
    through the guided replay: one winner-taped forward and no backward
    kernel on the card, the CPU's gradient, non-zero on the mesh rows,
    and bit-equal across two runs on the card (the replay's row gather
    sums its cotangents in a fixed order)."""
    w, h = 48, 32
    cpu_scene, _ = scene_from_dict(presets.mesh_scene(w, h, 1),
                                   device="cpu")
    static = mk.SceneStatic.from_scene(cpu_scene, mesh_min=16)
    assert static.mesh_parts

    def grads(scene):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        (kt.render_sample(s, w, h, 1, max_depth=3, static=static)
         ** 2).sum().backward()
        return sp.grad, d1.grad

    before = (mk.launches_winners, mk.launches_bwd, mk.launches_bwd_tape)
    card = grads(cpu_scene.to(cuda))
    assert (mk.launches_winners, mk.launches_bwd, mk.launches_bwd_tape) == (
        before[0] + 1, before[1], before[2])
    again = grads(cpu_scene.to(cuda))
    for a, b in zip(card, again):
        assert torch.equal(a, b)
    host = grads(cpu_scene)
    assert card[1][6:].abs().max() > 0
    for c, h_ in zip(card, host):
        c, h_ = c.cpu().numpy(), h_.numpy()
        assert np.isfinite(c).all()
        scale = max(np.abs(h_).max(), 1e-6)
        np.testing.assert_allclose(c / scale, h_ / scale, rtol=1e-3,
                                   atol=1e-4)


def _two_lights(doc):
    """A second light patch on the left wall (the per-light planes)."""
    light = doc["objects"]["patches"][2]
    doc["objects"]["patches"].append(dict(
        light, origin=[1.0, 150.0, 200.0], edge1=[0.0, 0.0, 120.0],
        edge2=[0.0, 120.0, 0.0]))
    return doc


def _wavefront_case(cuda, lights=1, w=64, h=48):
    doc = presets.mesh_scene(w, h, 3)
    if lights == 2:
        doc = _two_lights(doc)
    scene, _ = scene_from_dict(doc, device=cuda)
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    assert static.mesh_parts and len(static.light_rows) == lights
    px, py = kt.tile_coords(w, h, 0, cuda)
    planes = kt.camera_planes(scene, w, h, px, py, 2)
    args = kt.kernel_inputs(scene, *planes, static)
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    return scene, static, planes, args, arrays


def test_walk_kernel_matches_plain_version(cuda):
    """The seeded walk (walk.cu) against walk_reference, bit for bit, on
    camera rays seeded empty, with a bound just beyond or short of the
    mesh hit, and inactive (t = -inf, which comes back unchanged); its
    counting build gives the same winners and one cast per active
    lane."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    _, static, _, args, arrays = _wavefront_case(cuda)
    rays = args[1]
    R = rays.shape[1]
    seed_f = torch.zeros((4, R), device=cuda)
    seed_f[0] = torch.inf
    seed_i = torch.full((2, R), -1, dtype=torch.int32, device=cuda)
    t_hit = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)[0][0]
    lane = torch.arange(R, device=cuda)
    kind = lane % 3
    bound = t_hit * torch.where(lane % 2 == 0, 1.001, 0.999)
    seed_f[0] = torch.where(kind == 0, torch.inf,
                            torch.where(kind == 1, bound, -torch.inf))
    before = bn.launches_walk
    got = bn.walk(static, rays, seed_f, seed_i, *arrays)
    torch.cuda.synchronize()
    assert bn.launches_walk == before + 1
    want = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0][:, kind == 2], seed_f[:, kind == 2])
    hit = got[1][0] >= 0
    assert (hit & (kind == 0)).any() and (hit & (kind == 1)).any()
    short = (kind == 1) & (lane % 2 == 1) & torch.isfinite(t_hit)
    assert short.any() and not (hit & short).any()
    work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=cuda)
    counted = bn.walk(static, rays, seed_f, seed_i, *arrays, work=work)
    for g, w in zip(counted, got):
        assert torch.equal(g, w)
    casts, boxes, planes, inside, scans, lanes, needed = work.tolist()
    assert casts == int((kind != 2).sum())
    assert boxes >= casts and 0 < needed <= inside <= planes
    # the walk's warps scan every chunk on all 32 lanes
    assert scans > 0 and lanes == 32 * scans and planes <= 128 * scans


def test_walk_kernel_ragged_warps(cuda):
    """The walk at R = 1,000 (the last warp's last 24 lanes beyond the
    rays), every third lane inactive (t = -inf): the idle lanes help the
    others scan their chunks, and the winners are walk_reference's bit for
    bit."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    _, static, _, args, arrays = _wavefront_case(cuda)
    R = 1000
    rays = args[1][:, 1408:1408 + R].contiguous()  # rows across the blob
    lane = torch.arange(R, device=cuda)
    seed_f = torch.zeros((4, R), device=cuda)
    seed_f[0] = torch.where(lane % 3 == 2, -torch.inf, torch.inf)
    seed_i = torch.stack([torch.full((R,), -1, device=cuda),
                          torch.where(lane % 7 == 0,
                                      static.mesh_parts[0].start + lane,
                                      -1)]).to(torch.int32)
    got = bn.walk(static, rays, seed_f, seed_i, *arrays)
    torch.cuda.synchronize()
    want = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][0] >= 0).sum() > R // 8
    assert torch.equal(got[0][:, lane % 3 == 2], seed_f[:, lane % 3 == 2])


def _tie_seeds(cuda, static, rays, arrays):
    """Per lane i of the tie rays: empty, bounded at exactly the grid's t
    (or short of it on odd lanes), or inactive, by i % 3; every fifth lane
    excludes the winner of an unseeded walk."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    R = rays.shape[1]
    seed_f = torch.zeros((4, R), device=cuda)
    seed_f[0] = torch.inf
    seed_i = torch.full((2, R), -1, dtype=torch.int32, device=cuda)
    first = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)[1][0]
    lane = torch.arange(R, device=cuda)
    grid_t = float(presets.TIE_GRID[3])
    bound = torch.where(rays[3] == 0,
                        torch.where(lane % 2 == 0, grid_t, grid_t - 0.01),
                        1e3)
    seed_f[0] = torch.where(lane % 3 == 0, torch.inf,
                            torch.where(lane % 3 == 1, bound, -torch.inf))
    seed_i[1] = torch.where(lane % 5 == 1, first, -1)
    return seed_f, seed_i


@pytest.mark.parametrize("layout", presets.TIE_LAYOUTS)
def test_tie_mesh_kernels(cuda, layout):
    """On tie_mesh_scene (exact ties: duplicated triangles, in one chunk or
    across two, and shared edges and vertices), the walk kernel on
    tie_mesh_rays and the mesh-mode forward and winner-taped forward on
    camera rays against their plain versions: the walk's t, normals and idx
    bit for bit, the winner tapes equal and the radiance bit-equal."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    scene, _ = scene_from_dict(presets.tie_mesh_scene(64, 48, layout),
                               device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert len(static.mesh_parts) == 1
    arrays = [a for p in kt.mesh_packs_for(scene, static) for a in p.arrays]
    rays = torch.from_numpy(presets.tie_mesh_rays(1000, seed=2)).to(cuda)
    seed_f, seed_i = _tie_seeds(cuda, static, rays, arrays)
    got = bn.walk(static, rays, seed_f, seed_i, *arrays)
    want = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][0] >= 0).sum() > 200

    px, py = kt.tile_coords(64, 48, 0, cuda)
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, 64, 48, px, py,
                                                     1), static)
    rad = mk.forward(static, 3, 1, *args, *arrays)
    win = mk.forward_winners(static, 3, 1, *args, *arrays)
    torch.cuda.synchronize()
    want = mk.forward_winners_reference(static, 3, 1, *args, *arrays)
    assert torch.equal(win[0], rad)
    assert torch.equal(win[1], want[1]) and torch.equal(win[2], want[2])
    assert torch.equal(rad, want[0])
    on_mesh = (win[1] >= static.mesh_parts[0].start).sum()
    assert on_mesh > 500


@pytest.mark.parametrize("lights,scan_in_kernel", [
    (1, True), (1, False), (2, True), (2, False)])
def test_shade_step_kernel_matches_plain_version(cuda, lights,
                                                 scan_in_kernel):
    """Both builds of the shade step (shade_step.cu) against
    shade_step_reference on the same carries and mesh winners (the first
    bounce; the second, fed the first step's unrolled winner): every
    output bit for bit."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    _, static, _, args, arrays = _wavefront_case(cuda, lights)
    prims, rays, seeds, spect = args
    R = rays.shape[1]
    carry_f = torch.cat([rays, torch.zeros((4, R), device=cuda),
                         torch.ones((6, R), device=cuda)])
    carry_u = mk._u32_bits(seeds)
    carry_i = torch.tensor([-1, 0, 0, 1], dtype=torch.int32, device=cuda)[
        :, None].expand(4, R).contiguous()
    depth, un = 0, ()

    def walk(carry_f, carry_i, bound):
        active = carry_i[3] != 0
        seed_f = torch.zeros((4, R), device=cuda)
        seed_f[0] = torch.where(active, bound, -torch.inf)
        seed_i = torch.stack([torch.full_like(carry_i[0], -1), carry_i[0]])
        mesh_f, mesh_i = bn.walk(static, carry_f[:6].contiguous(), seed_f,
                                 seed_i, *arrays)
        mesh_f[0][~active] = torch.inf
        return mesh_f, mesh_i

    mesh = walk(carry_f, carry_i, torch.full((R,), torch.inf, device=cuda))
    if not scan_in_kernel:
        out = mk.shade_step(static, 0, 3, 1, prims, carry_f, carry_u,
                            carry_i, spect, *mesh)
        carry_f, carry_u, carry_i = out[:3]
        depth, un = 1, out[6:]
        mesh = walk(carry_f, carry_i, un[0][0])
    inputs = (static, depth, 3, 1, prims, carry_f, carry_u, carry_i, spect,
              *mesh, *un)
    before = mk.launches_shade
    got = mk.shade_step(*inputs)
    torch.cuda.synchronize()
    assert mk.launches_shade == before + 1
    want = mk.shade_step_reference(*inputs)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    lsel = got[5][1::2] != 0
    assert lsel.any(dim=1).all()  # every light picked somewhere
    assert (got[3] >= 0).any() and (got[2][3] != 0).any()


def test_card_wavefront(cuda):
    """wavefront=True on the card: radiance bit-equal to the mesh forward
    kernel's, through shade-step launches (one per bounce) and the binned
    casts' launches only, as many as the casts logged (per pipeline and
    mesh part one candidate and one pair launch, the walk where rays were
    left unresolved); untaped, the shadow casts are any-hit casts. Under
    grad the same path runs taped, with closest-hit shadow casts, and its
    gradients are bit-equal to the in-kernel path's."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    scene, static, planes, args, arrays = _wavefront_case(cuda, lights=2)
    depth = 3
    want = mk.forward(static, depth, 1, *args, *arrays)
    counters = lambda: (mk.launches, mk.launches_mesh, mk.launches_winners,
                        mk.launches_shade, bn.launches_candidates,
                        bn.launches_pair, bn.launches_pair_occl,
                        bn.launches_walk)

    def logged(fn):
        before = counters()
        bn.cast_log = log = []
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            bn.cast_log = None
        n = bn.logged_launches(log)
        expect = (0, 0, 0, depth + 1, n["candidates"], n["pair"],
                  n["pair_occl"], n["walk"])
        assert tuple(a - b for a, b in zip(counters(), before)) == expect
        assert n["candidates"] > 0
        return out, n

    got, n = logged(lambda: kt.trace_radiance(
        scene, *planes, depth, static=static, backward="none",
        wavefront=True))
    assert n["pair_occl"] > 0
    assert torch.equal(got, want)

    def grads(wavefront):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        img = kt.render_sample(s, 64, 48, 2, depth, static=static,
                               wavefront=wavefront)
        return torch.autograd.grad((img ** 2).sum(), (sp, d1))

    wf, n = logged(lambda: grads(True))
    assert n["pair_occl"] == 0
    for a, b in zip(wf, grads(False)):
        assert torch.equal(a, b)
    assert wf[1][6:].abs().max() > 0


def _blob_rays(cuda, R, seed=0):
    """The port's pack of displaced_blob(4) (5,120 triangles, 40 chunks in
    three supernodes) on the card, and R random rays around it."""
    from computeraytracer_tpu_torch.kernels import meshpack
    from computeraytracer_tpu_torch.scene import mesh as mesh_ops

    verts, faces = mesh_ops.displaced_blob(4)
    v = [torch.tensor(verts[faces[:, c]], dtype=torch.float32, device=cuda)
         for c in range(3)]
    pack = meshpack.pack_mesh(*v, torch.arange(len(faces), device=cuda))
    g = np.random.default_rng(seed)
    o = g.uniform(-2, 2, (3, R))
    d = g.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0)
    rays = torch.tensor(np.concatenate([o, d]), dtype=torch.float32,
                        device=cuda)
    bound = torch.tensor(g.uniform(0.5, 10, R), dtype=torch.float32,
                         device=cuda)
    active = torch.tensor(g.uniform(size=R) < 0.8, device=cuda)
    return pack, rays, bound, active


@pytest.mark.parametrize("k", [1, 4, 6])
def test_candidates_kernel_matches_plain_version(cuda, k):
    """The candidate kernel (candidates.cu) against candidates_reference on
    the same card tensors, bit for bit, with an active mask and a bound;
    its counting build gives the same slots, one cast per active lane and
    at least one slab test per supernode."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    pack, rays, bound, active = _blob_rays(cuda, 8192)
    n_real = pack.tri_rows.shape[0] // 16
    bbox = pack.chunk_bbox[:n_real]
    before = bn.launches_candidates
    got = bn.candidates(bbox, rays, bound, k, active)
    torch.cuda.synchronize()
    assert bn.launches_candidates == before + 1
    padded = bound + bound.abs() * bn.PAD_BOUND
    rays7 = torch.cat([rays, torch.where(active, padded, -torch.inf)[None]])
    want = bn.candidates_reference(rays7, bbox, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] >= 0).any() and torch.isfinite(got[1]).any()
    work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=cuda)
    counted = bn.candidates(bbox, rays, bound, k, active, work=work)
    for g, w in zip(counted, got):
        assert torch.equal(g, w)
    casts, slabs, plane, inside, passes, chunk_tests, needed = work.tolist()
    assert casts == int(active.sum()) and plane == inside == needed == 0
    assert slabs == casts * -(-n_real // bn.SUP_CHUNKS) + chunk_tests
    sched = bn.candidates_drained_reference(rays7, bbox, k)[2]
    assert (passes, chunk_tests) == (sched["warp_trips"],
                                     sched["lane_trips"])


def _tie_boxes(n, g):
    """(n, 8) f32 chunk boxes (tests/test_torch_binned_drain.py's): each run
    of 16 around a centre of its own, every fifth box a copy of the one
    before it, every seventh sharing its near corner with the one before
    it."""
    centre = np.repeat(g.uniform(-2, 2, (-(-n // 16), 3)), 16, axis=0)[:n]
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


@pytest.mark.parametrize("k", [1, 4, 6])
@pytest.mark.parametrize("n_chunks", [600, 2000])
def test_candidates_kernel_mask_groups(cuda, k, n_chunks):
    """The warp-drained candidate kernel against candidates_reference bit
    for bit, at 600 chunks (38 supernodes: two groups of 32, the last
    supernode half full) and 2,000 chunks (125 supernodes: four groups,
    68,000 bytes of boxes, more than the one-thread pass staged in shared
    memory); 8 coherent warps (supernodes most lanes enter,
    tested lane by lane) and incoherent rays (drained; a quarter with
    positive direction components), a fifth of the lanes inactive, a
    ragged last warp, and boxes with equal entry distances; the counting
    build's warp trips and chunk tests equal the plain model's."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    g = np.random.default_rng(n_chunks + k)
    R = 1000
    bbox = torch.tensor(_tie_boxes(n_chunks, g), device=cuda)
    o = g.uniform(-3, 3, (3, R))
    d = g.normal(size=(3, R))
    d[:, ::4] = np.abs(d[:, ::4])
    o[:, ::4] = g.uniform(-3, -2, (3, R))[:, ::4]
    o[:, :256] = -3 + g.uniform(-0.05, 0.05, (3, 256))
    d[:, :256] = 1 + g.uniform(-0.1, 0.1, (3, 256))
    d /= np.linalg.norm(d, axis=0)
    bound = np.where(g.uniform(size=R) < 0.2, -np.inf,
                     g.uniform(0.5, 10, R))
    rays7 = torch.tensor(np.concatenate([o, d, bound[None]]),
                         dtype=torch.float32, device=cuda)
    got = bn.candidate_kernel(rays7, bbox, k)
    torch.cuda.synchronize()
    cand, t_next, sched = bn.candidates_drained_reference(rays7, bbox, k)
    want = bn.candidates_reference(rays7, bbox, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(cand, want[0]) and torch.equal(t_next, want[1])
    assert (got[0] >= 0).sum(0).max() == k
    work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=cuda)
    counted = bn.candidate_kernel(rays7, bbox, k, work=work)
    assert torch.equal(counted[0], got[0])
    w = work.tolist()
    assert (w[4], w[5]) == (sched["warp_trips"], sched["lane_trips"])


def test_pair_kernels_match_plain_version(cuda):
    """Both instantiations of pair.cu against pair_reference and
    pair_occluded_reference on the chunk-sorted pairs of the candidate
    kernel, bit for bit; the flag is the closest hit's t <= t_light;
    chunk ids at or beyond the real count test nothing; the counting
    builds give the same outputs and count every live pair."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    pack, rays, bound, active = _blob_rays(cuda, 8192, seed=1)
    n_real = pack.tri_rows.shape[0] // 16
    cand, _ = bn.candidates(pack.chunk_bbox[:n_real], rays, None, 6, active)
    exclude = torch.randint(-1, 5120, (8192,), dtype=torch.int32,
                            device=cuda, generator=torch.Generator(
                                device=cuda).manual_seed(0))
    pair_f, pair_i, _ = bn._pairs(cand, rays, exclude, bound)
    pair_i[0, -4:] = torch.tensor([n_real, n_real + 1, 1 << 30, -1],
                                  dtype=torch.int32, device=cuda)
    before = (bn.launches_pair, bn.launches_pair_occl)
    got = bn.pair_intersect(pair_f, pair_i, pack.tri_rows)
    flag = bn.pair_occluded(pair_f, pair_i, pack.tri_rows)
    torch.cuda.synchronize()
    assert (bn.launches_pair, bn.launches_pair_occl) == (before[0] + 1,
                                                         before[1] + 1)
    want = bn.pair_reference(pair_f, pair_i, pack.tri_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(flag, bn.pair_occluded_reference(pair_f, pair_i,
                                                        pack.tri_rows))
    hit = got[1][0] >= 0
    derived = hit & (got[0][0] <= pair_f[6])
    assert torch.equal(flag[0] != 0, derived)
    assert derived.any() and (hit & ~derived).any()
    assert not hit[-4:].any() and not flag[0, -4:].any()
    live = int(((pair_i[0] >= 0) & (pair_i[0] < n_real)).sum())
    for fn, out in ((bn.pair_intersect, got), (bn.pair_occluded, (flag,))):
        work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=cuda)
        counted = fn(pair_f, pair_i, pack.tri_rows, work=work)
        counted = counted if isinstance(counted, tuple) else (counted,)
        for g, w in zip(counted, out):
            assert torch.equal(g, w)
        pairs, boxes, planes, inside, *rest = work.tolist()
        assert pairs == live and 0 < inside <= planes <= 128 * live
        assert boxes == 0 and rest == [0] * (mk.WORK_KINDS - 4)


def test_pair_kernels_on_mixed_chunks(cuda):
    """Both pair kernels against pair_reference and pair_occluded_reference
    bit for bit on pairs that are not sorted: the chunk changes from lane
    to lane inside a warp, and runs of 40 pairs change it inside a block;
    dead pairs (chunk -1 and at or beyond the real chunks) sit among the
    live ones; on tie_mesh_scene (exact ties inside one chunk and across
    chunks) with tie_mesh_rays, a fifth excluding their winner, and
    t_light at exactly the closest hit on half the pairs."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    for layout in presets.TIE_LAYOUTS:
        scene, _ = scene_from_dict(presets.tie_mesh_scene(64, 48, layout),
                                   device=cuda)
        static = mk.SceneStatic.from_scene(scene)
        arrays = [a for p in kt.mesh_packs_for(scene, static)
                  for a in p.arrays]
        tri_rows, _ = bn._part(arrays, 0)
        n_chunks = tri_rows.shape[0] // 16
        rays = torch.from_numpy(presets.tie_mesh_rays(2000, seed=4)).to(cuda)
        g = torch.Generator(device=cuda).manual_seed(5)
        P = 3 * rays.shape[1]
        ray = torch.randint(0, rays.shape[1], (P,), generator=g,
                            device=cuda)
        lane_chunk = torch.randint(-1, n_chunks + 2, (P,), generator=g,
                                   device=cuda)
        run_chunk = (torch.arange(P, device=cuda) // 40) % n_chunks
        chunk = torch.where(torch.arange(P, device=cuda) < P // 2,
                            lane_chunk, run_chunk).to(torch.int32)
        pair_f = torch.cat([rays[:, ray], torch.zeros(1, P, device=cuda)])
        pair_i = torch.stack([chunk, torch.full_like(chunk, -1)])
        first = bn.pair_reference(pair_f, pair_i, tri_rows)[1][0]
        pair_i[1] = torch.where(ray % 5 == 1, first, -1)
        want = bn.pair_reference(pair_f, pair_i, tri_rows)
        t_hit = want[0][0]
        pair_f[6] = torch.where(torch.isfinite(t_hit),
                                torch.where(ray % 2 == 0, t_hit,
                                            0.5 * t_hit), 1e3)
        got = bn.pair_intersect(pair_f, pair_i, tri_rows)
        flag = bn.pair_occluded(pair_f, pair_i, tri_rows)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        want_flag = bn.pair_occluded_reference(pair_f, pair_i, tri_rows)
        assert torch.equal(flag, want_flag)
        hit = want[1][0] >= 0
        assert hit.sum() > 500 and (flag[0] == 0).any() and flag[0].any()
        dead = (chunk < 0) | (chunk >= n_chunks)
        assert dead.any() and not hit[dead].any()


def test_binned_casts_match_walk(cuda):
    """On the card, mesh_closest_hit (default k, and k = 1 through each
    finish of _walk_finish at 16,384 rays) and the batched cast equal the
    walk kernel seeded empty on every lane; mesh_occluded and its batched
    form equal the flag derived from the closest hit."""
    from computeraytracer_tpu_torch.kernels import binned as bn

    _, static, _, _, arrays = _wavefront_case(cuda)
    R = 16384
    g = np.random.default_rng(2)
    bb = arrays[1][:arrays[0].shape[0] // 16].cpu().numpy()
    lo, hi = bb[:, 0:3].min(0), bb[:, 3:6].max(0)
    ctr, ext = (lo + hi) / 2, hi - lo
    on = ctr + g.uniform(-1.5, 1.5, (R, 3)) * ext
    dn = ctr + g.uniform(-0.5, 0.5, (R, 3)) * ext - on
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    rays = torch.tensor(np.ascontiguousarray(np.concatenate([on.T, dn.T])),
                        dtype=torch.float32, device=cuda)
    exclude = torch.full((R,), -1, dtype=torch.int32, device=cuda)

    def walked(active):
        seed_f = torch.zeros((4, R), device=cuda)
        seed_f[0] = torch.where(active, torch.inf, -torch.inf)
        f, i = bn.walk(static, rays, seed_f,
                       torch.stack([torch.full_like(exclude, -1), exclude]),
                       *arrays)
        f[0][~active] = torch.inf
        return f, i

    tri_rows, bbox = bn._part(arrays, 0)
    unres = ~bn.mesh_winner(tri_rows, bbox, rays, exclude, k=1)[3]
    ids = torch.nonzero(unres)[:, 0]
    res_ids = torch.nonzero(~unres)[:, 0]
    assert ids.shape[0] > 2048
    bn.cast_log = log = []
    try:
        for n_unres, finish in ((0, None), (700, 1024), (1500, 2048),
                                (ids.shape[0], "full")):
            active = torch.zeros(R, dtype=torch.bool, device=cuda)
            active[res_ids[:1000]] = True
            active[ids[:n_unres]] = True
            got = bn.mesh_closest_hit(static, arrays, rays, exclude, k=1,
                                      active=active)
            assert log[-1]["finish"] == finish
            want = walked(active)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    finally:
        bn.cast_log = None
    active = torch.tensor(g.uniform(size=R) < 0.1, device=cuda)
    want = walked(active)
    for got in (bn.mesh_closest_hit(static, arrays, rays, exclude,
                                    active=active),
                bn.mesh_closest_hit_batched(static, arrays, rays, exclude,
                                            active=active, batch=1024)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tsu = torch.tensor(g.uniform(0.5, 3.0, R) * float(ext.max()),
                       dtype=torch.float32, device=cuda)
    f, i = bn.mesh_closest_hit(static, arrays, rays, exclude, tsu,
                               active=active)
    flag = (i[0] >= 0) & (f[0] <= tsu)
    assert flag.any()
    for k in (None, 1):
        assert torch.equal(bn.mesh_occluded(static, arrays, rays, exclude,
                                            tsu, k, active), flag)
    assert torch.equal(bn.mesh_occluded_batched(
        static, arrays, rays, exclude, tsu, active=active, batch=1024,
        threshold=R // 4), flag)


def test_card_eager_tracer(cuda):
    """The eager tracer (tracer/xla.py, no kernel) on the card against
    itself on the CPU and against the kernel path on the card, and its
    gradient oracle (backward="xla") against the retrace kernel's."""
    from computeraytracer_tpu_torch.tracer import xla

    doc = presets.cornell_box(32, 32)
    cpu = scene_from_dict(doc, device="cpu")[0]
    card = scene_from_dict(doc, device=cuda)[0]
    got = xla.render_sample(card, 32, 32, 1, 6)
    for want in (xla.render_sample(cpu, 32, 32, 1, 6).to(cuda),
                 kt.render_sample(card, 32, 32, 1, 6)):
        close = torch.isclose(got, want, rtol=2e-4, atol=2e-4).all(dim=-1)
        assert close.float().mean().item() >= 0.99
    grads = []
    for backward in ("xla", "pallas"):
        sp = card.spectra.clone().requires_grad_(True)
        s = dataclasses.replace(card, spectra=sp)
        (kt.render_sample(s, 32, 32, 1, 6, backward=backward) ** 2
         ).sum().backward()
        grads.append(sp.grad)
    assert torch.isfinite(grads[0]).all()
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    assert rel <= 2e-3, rel


def test_card_bvh_matches_brute(cuda):
    """The BVH traversal on the card: the brute-force scan's winners, with
    exclusion, on a mesh scene with patches and triangles."""
    from computeraytracer_tpu_torch.bvh import builder, traverse
    from computeraytracer_tpu_torch.ops import intersect as isect

    scene = scene_from_dict(presets.mesh_scene(32, 32, 3), device=cuda)[0]
    bvh = builder.scene_bvh(scene, backend="native")
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 4096
    o = torch.rand((n, 3), generator=gen, device=cuda) * 600.0 - 20.0
    d = torch.randn((n, 3), generator=gen, device=cuda)
    d = d / d.norm(dim=-1, keepdim=True)
    ex = torch.randint(-1, scene.primitives.count, (n,), generator=gen,
                       device=cuda)
    fast = traverse.intersect_bvh(o, d, ex, scene.primitives, bvh)
    brute = isect.intersect_brute(o, d, ex, scene.primitives)
    hit = brute.hit
    assert hit.float().mean().item() > 0.3
    assert torch.equal(fast.hit, hit)
    assert torch.equal(fast.index[hit], brute.index[hit])
    assert torch.allclose(fast.t[hit], brute.t[hit], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backward,counter", [
    ("pallas", "launches_bwd"), ("pallas_taped", "launches_bwd_tape")])
def test_card_screen_warp_gradient(cuda, backward, counter):
    """The screen warp (ops/warp.py) around kernel 1 and kernel 3 (the
    retrace backward) or the taped forward and kernel 4, at 64^2 depth 4:
    the image is the kernel path's stratified=False render bit for bit,
    one backward launch per sample, and the gradients by spectra and data1
    within 2e-3 (relative L2) of the same computation on the CPU (the
    plain versions); an ulp in a root can flip a rare path or auxiliary
    ray between the devices."""
    w = h = 64
    cpu_scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")

    def grads(scene):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, spectra=sp,
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        img = kt.render_sample(s, w, h, 1, 4, backward=backward,
                               vis_grads=("screen",))
        (img ** 2).sum().backward()
        return img.detach(), sp.grad, d1.grad

    card_scene = cpu_scene.to(cuda)
    before = getattr(mk, counter)
    img, *card = grads(card_scene)
    assert getattr(mk, counter) == before + 1
    assert torch.equal(img, kt.render_sample(card_scene, w, h, 1, 4,
                                             stratified=False))
    _, *host = grads(cpu_scene)
    for c, h_ in zip(card, host):
        assert c.is_cuda and torch.isfinite(c).all()
        rel = ((c.cpu() - h_).norm() / h_.norm()).item()
        assert rel <= 2e-3, rel


def test_card_sharded_world_of_one(cuda, tmp_path):
    """parallel/: a world of one on NCCL renders Cornell 64^2, spp 2,
    through kernel 1 bit-equal to kt.render_accumulate, and its sharded
    value_and_grad (make_loss_fn(mesh=...), kernels 1 and 3) by spectra
    and data1 equals the single-process one."""
    from computeraytracer_tpu_torch.parallel import distributed
    from computeraytracer_tpu_torch.parallel import mesh as mesh_mod
    from computeraytracer_tpu_torch.parallel import render_sharded as rsh
    from computeraytracer_tpu_torch.train import optimize as opt

    w = h = 64
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    target = torch.zeros((h, w, 3), device=cuda)

    def value_and_grad(mesh):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in
                  opt.split_scene(scene, ("spectra", "data1"))[0].items()}
        loss = opt.make_loss_fn(scene, w, h, 2, 8, mesh=mesh)(params,
                                                              target, 1)
        loss.backward()
        return loss.detach(), [p.grad for p in params.values()]

    assert distributed.initialize(f"file://{tmp_path}/store", 1, 0)
    try:
        mesh = mesh_mod.make_mesh()
        before = mk.launches
        got = rsh.render_accumulate_sharded(scene, w, h, 2, mesh)
        assert mk.launches == before + 2
        assert torch.equal(got, kt.render_accumulate(scene, w, h, 2))
        loss, grads = value_and_grad(mesh)
    finally:
        distributed.shutdown()
    want_loss, want = value_and_grad(None)
    assert torch.equal(loss, want_loss)
    for g, w_ in zip(grads, want):
        assert torch.isfinite(g).all() and torch.count_nonzero(w_) > 0
        assert torch.equal(g, w_)


@pytest.mark.parametrize("n_rays", [1, 31, 37, 1 << 20])
def test_card_ray_setup_kernel(cuda, n_rays):
    """The ray-setup kernel bit-equal to its plain version on the card (o,
    d, hero, seeds) at three samples, the last near 2^32, on the last rays
    of a film or one row of it; one launch each, and camera_planes goes
    through it."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w, h = (1024, 1024) if n_rays == 1 << 20 else (37, 29)
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    if n_rays == w:  # one film row: py is a stride-0 view
        px, py = kt.tile_coords(w, 1, h // 2, cuda)
        assert not py.is_contiguous()
    else:
        px, py = kt.tile_coords(w, h, 0, cuda)
        px, py = px[-n_rays:], py[-n_rays:]
    for sample in (1, 17, 2**32 - 3):
        before = setup_k.launches_ray_setup
        got = kt.camera_planes(scene, w, h, px, py, sample)
        assert setup_k.launches_ray_setup == before + 1
        want = setup_k.ray_setup_reference(scene.camera, w, h, px, py,
                                           sample)
        for name, g, w_ in zip(("o", "d", "hero", "seed"), got, want):
            assert g.shape == w_.shape and g.dtype == w_.dtype, name
            assert torch.equal(g, w_), name


@pytest.mark.parametrize("n_rays", [4099, 1 << 20])
@pytest.mark.parametrize("camera", ["cornell", "tilted", "wide"])
def test_card_ray_setup_camera_grad(cuda, camera, n_rays):
    """The ray setup's backward kernel: its twelve sums bit-equal to the
    plain version's on the card (ray_setup_bwd_sums_reference of
    ray_setup_bwd_terms) and across two launches, one launch each; its
    camera gradients within 1e-5 of each leaf's largest entry of torch
    autograd of ray_setup_reference for the same cotangents; RaySetupFn
    launches it once in a backward, and gives the kernel's gradients."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k
    from computeraytracer_tpu_torch.scene.data import CameraSpec

    w, h = (1024, 1024) if n_rays == 1 << 20 else (67, 62)
    cam = _camera_scene(camera, w, h, cuda).camera
    px, py = kt.tile_coords(w, h, 0, cuda)
    px, py = px[:n_rays], py[:n_rays]
    g = np.random.default_rng(n_rays).standard_normal((6, n_rays))
    g = torch.from_numpy(g.astype(np.float32)).to(cuda)
    g_o, g_d = g[:3], g[3:]
    names = ("eye", "lookat", "up", "fov")
    leaves = [getattr(cam, n) for n in names]
    for sample in (1, 2**32 - 3):
        before = setup_k.launches_ray_setup_bwd
        grads, sums = setup_k.ray_setup_bwd_launch(*leaves, w, h, px, py,
                                                   sample, g_o, g_d)
        again = setup_k.ray_setup_bwd_launch(*leaves, w, h, px, py, sample,
                                             g_o, g_d)
        assert setup_k.launches_ray_setup_bwd == before + 2
        plain = setup_k.ray_setup_bwd_sums_reference(
            setup_k.ray_setup_bwd_terms(cam, w, h, px, py, sample, g_o, g_d))
        assert torch.equal(sums, plain) and torch.equal(sums, again[1])
        for a, b in zip(grads, again[0]):
            assert torch.equal(a, b)
        want_leaves = [x.clone().requires_grad_(True) for x in leaves]
        o, d, _, _ = setup_k.ray_setup_reference(CameraSpec(*want_leaves),
                                                 w, h, px, py, sample)
        want = torch.autograd.grad((o * g_o).sum() + (d * g_d).sum(),
                                   want_leaves)
        for name, got, w_ in zip(names, grads, want):
            assert got.shape == w_.shape and torch.isfinite(got).all()
            err = ((got - w_).abs().max() / w_.abs().max()).item()
            assert err <= 1e-5, (name, sample, err)
        fn_leaves = [x.clone().requires_grad_(True) for x in leaves]
        o, d, _, _ = setup_k.ray_setup(CameraSpec(*fn_leaves), w, h, px, py,
                                       sample)
        before = setup_k.launches_ray_setup_bwd
        fn_grads = torch.autograd.grad((o * g_o).sum() + (d * g_d).sum(),
                                       fn_leaves)
        assert setup_k.launches_ray_setup_bwd == before + 1
        for a, b in zip(fn_grads, grads):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name,backward", [("cornell_box", "pallas"),
                                           ("cornell_box", "pallas_taped"),
                                           ("tie_mesh_scene", "pallas")])
def test_card_ray_setup_camera_grad_render(cuda, name, backward):
    """The gradient of sum(render_sample ** 2) at 64^2, depth 3, by eye,
    lookat, up, fov and data1 on the card (the ray setup's backward kernel
    behind the retrace or tape-fed kernel, or behind the guided replay of
    tie_mesh_scene's mesh part) against the same gradient on the CPU
    (plain versions): within 1e-3 of each leaf's largest entry, one
    ray-setup backward launch."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k
    from computeraytracer_tpu_torch.scene.data import CameraSpec

    w = h = 64
    cpu_scene, _ = scene_from_dict(getattr(presets, name)(w, h),
                                   device="cpu")
    static = mk.SceneStatic.from_scene(cpu_scene)
    assert bool(static.mesh_parts) == (name == "tie_mesh_scene")
    names = ("eye", "lookat", "up", "fov")

    def grads(scene):
        leaves = [getattr(scene.camera, n).clone().requires_grad_(True)
                  for n in names]
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, camera=CameraSpec(*leaves),
            primitives=dataclasses.replace(scene.primitives, data1=d1))
        img = kt.render_sample(s, w, h, 1, 3, static=static,
                               backward=backward)
        return torch.autograd.grad((img ** 2).sum(), (*leaves, d1))

    before = setup_k.launches_ray_setup_bwd
    card = grads(cpu_scene.to(cuda))
    assert setup_k.launches_ray_setup_bwd == before + 1
    host = grads(cpu_scene)
    for n, c, h_ in zip(names + ("data1",), card, host):
        c, h_ = c.cpu().numpy(), h_.numpy()
        assert np.isfinite(c).all() and np.abs(h_).max() > 0, n
        scale = np.abs(h_).max()
        np.testing.assert_allclose(c / scale, h_ / scale, rtol=0,
                                   atol=1e-3, err_msg=n)


@pytest.mark.parametrize("n_rays", [1, 2049, 1 << 20])
def test_card_hero_gather_kernels(cuda, n_rays, monkeypatch):
    """The gather kernel bit-equal to table[:, hero]; the column-sum
    kernel within rtol 1e-5 of its plain version where an entry exceeds
    1e-6 of the largest, within relative L2 1e-6 of a float64 column sum,
    and bit-equal across launches, also through HeroGatherFn; a block
    size other than the kernel's is refused."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k
    from computeraytracer_tpu_torch.ops import spectrum as spec

    g = np.random.default_rng(n_rays)
    table = torch.from_numpy(
        g.standard_normal((24, 301)).astype(np.float32)).to(cuda)
    hero_np = g.integers(0, 301, n_rays)
    hero_np[: min(n_rays, 2)] = (0, 300)[: min(n_rays, 2)]
    hero = torch.from_numpy(hero_np).to(cuda)
    cot = torch.from_numpy(
        g.standard_normal((24, n_rays)).astype(np.float32)).to(cuda)
    before = (setup_k.launches_gather, setup_k.launches_gather_bwd)
    fwd = setup_k.hero_gather(table, hero)
    assert torch.equal(fwd, table[:, hero])
    first = setup_k.hero_column_sums(cot, hero, 301)
    second = setup_k.hero_column_sums(cot, hero, 301)
    assert (setup_k.launches_gather, setup_k.launches_gather_bwd) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(first, second)
    plain = setup_k.hero_column_sums_reference(cot, hero, 301)
    big = plain.abs() > 1e-6 * plain.abs().max()
    rel = ((first - plain).abs() / plain.abs().clamp(min=1e-30))[big]
    assert rel.max().item() <= 1e-5
    exact = torch.zeros((24, 301), dtype=torch.float64, device=cuda)
    exact.index_add_(1, hero, cot.double())
    assert ((first.double() - exact).norm() / exact.norm()).item() <= 1e-6
    leaf = table.clone().requires_grad_(True)
    spec.gather_hero(leaf, hero).backward(cot)
    assert torch.equal(leaf.grad, first)
    monkeypatch.setattr(setup_k, "HERO_BLOCK", setup_k.HERO_BLOCK // 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        setup_k.hero_column_sums(cot, hero, 301)


def test_card_setup_launches_on_the_training_path(cuda):
    """A value_and_grad by spectra through render_pixels_planar, 2
    samples: one ray-setup launch, one gather (spectra and CIE in one
    launch) and one column-sum launch (the CIE table needs no gradient)
    per sample; no plain version runs, and the gradient is bit-equal
    across runs."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w = h = 64
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    px, py = kt.tile_coords(w, h, 0, cuda)

    def grad():
        sp = scene.spectra.clone().requires_grad_(True)
        s = dataclasses.replace(scene, spectra=sp)
        xyz = sum(kt.render_pixels_planar(s, w, h, px, py, k, 4)
                  for k in (1, 2))
        (xyz ** 2).mean().backward()
        return sp.grad

    before = (setup_k.launches_ray_setup, setup_k.launches_gather,
              setup_k.launches_gather_bwd)
    first = grad()
    assert (setup_k.launches_ray_setup, setup_k.launches_gather,
            setup_k.launches_gather_bwd) == (before[0] + 2, before[1] + 2,
                                             before[2] + 2)
    assert torch.isfinite(first).all() and (first != 0).any()
    assert torch.equal(first, grad())


# (eye, lookat, up, fov) besides Cornell's: a tilted up, a fov near pi/2
CAMERAS = {
    "tilted": ((1.3, 2.1, -3.7), (0.2, 0.9, 0.4), (0.3, 1.0, 0.2), 0.9),
    "wide": ((0.0, 0.5, 5.0), (0.1, -0.2, 0.0), (0.0, 1.0, 0.0), 1.5707),
}


def _camera_scene(name, w, h, device):
    """Cornell at w x h with its camera, or one of CAMERAS."""
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=device)
    if name == "cornell":
        return scene
    f32 = dict(dtype=torch.float32, device=device)
    cam = dataclasses.replace(scene.camera, **{
        k: torch.tensor(v, **f32) for k, v in zip(
            ("eye", "lookat", "up", "fov"), CAMERAS[name])})
    return dataclasses.replace(scene, camera=cam)


@pytest.mark.parametrize("n_rays", [1, 255, 1 << 20])
@pytest.mark.parametrize("camera", ["cornell", "tilted", "wide"])
def test_card_ray_setup_kernel_cameras(cuda, camera, n_rays):
    """The ray-setup kernel, which computes the camera frame itself from
    the camera's tensors, bit-equal to its plain version on the card (its
    frame in torch) at three cameras and samples 1 and 2^32 - 3; one
    launch each."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w, h = (1024, 1024) if n_rays == 1 << 20 else (37, 29)
    scene = _camera_scene(camera, w, h, cuda)
    px, py = kt.tile_coords(w, h, 0, cuda)
    px, py = px[-n_rays:], py[-n_rays:]
    for sample in (1, 2**32 - 3):
        before = setup_k.launches_ray_setup
        got = setup_k.ray_setup(scene.camera, w, h, px, py, sample)
        assert setup_k.launches_ray_setup == before + 1
        want = setup_k.ray_setup_reference(scene.camera, w, h, px, py,
                                           sample)
        for name, g, w_ in zip(("o", "d", "hero", "seed"), got, want):
            assert g.shape == w_.shape and g.dtype == w_.dtype, name
            assert torch.equal(g, w_), (name, sample)


def test_card_ray_setup_checks_camera_operands(cuda):
    """ray_setup_launch reads the camera's tensors as they are: a
    non-contiguous, float64, misshapen or host camera tensor raises, and
    nothing launches."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    cam = _camera_scene("tilted", 16, 16, cuda).camera
    px, py = kt.tile_coords(16, 16, 0, cuda)
    args = [cam.eye, cam.lookat, cam.up, cam.fov]
    bad = [
        (0, torch.zeros(6, device=cuda)[::2], "contiguous"),
        (1, cam.lookat.double(), "float"),
        (2, cam.up.reshape(1, 3), "expected"),
        (3, cam.fov.reshape(1), "expected"),
        (0, cam.eye.cpu(), "is on"),
    ]
    before = setup_k.launches_ray_setup
    for k, t, match in bad:
        wrong = list(args)
        wrong[k] = t
        with pytest.raises(ValueError, match=match):
            setup_k.ray_setup_launch(*wrong, 16, 16, px, py, 1)
    assert setup_k.launches_ray_setup == before
    setup_k.ray_setup_launch(*args, 16, 16, px, py, 1)
    assert setup_k.launches_ray_setup == before + 1


@pytest.mark.parametrize("n_rays", [1, 2047, 2049, 1 << 20])
@pytest.mark.parametrize("rows", [1, 24])
def test_card_column_sums_bit_equal(cuda, rows, n_rays):
    """The column-sum kernel bit-equal to its plain version and across two
    launches, heroes outside the table skipped, within relative L2 1e-6
    of a float64 column sum; R not a multiple of 4 takes the kernel's
    scalar loads."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    g = np.random.default_rng(rows * 7 + n_rays)
    hero_np = g.integers(0, 301, n_rays)
    hero_np[: min(n_rays, 2)] = (0, 300)[: min(n_rays, 2)]
    if n_rays > 40:
        hero_np[3:40:9] = (-1, 301, 10**6, -(10**6), 512)
    hero = torch.from_numpy(hero_np).to(cuda)
    cot = torch.from_numpy((g.standard_normal((rows, n_rays))
                            * 10.0 ** g.uniform(-3, 3, (rows, n_rays)))
                           .astype(np.float32)).to(cuda)
    before = setup_k.launches_gather_bwd
    first = setup_k.hero_column_sums(cot, hero, 301)
    second = setup_k.hero_column_sums(cot, hero, 301)
    assert setup_k.launches_gather_bwd == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first, setup_k.hero_column_sums_reference(cot, hero,
                                                                 301))
    keep = (hero >= 0) & (hero < 301)
    exact = torch.zeros((rows, 301), dtype=torch.float64, device=cuda)
    exact.index_add_(1, hero[keep], cot[:, keep].double())
    assert ((first.double() - exact).norm()
            / exact.norm()).item() <= 1e-6


def test_card_gather_tables_one_launch(cuda):
    """The spectra and CIE planes in one gather launch, each bit-equal to
    table[:, hero]; through HeroGatherFn under grad the CIE plane needs no
    gradient and the backward launches one column sum, the one-table
    gather's bit for bit."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k
    from computeraytracer_tpu_torch.ops import spectrum as spec

    scene, _ = scene_from_dict(presets.cornell_box(64, 64), device=cuda)
    spect_t = spec.expand_hero_table(scene.spectra).contiguous()
    cie_t = spec.cie_window_exp(scene.cie).contiguous()
    hero = torch.randint(0, 301, (4097,), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    before = setup_k.launches_gather
    a, b = setup_k.hero_gather_tables((spect_t, cie_t), hero)
    assert setup_k.launches_gather == before + 1
    assert torch.equal(a, spect_t[:, hero]) and torch.equal(b, cie_t[:, hero])
    leaf = spect_t.clone().requires_grad_(True)
    cot = torch.randn(a.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(1))
    before = (setup_k.launches_gather, setup_k.launches_gather_bwd)
    pa, pb = spec.gather_hero_tables((leaf, cie_t), hero)
    assert not pb.requires_grad
    (pa * cot).sum().backward()
    assert (setup_k.launches_gather, setup_k.launches_gather_bwd) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(leaf.grad, setup_k.hero_column_sums(cot, hero, 301))


def test_card_render_builds_setup_once(cuda):
    """render_accumulate and render_mean_xyz with the setup operands built
    once: one ray setup and one gather a sample; the image bit-equal to
    the per-sample path's; the gradients by spectra and data1 bit-equal
    across runs and within relative L2 1e-6 of the per-sample path's."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k
    from computeraytracer_tpu_torch.train import optimize as opt

    w = h = 64
    spp = 3
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    before = (setup_k.launches_ray_setup, setup_k.launches_gather,
              setup_k.launches_gather_bwd)
    img = kt.render_accumulate(scene, w, h, spp, 4)
    assert (setup_k.launches_ray_setup, setup_k.launches_gather,
            setup_k.launches_gather_bwd) == (before[0] + spp,
                                             before[1] + spp, before[2])
    per_sample = sum(kt.render_sample(scene, w, h, s, 4)
                     for s in range(1, spp + 1))
    assert torch.equal(img, per_sample)

    def grads(bundled):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(scene, spectra=sp, primitives=(
            dataclasses.replace(scene.primitives, data1=d1)))
        if bundled:
            out = opt.render_mean_xyz(s, w, h, spp, 4)
        else:
            out = sum(kt.render_sample(s, w, h, k, 4)
                      for k in range(1, spp + 1)) / float(spp)
        (out ** 2).mean().backward()
        return sp.grad, d1.grad

    first, again, want = grads(True), grads(True), grads(False)
    for g, g2, w_ in zip(first, again, want):
        assert torch.isfinite(g).all() and (g != 0).any()
        assert torch.equal(g, g2)
        assert ((g - w_).norm() / w_.norm()).item() <= 1e-6


def test_card_film_coordinates_match_the_cpu(cuda):
    """ops/camera.py _film_st on the card: the film coordinates of a
    37 x 29 film, divided by 0-dim tensors, equal the CPU's (and so the
    JAX package's) bit for bit."""
    from computeraytracer_tpu_torch.ops import camera as cam_ops

    px, py = kt.tile_coords(37, 29, 0)
    gen = torch.Generator().manual_seed(0)
    js, jt = (torch.rand(px.shape, generator=gen) for _ in range(2))
    want = cam_ops._film_st(37, 29, px, py, js, jt)
    got = cam_ops._film_st(37, 29, *(x.to(cuda) for x in (px, py, js, jt)))
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.fixture
def frame_graphs(monkeypatch):
    """render_accumulate's frame graphs emptied for the test, and its
    counters as they were when it started."""
    import collections

    monkeypatch.setattr(kt, "_frame_graphs", collections.OrderedDict())
    return (kt.graph_captures, kt.graph_replays, kt.graph_eager)


def _eager_frame(scene, w, h, spp, depth, first, backward="pallas"):
    """render_accumulate's body run eagerly (its first call of a key)."""
    accum = kt.accumulate_pixels(scene, w, h, None, None, first, spp, depth,
                                 1, backward=backward)[1]
    return kt._film(accum, w, h)


def _composed_frame(scene, w, h, spp, depth, first):
    """The frame as the sum of ``render_sample_planar``'s XYZ images in
    sample order: the forward, the CIE sum in torch, the accumulation; what
    the frame's in-place samples (the forward's XYZ build) replace."""
    static = mk.SceneStatic.from_scene(scene)
    setup = kt.setup_operands(scene, static, "pallas",
                              *kt.tile_coords(w, h, 0, scene.device))
    accum = torch.zeros((3, h, w), dtype=torch.float32, device=scene.device)
    for s in range(first, first + spp):
        accum = accum + kt.render_sample_planar(scene, w, h, s, depth, 1,
                                                static, setup=setup)
    return accum.permute(1, 2, 0).contiguous()


def _xyz_doc(kind, w, h):
    if kind == "rtnw":
        return _rtnw_doc()
    if kind == "triangle_rows":
        return presets.mesh_scene(w, h, 1)
    return presets.cornell_box(w, h)


@pytest.mark.parametrize("kind,film,spp,depth", [
    ("cornell_box", (1024, 1024), 4, 8), ("cornell_box", (37, 29), 3, 8),
    ("triangle_rows", (64, 48), 2, 3), ("rtnw", (64, 64), 2, 8)])
def test_card_xyz_frame_is_the_composition(cuda, frame_graphs, kind, film,
                                           spp, depth):
    """Four render_accumulate calls of one key (eager, captured and
    replayed, replayed twice), first_sample advancing by spp: each frame,
    whose samples the forward's XYZ build adds in place (the shared build;
    the global-table build on rtnw-final's 3,407 rows), is the composition
    of the radiance plane, the CIE sum and the accumulation, bit for bit;
    each counts spp XYZ launches."""
    w, h = film
    scene, _ = scene_from_dict(_xyz_doc(kind, w, h), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert not static.mesh_parts
    assert (len(static.rows) > mk.MAX_PRIMS) == (kind == "rtnw")
    for k in range(4):
        first = 1 + spp * k
        before = mk.launches_xyz
        got = kt.render_accumulate(scene, w, h, spp, depth,
                                   first_sample=first)
        assert mk.launches_xyz == before + spp, k
        want = _composed_frame(scene, w, h, spp, depth, first)
        assert float(want.sum()) > 0
        assert torch.equal(got, want), k
    assert kt.graph_captures == frame_graphs[0] + 1
    assert kt.graph_replays == frame_graphs[1] + 3


@pytest.mark.parametrize("kind,n_rays,max_depth,wide", [
    ("cornell_box", 1, 8, False), ("cornell_box", 33, 8, False),
    ("cornell_box", 1000, 8, False), ("cornell_box", None, 0, False),
    ("cornell_box", None, 8, False), ("looking_away", None, 8, False),
    ("triangle_rows", None, 3, False), ("cornell_box", 33, 8, True),
    ("cornell_box", None, 8, True), ("triangle_rows", None, 3, True)])
def test_card_forward_xyz_is_forward_then_model(cuda, kind, n_rays,
                                                max_depth, wide,
                                                monkeypatch):
    """The forward's XYZ build, shared or global-table (MAX_PRIMS 0
    forces it), into an accumulator that holds a sample already: the plain
    epilogue model (xyz_accumulate_reference) applied to the forward's
    radiance, bit for bit, at ragged ray counts; one launch, counted in
    launches_xyz and in the forward's own counter."""
    from computeraytracer_tpu_torch.ops import spectrum as spec

    side = 64
    doc = (presets.mesh_scene(side, side, 1) if kind == "triangle_rows"
           else presets.cornell_box(side, side))
    if kind == "looking_away":
        doc["camera"]["lookat"] = [278, 273, -1600]
    scene, _ = scene_from_dict(doc, device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(side, side, 0, cuda)
    if n_rays is not None:
        px, py = px[:n_rays], py[:n_rays]
    setup = kt.setup_operands(scene, static)
    o, d, hero, seed = kt.camera_planes(scene, side, side, px, py, 5)
    spect, cie = spec.gather_hero_tables(
        (setup.spect_table, setup.cie_table), hero)
    R = px.shape[0]
    start = torch.rand((3, R), generator=torch.Generator().manual_seed(R))
    if wide:
        monkeypatch.setattr(mk, "MAX_PRIMS", 0)
    want = start.to(cuda)
    mk.xyz_accumulate_reference(cie, mk.forward(
        static, max_depth, 1, setup.prims, torch.cat([o, d]), seed, spect),
        want)
    got = start.to(cuda)
    counts = lambda: (mk.launches, mk.launches_wide, mk.launches_xyz)
    before = counts()
    mk.forward_xyz(static, max_depth, 1, setup.prims, o, d, seed, spect, cie,
                   got, mk._ray_counter(cuda))
    torch.cuda.synchronize()
    assert counts() == (before[0] + (not wide), before[1] + wide,
                        before[2] + 1)
    assert torch.equal(got, want)
    if kind == "looking_away":
        assert torch.equal(got, start.to(cuda))


def test_card_fit_step_launches_no_xyz_build(cuda):
    """A fit step (make_train_step, spectra and data1 trained) runs the
    radiance forward and its autograd, and no XYZ build."""
    from computeraytracer_tpu_torch.train import optimize

    w = h = 32
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    params0, static = optimize.split_scene(scene, ("spectra", "data1"))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    adam = torch.optim.Adam(list(params.values()), lr=1e-5)
    step = optimize.make_train_step(static, adam, w, h, 2, 4)
    target = torch.full((h, w, 3), 0.1, device=cuda)
    before = (mk.launches, mk.launches_bwd, mk.launches_xyz)
    loss = step(params, target, 1)
    torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    assert (mk.launches, mk.launches_bwd, mk.launches_xyz) == (
        before[0] + 2, before[1] + 2, before[2])


@pytest.mark.parametrize("film,spp", [((1024, 1024), 4), ((37, 29), 3)])
def test_card_frame_graph_bit_equal_to_eager(cuda, frame_graphs, film,
                                             spp):
    """Six render_accumulate calls of one key, first_sample advancing by
    spp (the first eager, the second captured and replayed, then
    replays): each accum equal to the eager frame's, the kept frames in
    storages of their own and unchanged by the later replays."""
    w, h = film
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    kept = [kt.render_accumulate(scene, w, h, spp, 8, first_sample=1 + spp * k)
            for k in range(6)]
    assert kt.graph_captures == frame_graphs[0] + 1
    ptrs = {f.untyped_storage().data_ptr() for f in kept}
    assert len(ptrs) == len(kept)
    for k, got in enumerate(kept):
        want = _eager_frame(scene, w, h, spp, 8, 1 + spp * k)
        assert got.shape == (h, w, 3) and torch.equal(got, want), k


@pytest.mark.parametrize("backward", ["pallas_taped", "none"])
def test_card_frame_graph_other_backwards(cuda, frame_graphs, backward):
    """The frame graph of the other kernel-forward backwards, at a first
    sample whose samples pass 2^32 (the seed's word wraps), equals the
    eager frame."""
    w, h, spp = 40, 24, 3
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    for first in (1, 2**32 - 1, 9):
        got = kt.render_accumulate(scene, w, h, spp, 6, first_sample=first,
                                   backward=backward)
        want = _eager_frame(scene, w, h, spp, 6, first, backward)
        assert torch.equal(got, want), first
    assert kt.graph_captures == frame_graphs[0] + 1


def test_card_frame_graph_sees_in_place_edits(cuda, frame_graphs):
    """An in-place edit of the spectra and a vertex between two replays
    shows in the next frame, bit-equal to the eager frame of the edited
    scene; no new capture."""
    w, h, spp = 48, 32, 2
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    for k in range(3):
        kt.render_accumulate(scene, w, h, spp, 8, first_sample=1 + spp * k)
    before = kt.render_accumulate(scene, w, h, spp, 8, first_sample=7)
    scene.spectra.mul_(0.75)
    scene.primitives.data1[-1].add_(5.0)
    got = kt.render_accumulate(scene, w, h, spp, 8, first_sample=7)
    want = _eager_frame(scene, w, h, spp, 8, 7)
    assert torch.equal(got, want) and not torch.equal(got, before)
    assert torch.equal(got, _composed_frame(scene, w, h, spp, 8, 7))
    assert kt.graph_captures == frame_graphs[0] + 1


def test_card_frame_graph_counters(cuda, frame_graphs):
    """N calls of one key: one eager frame, one capture, N - 1 replays
    (the capturing call replays too); every frame counts the launches of
    the eager frame (spp forwards, each the XYZ build, ray setups and
    gathers), the capture's own launches counted nowhere; a new spp is a
    new key, eager."""
    w, h, spp, n = 32, 32, 3, 5
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    per_call = []
    for k in range(n):
        before = kt._launch_counts()
        kt.render_accumulate(scene, w, h, spp, 8, first_sample=1 + spp * k)
        after = kt._launch_counts()
        per_call.append({key: after[key] - v for key, v in before.items()
                         if after[key] != v})
    captures, replays, eager = frame_graphs
    assert (kt.graph_captures, kt.graph_replays, kt.graph_eager) == (
        captures + 1, replays + n - 1, eager + 1)
    names = {k[1]: v for k, v in per_call[0].items()}
    assert names == {"launches": spp, "launches_xyz": spp,
                     "launches_ray_setup": spp, "launches_gather": spp}
    assert all(c == per_call[0] for c in per_call)
    kt.render_accumulate(scene, w, h, spp + 1, 8)
    assert kt.graph_eager == eager + 2


def test_card_frame_graph_needs_no_grad_leaf(cuda, frame_graphs):
    """A scene leaf that requires grad keeps every frame eager under grad
    mode, and differentiable; under no_grad the frame is graphed."""
    w, h = 16, 16
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    sp = scene.spectra.clone().requires_grad_(True)
    wanting = dataclasses.replace(scene, spectra=sp)
    for k in range(3):
        out = kt.render_accumulate(wanting, w, h, 1, 4, first_sample=1 + k)
        assert out.requires_grad
    assert kt.graph_captures == frame_graphs[0]
    with torch.no_grad():
        for k in range(3):
            kt.render_accumulate(wanting, w, h, 1, 4, first_sample=1 + k)
    assert kt.graph_captures == frame_graphs[0] + 1


def test_card_frame_graph_keeps_mesh_scenes_eager(cuda, frame_graphs):
    """Three calls of one key on a scene with mesh parts: every frame
    eager (the mesh paths read ray counts back to the host), no entry
    kept, nothing captured, each frame the eager frame."""
    w, h, spp = 24, 16, 2
    scene, _ = scene_from_dict(presets.tie_mesh_scene(w, h, "edges"),
                               device=cuda)
    for k in range(3):
        got = kt.render_accumulate(scene, w, h, spp, 4,
                                   first_sample=1 + spp * k)
        assert torch.equal(got, _eager_frame(scene, w, h, spp, 4,
                                             1 + spp * k)), k
    captures, replays, eager = frame_graphs
    assert (kt.graph_captures, kt.graph_replays, kt.graph_eager) == (
        captures, replays, eager + 3)
    assert not kt._frame_graphs


def finish_case(width: int, height: int, seed: int) -> torch.Tensor:
    """A planar (3, width * height) XYZ sum whose means cross both of the
    gamma's branches and the clamps: magnitudes over seven decades, either
    sign, and zeros."""
    gen = torch.Generator().manual_seed(seed)
    R = width * height
    xyz = (torch.randn((3, R), generator=gen)
           * torch.exp(torch.rand((3, R), generator=gen) * 16.0 - 10.0))
    xyz[:, ::17] = 0.0
    return xyz


@pytest.mark.parametrize("total", [3, 4, 7])
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_card_finish_frame_is_its_plain_version(cuda, layout, total):
    """The finish kernel on a planar (3, R) or an interleaved (H, W, 3) sum
    at a ragged film: accum, mean and sRGB bit-equal to the plain version
    run on the card (the division by a 0-dim CUDA tensor), the mean to the
    CPU's accum / float(total); one launch, each output a new contiguous
    tensor (accum the sum itself where it is interleaved)."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w, h = 257, 129
    xyz = finish_case(w, h, total)
    film = xyz.view(3, h, w).permute(1, 2, 0).contiguous()
    src = (xyz if layout == "planar" else film).to(cuda)
    before = setup_k.launches_finish
    got = setup_k.finish_frame(src, total, w, h)
    torch.cuda.synchronize()
    assert setup_k.launches_finish == before + 1
    want = setup_k.finish_frame_reference(src, total, w, h)
    for name, g, x in zip(("accum", "mean", "srgb"), got, want):
        assert g.shape == (h, w, 3) and g.is_contiguous(), name
        assert torch.equal(g, x), name
    assert torch.equal(got[0].cpu(), film)
    assert torch.equal(got[1].cpu(), film / float(total))
    assert (got[0] is src) == (layout == "interleaved")
    ptrs = {t.untyped_storage().data_ptr() for t in (src, *got)}
    assert len(ptrs) == 4 - (layout == "interleaved")
    srgb = got[2]
    assert 0 < float((srgb == 0).float().mean()) < 1
    assert bool(((srgb > 0) & (srgb < 0.04)).any())


def _storage_range(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


@pytest.mark.parametrize("kernel,chunk", [("pallas", None),
                                          ("pallas", 700), ("xla", None)])
def test_card_render_finishes_in_one_launch(cuda, frame_graphs, kernel,
                                            chunk):
    """Four renders of one key on the card (for the kernel path's whole
    film: eager, captured and replayed, replayed twice; banded and eager
    tracer renders never graphed): one finish launch each; accum the
    eager frame's, mean and sRGB its plain version's bit for bit; every
    image a tensor of its own, apart from the frame graph's buffer and
    every other call's, unchanged by the later calls."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w, h, spp = 40, 24, 2
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=6,
                       kernel=kernel, ray_chunk=chunk)
    outs = []
    for k in range(4):
        before = setup_k.launches_finish
        outs.append(api.render(scene, cfg, first_sample=1 + spp * k))
        assert setup_k.launches_finish == before + 1, k
    graphed = kernel == "pallas" and chunk is None
    assert kt.graph_captures == frame_graphs[0] + graphed
    assert kt.graph_replays == frame_graphs[1] + 3 * graphed
    ranges = [_storage_range(o[name]) for o in outs
              for name in ("accum_xyz", "mean_xyz", "srgb")]
    ranges += [_storage_range(e.out) for e in kt._frame_graphs.values()
               if e.out is not None]
    assert len(ranges) == 12 + graphed
    ranges.sort()
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    for k, out in enumerate(outs):
        total = spp * (k + 1)
        assert out["samples"] == total
        if kernel == "pallas":
            want = _eager_frame(scene, w, h, spp, 6, 1 + spp * k)
        else:
            want = api.render_accumulate(scene, w, h, spp, 6, 1,
                                         1 + spp * k, kernel="xla")
        assert torch.equal(out["accum_xyz"], want), k
        _, mean, srgb = setup_k.finish_frame_reference(want, total, w, h)
        assert torch.equal(out["mean_xyz"], mean), k
        assert torch.equal(out["srgb"], srgb), k


def test_card_render_under_grad_finishes_in_one_launch(cuda, frame_graphs):
    """A render of a scene whose spectra require grad, under grad mode:
    its sum requires grad, and the finish is still one launch of the
    kernel, its mean and sRGB the plain version's and differentiable; the
    gradient that the finish passes back to the sum is the plain
    version's bit for bit."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w = h = 16
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device=cuda)
    sp = scene.spectra.clone().requires_grad_(True)
    wanting = dataclasses.replace(scene, spectra=sp)
    before = setup_k.launches_finish
    out = api.render(wanting, RenderConfig(width=w, height=h, spp=1,
                                           max_depth=3))
    assert setup_k.launches_finish == before + 1
    assert out["mean_xyz"].requires_grad and out["srgb"].requires_grad
    _, mean, srgb = setup_k.finish_frame_reference(out["accum_xyz"], 1, w, h)
    assert torch.equal(out["mean_xyz"], mean)
    assert torch.equal(out["srgb"], srgb)
    out["srgb"].sum().backward()
    assert torch.isfinite(sp.grad).all() and bool((sp.grad != 0).any())
    xyz = kt.accumulate_frame(wanting, w, h, 1, 3)
    assert xyz.requires_grad and xyz.dim() == 2
    gen = torch.Generator().manual_seed(5)
    gs = [torch.randn((h, w, 3), generator=gen).to(cuda) for _ in range(3)]
    got = setup_k.finish_frame(xyz, 3, w, h)
    assert setup_k.launches_finish == before + 2
    want = setup_k.finish_frame_reference(xyz, 3, w, h)
    g_got, = torch.autograd.grad(got, xyz, gs)
    g_want, = torch.autograd.grad(want, xyz, gs)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("spp,first", [(3, 1), (3, 2), (3, 5)])
def test_card_render_mean_is_the_cpu_division(cuda, frame_graphs, spp,
                                              first):
    """Fault 3a, the mean's division: the card's render at spp 3 (sample
    counts 3, 4 and 7) gives the mean that the CPU's accum / float(total)
    gives for the card's sum, bit for bit, replayed or not; where the
    card's and the CPU's renders sum a pixel alike, their means agree bit
    for bit."""
    w, h = 48, 32
    cpu_scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")
    scene = cpu_scene.to(cuda)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=6,
                       first_sample=first)
    total = first + spp - 1
    for _ in range(3):
        card = {k: v.cpu() for k, v in api.render(scene, cfg).items()
                if k != "samples"}
        assert torch.equal(card["mean_xyz"], card["accum_xyz"] / float(total))
    assert kt.graph_replays == frame_graphs[1] + 2
    host = api.render(cpu_scene, cfg)
    same = (card["accum_xyz"] == host["accum_xyz"]).all(dim=-1)
    assert float(same.float().mean()) > 0.9
    assert torch.equal(card["mean_xyz"][same], host["mean_xyz"][same])


@pytest.mark.parametrize("base,sample", [(0, 1), (1, 0), (12, 3),
                                         (2**32 - 3, 2), (2**32 + 5, 1)])
def test_card_ray_setup_device_base(cuda, base, sample):
    """The ray-setup kernel with a device base b and sample k equals the
    kernel at the scalar sample b + k and its plain version, bit for bit;
    one launch each."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    w, h = 37, 29
    scene = _camera_scene("tilted", w, h, cuda)
    px, py = kt.tile_coords(w, h, 0, cuda)
    b = torch.tensor(base, dtype=torch.int64, device=cuda)
    n = setup_k.launches_ray_setup
    got = setup_k.ray_setup(scene.camera, w, h, px, py, sample, b)
    assert setup_k.launches_ray_setup == n + 1
    want = setup_k.ray_setup(scene.camera, w, h, px, py, base + sample)
    plain = setup_k.ray_setup_reference(scene.camera, w, h, px, py,
                                        (base + sample) & 0xFFFFFFFF)
    for g, w_, p in zip(got, want, plain):
        assert torch.equal(g, w_) and torch.equal(g, p)


# ---------------------------------------------------------------------------
# the forward's global-table build: scenes of more than MAX_PRIMS rows
# ---------------------------------------------------------------------------


def _rtnw_doc():
    """The benchmark's configuration rtnw-final: the final scene of Ray
    Tracing: The Next Week, 3,407 rows, 800 x 800."""
    import json
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "bench_h100"
            / "configs" / "rtnw-final.json")
    return json.loads(path.read_text())["scene"]


@pytest.mark.parametrize("kind,n_rays,max_depth", [
    ("cornell_box", 1, 8), ("cornell_box", 33, 8), ("cornell_box", 1000, 8),
    ("cornell_box", None, 8), ("cornell_box", None, 0),
    ("looking_away", None, 8), ("triangle_rows", None, 3)])
def test_wide_build_is_the_shared_build(cuda, kind, n_rays, max_depth,
                                       monkeypatch):
    """The global-table build forced (MAX_PRIMS 0) on scenes the shared
    tables hold (Cornell, Cornell looking away, triangle rows) gives the
    shared-table build's radiance bit for bit, at ragged ray counts; it
    counts in launches_wide alone."""
    static, args = _refill_case(cuda, kind, n_rays=n_rays)
    want = mk.forward(static, max_depth, 1, *args)
    monkeypatch.setattr(mk, "MAX_PRIMS", 0)
    before = (mk.launches, mk.launches_mesh, mk.launches_wide)
    got = mk.forward(static, max_depth, 1, *args)
    torch.cuda.synchronize()
    assert (mk.launches, mk.launches_mesh, mk.launches_wide) == (
        before[0], before[1], before[2] + 1)
    assert torch.equal(got, want)


def test_wide_build_on_rtnw_is_its_plain_version(cuda):
    """rtnw-final at 800^2, depth 40, every 10th pixel of the film: the
    global-table build (chosen by the row count) against the plain version
    (its blocked scan) on the same CUDA tensors, bit for bit, and two
    launches bit-equal."""
    scene, _ = scene_from_dict(_rtnw_doc(), device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert len(static.rows) == 3407 and not static.mesh_parts
    px, py = kt.tile_coords(800, 800, 0, cuda)
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, 800, 800, px[::10], py[::10], 3), static)
    before = mk.launches_wide
    got = mk.forward(static, 40, 1, *args)
    again = mk.forward(static, 40, 1, *args)
    torch.cuda.synchronize()
    assert mk.launches_wide == before + 2
    want = mk.forward_reference(static, 40, 1, *args)
    assert float(want.sum()) > 0
    assert torch.equal(got, want) and torch.equal(again, got)


def test_wide_frame_graph_bit_equal_to_eager(cuda, frame_graphs):
    """rtnw-final at 800^2, spp 2: render_accumulate's replayed frame graph
    equals the eager frame; every call counts spp global-table launches,
    replays included, and no shared-table forward."""
    scene, _ = scene_from_dict(_rtnw_doc(), device=cuda)
    spp = 2
    for k in range(4):
        before = (mk.launches, mk.launches_wide)
        got = kt.render_accumulate(scene, 800, 800, spp, 40,
                                   first_sample=1 + spp * k)
        assert (mk.launches, mk.launches_wide) == (before[0],
                                                   before[1] + spp), k
        if k in (0, 3):
            want = _eager_frame(scene, 800, 800, spp, 40, 1 + spp * k)
            assert torch.equal(got, want), k
    assert kt.graph_captures == frame_graphs[0] + 1
    assert kt.graph_replays == frame_graphs[1] + 3


def test_wide_scene_fit_refuses(cuda):
    """A gradient through the kernel path of a scene past the shared
    tables raises before any launch, naming the build and its limit."""
    scene, _ = scene_from_dict(_rtnw_doc(), device=cuda)
    scene.spectra.requires_grad_(True)
    with pytest.raises(ValueError, match="retrace backward holds at most"):
        kt.render_sample(scene, 16, 16, 1, 4)


# ---------------------------------------------------------------------------
# the forward's global-table mesh build: mesh parts past MAX_PRIMS rows
# ---------------------------------------------------------------------------


def _rtnw_generator():
    """scripts/make_rtnw_final.py, for its final_scene at small counts."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "make_rtnw_final.py")
    spec = importlib.util.spec_from_file_location("make_rtnw_final", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rtnw_mesh_doc():
    """The benchmark's configuration rtnw-final-mesh: rtnw-final with its
    ground as one mesh of 4,800 triangles beside 1,007 rows, 800 x 800."""
    import json
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "bench_h100"
            / "configs" / "rtnw-final-mesh.json")
    return json.loads(path.read_text())["scene"]


def _wide_mesh_case(cuda, doc, side, sample, stride=1, n_rays=None):
    """(scene, static, kernel operands, mesh arrays) of a wide mesh scene
    at side x side, every stride-th pixel (the first n_rays of them)."""
    scene, _ = scene_from_dict(doc, device=cuda)
    static = mk.SceneStatic.from_scene(scene)
    assert len(static.rows) > mk.MAX_PRIMS and static.mesh_parts
    px, py = kt.tile_coords(side, side, 0, cuda)
    px, py = px[::stride][:n_rays], py[::stride][:n_rays]
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px, py, sample), static)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    return scene, static, args, arrays


def _forward_counts():
    return {k: getattr(mk, k) for k in (
        "launches", "launches_mesh", "launches_wide", "launches_wide_mesh",
        "launches_xyz", "launches_winners")}


def _counted(before, **added):
    return {k: v + added.get(k, 0) for k, v in before.items()}


@pytest.mark.parametrize("n_rays,max_depth", [
    (1, 8), (33, 8), (1000, 8), (None, 8), (None, 0), (None, 40)])
def test_wide_mesh_build_is_its_plain_version(cuda, n_rays, max_depth):
    """The global-table mesh build (megakernel_fwd_wide_mesh: 307 rows and
    a mesh part of 432 triangles, the small final scene with its ground as
    a mesh) on every ray of a 64 x 64 film, at ragged ray counts and depths
    0 to 40, against forward_reference on the same CUDA tensors, bit for
    bit; two launches bit-equal, each counted in launches_wide_mesh alone."""
    doc = _rtnw_generator().final_scene(boxes_per_side=6, n_spheres=300,
                                        width=64, height=64,
                                        ground_mesh=True)
    _, static, args, arrays = _wide_mesh_case(cuda, doc, 64, 3,
                                              n_rays=n_rays)
    before = _forward_counts()
    got = mk.forward(static, max_depth, 1, *args, *arrays)
    again = mk.forward(static, max_depth, 1, *args, *arrays)
    torch.cuda.synchronize()
    assert _forward_counts() == _counted(before, launches_wide_mesh=2)
    want = mk.forward_reference(static, max_depth, 1, *args, *arrays)
    # a few rays may all miss or die dark; a film's worth may not
    assert n_rays in (1, 33) or float(want.sum()) > 0
    assert torch.equal(got, want) and torch.equal(again, got)


def test_wide_mesh_build_on_rtnw_mesh_is_its_plain_version(cuda):
    """rtnw-final-mesh at 800^2, depth 40, every 10th pixel of the film:
    the global-table mesh build against the plain version (the blocked
    scan of 1,007 rows, then the 4,800-triangle part) on the same CUDA
    tensors, bit for bit, and two launches bit-equal."""
    _, static, args, arrays = _wide_mesh_case(cuda, _rtnw_mesh_doc(), 800, 3,
                                              stride=10)
    assert len(static.rows) == 1007 and static.mesh_parts[0].count == 4800
    before = _forward_counts()
    got = mk.forward(static, 40, 1, *args, *arrays)
    again = mk.forward(static, 40, 1, *args, *arrays)
    torch.cuda.synchronize()
    assert _forward_counts() == _counted(before, launches_wide_mesh=2)
    want = mk.forward_reference(static, 40, 1, *args, *arrays)
    assert float(want.sum()) > 0
    assert torch.equal(got, want) and torch.equal(again, got)


def test_wide_mesh_render_serves_on_the_mesh_route(cuda, frame_graphs):
    """api.render(kernel="pallas") of the small wide mesh scene on the card:
    spp launches of the global-table mesh build and no other forward, no
    frame graph, one finish a frame; its sum is the CPU render's on at
    least 90% of pixels (the two sum a pixel alike where their paths do)."""
    from computeraytracer_tpu_torch.kernels import setup as setup_k

    doc = _rtnw_generator().final_scene(boxes_per_side=6, n_spheres=300,
                                        width=48, height=32,
                                        ground_mesh=True)
    cpu_scene, _ = scene_from_dict(doc, device="cpu")
    scene = cpu_scene.to(cuda)
    cfg = RenderConfig(width=48, height=32, spp=3, max_depth=8,
                       kernel="pallas", first_sample=4)
    for _ in range(2):
        before = _forward_counts()
        finishes = setup_k.launches_finish
        card = {k: v.cpu() for k, v in api.render(scene, cfg).items()
                if k != "samples"}
        assert _forward_counts() == _counted(before, launches_wide_mesh=3)
        assert setup_k.launches_finish == finishes + 1
    assert kt.graph_captures == frame_graphs[0]
    assert kt.graph_replays == frame_graphs[1]
    assert torch.isfinite(card["accum_xyz"]).all()
    host = api.render(cpu_scene, cfg)
    same = (card["accum_xyz"] == host["accum_xyz"]).all(dim=-1)
    assert float(same.float().mean()) > 0.9


def test_wide_build_without_parts_keeps_its_xyz_build(cuda):
    """rtnw-final (no mesh part) still serves each sample through the
    global-table XYZ build (refill_fwd_wide_xyz), never the mesh build."""
    scene, _ = scene_from_dict(_rtnw_doc(), device=cuda)
    before = _forward_counts()
    out = api.render(scene, RenderConfig(width=64, height=64, spp=2,
                                         max_depth=8, kernel="pallas"))
    torch.cuda.synchronize()
    assert _forward_counts() == _counted(before, launches_wide=2,
                                         launches_xyz=2)
    assert torch.isfinite(out["accum_xyz"]).all()
