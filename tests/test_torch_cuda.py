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
counting build against the tape's trips; the warp-drained candidate
kernel over several groups of supernodes, coherent and incoherent warps
and boxes with equal entry distances, its counted chunk-loop trips equal
to its plain model's, and the pair kernels on unsorted pairs of tie
chunks with dead pairs among them.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so it runs on a card machine without the JAX package's
dependencies; the repo's conftest imports jax, so run it there with

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import dataclasses

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
