"""The per-sample setup of the port's kernel path vs the JAX package's.

``kernels.setup.ray_setup`` (its plain version, which the wrapper runs
for pixels on the CPU, and ``tracer.kernel.camera_planes`` through it)
against the JAX composition ``rng.seed_pixel_p`` ->
``camera.camera_rays_p`` -> ``spectrum.sample_wavelengths_p``
(tracer/pallas.py:708-712): bit for bit on o, d, hero and the seeds.

The same at two more cameras (a tilted ``up``, a fov near pi/2), whose
frames the ray-setup kernel computes itself on the card.

``ops.spectrum.HeroGatherFn`` (``gather_hero``): its forward bit-equal to
the JAX ``gather_hero_planar``; its backward, the fixed-order column sums
of ``setup.hero_column_sums``, against ``jax.vjp`` of ``gather_hero_planar``
and of ``take_cols`` (a one-hot contraction, summed in another order:
rtol 1e-5, atol 1e-6), against a float64 column sum (relative L2 1e-6),
bit-equal across runs and at small block sizes, against an explicit loop
in its stated order (within a block in ray order, the blocks in groups,
the groups in order). ``gather_hero_tables``, the spectra and CIE planes
in one launch: bit-equal to two gathers; its backward gives the CIE table
no gradient and the spectra table the one-table gather's.

The sample-invariant operands (``tracer.kernel.setup_operands``), built
once by ``render_accumulate`` and ``optimize.render_mean_xyz``: images
bit-equal to the per-sample path, gradients within relative L2 1e-6 of it
(autograd sums the primitive table's and spectra table's cotangents over
the samples first). Then a value_and_grad by spectra through
``render_pixels_planar``, and one by spectra and data1 through
``render_mean_xyz`` (2 samples), against the JAX package's
(``backward="pallas"``, interpret mode) at the tolerances of
tests/test_torch_train.py, on ``simple_scene``: the Cornell box's 18
primitives take the interpret-mode backward kernel over two minutes, past
this file's budget.

``setup.finish_frame``, a rendered frame's tail, on the CPU: its plain
version, for a planar (3, R) and an interleaved (H, W, 3) sum at sample
counts 3, 4 and 7, is ``accum / float(total)`` and ``color.xyz_to_srgb``
bit for bit, and launches nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.train import optimize as opt
from test_torch_cuda import finish_case

FILM = (37, 29)
BAND = (11, 5)  # rows, first row
K, N_COLS = 24, 301


@pytest.mark.parametrize("sample", [1, 17, 2**32 - 3])
def test_ray_setup_matches_jax_composition(sample):
    w, h = FILM
    js, _ = jax_scene_from_dict(jpresets.cornell_box(w, h))
    c = jdata.as_jax(js).camera
    px, py = kt.tile_coords(w, BAND[0], BAND[1])
    pxu, pyu = px.numpy().astype(np.uint32), py.numpy().astype(np.uint32)
    sample_u = jnp.uint32(sample)
    seed = jrng.seed_pixel_p(pxu, pyu, sample_u)
    o, d, seed = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, w, h, pxu,
                                    pyu, sample_u, seed)
    hero, seed = jspec.sample_wavelengths_p(seed)
    want = [np.asarray(x) for x in (o, d, hero, seed)]
    scene = scene_from_jax(js)
    got = setup_k.ray_setup(scene.camera, w, h, px, py, sample)
    planes = kt.camera_planes(scene, w, h, px, py, sample)
    for name, g, p, x in zip(("o", "d", "hero", "seed"), got, planes, want):
        assert torch.equal(g, p), name
        np.testing.assert_array_equal(g.numpy(), x.astype(g.numpy().dtype),
                                      err_msg=name)
    assert got[2].dtype == got[3].dtype == torch.int64


# (eye, lookat, up, fov) besides Cornell's: a tilted up, a fov near pi/2
CAMERAS = {
    "tilted": ((1.3, 2.1, -3.7), (0.2, 0.9, 0.4), (0.3, 1.0, 0.2), 0.9),
    "wide": ((0.0, 0.5, 5.0), (0.1, -0.2, 0.0), (0.0, 1.0, 0.0), 1.5707),
}


@pytest.mark.parametrize("sample", [1, 2**32 - 3])
@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_ray_setup_matches_jax_at_other_cameras(camera, sample):
    w, h = FILM
    eye, lookat, up, fov = (np.asarray(x, np.float32)
                            for x in CAMERAS[camera])
    px, py = kt.tile_coords(w, h, 0)
    pxu, pyu = px.numpy().astype(np.uint32), py.numpy().astype(np.uint32)
    sample_u = jnp.uint32(sample)
    seed = jrng.seed_pixel_p(pxu, pyu, sample_u)
    o, d, seed = jcam.camera_rays_p(eye, lookat, up, fov, w, h, pxu, pyu,
                                    sample_u, seed)
    hero, seed = jspec.sample_wavelengths_p(seed)
    scene, _ = scene_from_dict(presets.cornell_box(w, h), device="cpu")
    cam = dataclasses.replace(
        scene.camera, **{k: torch.from_numpy(v) for k, v in zip(
            ("eye", "lookat", "up", "fov"), (eye, lookat, up, fov))})
    got = setup_k.ray_setup(cam, w, h, px, py, sample)
    for name, g, x in zip(("o", "d", "hero", "seed"), got,
                          (o, d, hero, seed)):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(x).astype(g.numpy().dtype), err_msg=name)


def _gather_case(R, seed=0, decades=0.0):
    """A (24, 301) table, hero (R,) covering 0 and 300, and g (24, R),
    normal or, with decades, spread over 2 * decades decades (so that a
    change of summation order shows in the last bits)."""
    g = np.random.default_rng(seed)
    table = g.standard_normal((K, N_COLS)).astype(np.float32)
    hero = g.integers(0, N_COLS, R)
    hero[:3] = (0, 300, 300)
    hero[-1] = 0
    cot = (g.standard_normal((K, R))
           * 10.0 ** g.uniform(-decades, decades, (K, R))).astype(np.float32)
    return table, hero, cot


def _port_vjp(table, hero, cot):
    t = torch.from_numpy(table).requires_grad_(True)
    out = spec.gather_hero(t, torch.from_numpy(hero))
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("R", [4096, 4097])
def test_hero_gather_matches_jax(R):
    table, hero, cot = _gather_case(R)
    fwd, grad = _port_vjp(table, hero, cot)
    hero_j = jnp.asarray(hero, jnp.int32)
    want_fwd, vjp = jax.vjp(lambda t: jspec.gather_hero_planar(t, hero_j),
                            jnp.asarray(table))
    np.testing.assert_array_equal(fwd, np.asarray(want_fwd))
    (want_planar,) = vjp(jnp.asarray(cot))
    _, vjp_cols = jax.vjp(lambda t: jspec.take_cols(t, hero_j),
                          jnp.asarray(table))
    (want_cols,) = vjp_cols(jnp.asarray(cot))
    for want in (want_planar, want_cols):
        np.testing.assert_allclose(grad, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    exact = np.zeros((K, N_COLS))
    np.add.at(exact.T, hero, cot.T.astype(np.float64))
    rel_l2 = np.linalg.norm(grad - exact) / np.linalg.norm(exact)
    assert rel_l2 <= 1e-6, rel_l2
    assert (grad[:, 0] != 0).all() and (grad[:, 300] != 0).all()


def test_hero_gather_backward_bit_equal_across_runs():
    table, hero, cot = _gather_case(4097, seed=1, decades=3)
    first = _port_vjp(table, hero, cot)[1]
    second = _port_vjp(table, hero, cot)[1]
    np.testing.assert_array_equal(first, second)


def _loop_column_sums(g, hero, n_cols, block):
    """The stated order, one ray at a time: within each block in ray
    order (a hero outside [0, n_cols) skipped); the blocks' partials in
    setup.HERO_GROUPS groups of ceil(n_blocks / HERO_GROUPS) consecutive
    blocks, each in block order; then the groups in order (float32
    throughout, every sum from 0.0)."""
    parts = []
    for b0 in range(0, g.shape[1], block):
        part = torch.zeros((g.shape[0], n_cols))
        for r in range(b0, min(b0 + block, g.shape[1])):
            if 0 <= hero[r] < n_cols:
                part[:, hero[r]] = part[:, hero[r]] + g[:, r]
        parts.append(part)
    per = -(-len(parts) // setup_k.HERO_GROUPS)
    out = torch.zeros((g.shape[0], n_cols))
    for w in range(setup_k.HERO_GROUPS):
        group = torch.zeros_like(out)
        for part in parts[w * per:(w + 1) * per]:
            group = group + part
        out = out + group
    return out


@pytest.mark.parametrize("block", [1, 7, 64, setup_k.HERO_BLOCK])
def test_column_sums_fixed_order(block):
    _, hero, cot = _gather_case(301, seed=2, decades=3)
    hero = torch.from_numpy(hero % 9)  # many duplicates per column
    g = torch.from_numpy(cot)
    got = setup_k.hero_column_sums_reference(g, hero, 11, block)
    assert torch.equal(got, _loop_column_sums(g, hero, 11, block))
    assert torch.equal(got, setup_k.hero_column_sums_reference(g, hero, 11,
                                                               block))
    assert not got[:, 9:].any()


@pytest.mark.parametrize("block", [1, 64, setup_k.HERO_BLOCK])
def test_column_sums_against_float64(block):
    """The plain version's order over many blocks (20,000 rays: up to
    20,000 blocks in 8 groups) within relative L2 1e-6 of a float64
    column sum; heroes outside the table are skipped; the explicit loop
    agrees bit for bit on the first 1,500 rays."""
    _, hero, cot = _gather_case(20000, seed=4, decades=3)
    hero[5:40:7] = (-1, N_COLS, 10**6, -(10**6), N_COLS + 3)
    g, h = torch.from_numpy(cot), torch.from_numpy(hero)
    got = setup_k.hero_column_sums_reference(g, h, N_COLS, block)
    keep = (hero >= 0) & (hero < N_COLS)
    exact = np.zeros((K, N_COLS))
    np.add.at(exact.T, hero[keep], cot.T[keep].astype(np.float64))
    rel_l2 = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert rel_l2 <= 1e-6, rel_l2
    head = setup_k.hero_column_sums_reference(g[:, :1500], h[:1500], N_COLS,
                                              block)
    assert torch.equal(head, _loop_column_sums(g[:, :1500], h[:1500],
                                               N_COLS, block))


def test_gather_backward_follows_block_size(monkeypatch):
    """The Function's backward sums in blocks of setup.HERO_BLOCK: a small
    block puts many block boundaries inside the rays."""
    table, hero, cot = _gather_case(1000, seed=3, decades=3)
    monkeypatch.setattr(setup_k, "HERO_BLOCK", 64)
    grad = _port_vjp(table, hero, cot)[1]
    want = _loop_column_sums(torch.from_numpy(cot), torch.from_numpy(hero),
                             N_COLS, 64)
    np.testing.assert_array_equal(grad, want.numpy())


def test_gather_records_only_under_grad():
    table = torch.rand((K, N_COLS))
    hero = torch.randint(0, N_COLS, (50,))
    assert spec.gather_hero(table, hero).grad_fn is None
    table.requires_grad_(True)
    with torch.no_grad():
        assert spec.gather_hero(table, hero).grad_fn is None
    fn = spec.gather_hero(table, hero).grad_fn
    assert type(fn).__name__ == "HeroGatherFnBackward"


def test_gather_tables_one_call_matches_two_gathers():
    """The spectra and CIE planes of gather_hero_tables are the two
    gathers' bit for bit; under grad the CIE plane (its table needs no
    gradient) records nothing, and the spectra table's gradient is the
    one-table gather's."""
    table, hero, cot = _gather_case(3000, seed=5, decades=3)
    cie = np.random.default_rng(6).standard_normal((12, N_COLS)).astype(
        np.float32)
    h = torch.from_numpy(hero)
    t = torch.from_numpy(table).requires_grad_(True)
    c = torch.from_numpy(cie)
    spect_p, cie_p = spec.gather_hero_tables((t, c), h)
    assert torch.equal(spect_p, spec.gather_hero(t, h))
    assert torch.equal(cie_p, spec.gather_hero(c, h))
    assert not cie_p.requires_grad and c.grad is None
    assert type(spect_p.grad_fn).__name__ == "HeroGatherFnBackward"
    (spect_p * torch.from_numpy(cot)).sum().backward()
    assert c.grad is None
    np.testing.assert_array_equal(t.grad.numpy(),
                                  _port_vjp(table, hero, cot)[1])


class _Calls:
    """Counts the calls of the sample-invariant setup's builders; ONCE is
    one render's or loss's (expand_hero_table twice: the spectra table,
    and the CIE window inside cie_window_exp)."""

    ONCE = {"setup_operands": 1, "pack_prims": 1, "expand_hero_table": 2,
            "cie_window_exp": 1, "tile_coords": 1}

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(("setup_operands", "pack_prims",
                                "expand_hero_table", "cie_window_exp",
                                "tile_coords"), 0)
        for mod, name in ((kt, "setup_operands"), (mk, "pack_prims"),
                          (spec, "expand_hero_table"),
                          (spec, "cie_window_exp"), (kt, "tile_coords")):
            monkeypatch.setattr(mod, name, self._counted(name,
                                                         getattr(mod, name)))

    def _counted(self, name, fn):
        def wrapper(*args, **kw):
            self.n[name] += 1
            return fn(*args, **kw)
        return wrapper


SETUP_W, SETUP_H, SETUP_SPP, SETUP_DEPTH = 16, 12, 3, 4


def _setup_scene():
    scene, _ = scene_from_dict(presets.cornell_box(SETUP_W, SETUP_H),
                               device="cpu")
    return scene


def _per_sample_sum(scene, render):
    return sum(render(scene, SETUP_W, SETUP_H, s, SETUP_DEPTH)
               for s in range(1, SETUP_SPP + 1))


def test_render_accumulate_builds_setup_once(monkeypatch):
    """render_accumulate builds the pixel coordinates, the primitive
    table, the expanded spectra table and the CIE window once, and its
    image is the per-sample path's bit for bit."""
    scene = _setup_scene()
    want = _per_sample_sum(scene, kt.render_sample)
    calls = _Calls(monkeypatch)
    got = kt.render_accumulate(scene, SETUP_W, SETUP_H, SETUP_SPP,
                               SETUP_DEPTH)
    assert calls.n == calls.ONCE
    assert torch.equal(got, want)


@pytest.mark.parametrize("backward", ["pallas", "pallas_taped"])
def test_render_mean_xyz_builds_setup_once(monkeypatch, backward):
    """render_mean_xyz (the loss's render) builds the setup once a call;
    its image is the per-sample path's bit for bit and its gradients by
    spectra and data1 within relative L2 1e-6 of it (the primitive
    table's and spectra table's cotangents are summed over the samples
    before their backward), and bit-equal across runs."""
    scene = _setup_scene()

    def grads(bundled):
        sp = scene.spectra.clone().requires_grad_(True)
        d1 = scene.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(scene, spectra=sp, primitives=(
            dataclasses.replace(scene.primitives, data1=d1)))
        if bundled:
            img = opt.render_mean_xyz(s, SETUP_W, SETUP_H, SETUP_SPP,
                                      SETUP_DEPTH, backward=backward)
        else:
            img = _per_sample_sum(s, lambda *a: kt.render_sample(
                *a, backward=backward)) / float(SETUP_SPP)
        (img ** 2).mean().backward()
        return img.detach(), sp.grad, d1.grad

    want = grads(False)
    calls = _Calls(monkeypatch)
    got = grads(True)
    assert calls.n == calls.ONCE
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.isfinite(g).all() and (g != 0).any()
        assert ((g - w).norm() / w.norm()).item() <= 1e-6
    again = grads(True)
    for g, w in zip(got[1:], again[1:]):
        assert torch.equal(g, w)


def test_setup_operands_for_another_backward_raise():
    """A bundle whose primitive table is not the trace's (here the
    unrolled rows for the guided replay of a scene with a mesh part)
    raises."""
    scene, _ = scene_from_dict(presets.mesh_scene(8, 8, 1), device="cpu")
    static = mk.SceneStatic.from_scene(scene, mesh_min=64)
    assert static.mesh_parts
    setup = kt.setup_operands(scene, static, "none")
    px, py = kt.tile_coords(8, 8, 0)
    with pytest.raises(ValueError, match="primitive rows"):
        kt.render_pixels_planar(scene, 8, 8, px, py, 1, 2, static=static,
                                backward="pallas", setup=setup)


W = H = 16
DEPTH = 3


def _jax_value_and_grad(js):
    px, py = (jnp.asarray(x.numpy()) for x in kt.tile_coords(W, H, 0))

    def loss(spectra):
        xyz = jax_pallas.render_pixels_planar(
            js._replace(spectra=spectra), W, H, px, py, 1, max_depth=DEPTH,
            backward="pallas")
        return jnp.mean(xyz ** 2)

    v, g = jax.value_and_grad(loss)(jnp.asarray(js.spectra))
    return float(v), np.asarray(g)


def test_render_value_and_grad_matches_jax():
    js, _ = jax_scene_from_dict(jpresets.simple_scene(W, H))
    want_v, want_g = _jax_value_and_grad(js)
    scene = scene_from_jax(js)
    sp = scene.spectra.clone().requires_grad_(True)
    px, py = kt.tile_coords(W, H, 0)
    before = (setup_k.launches_ray_setup, setup_k.launches_gather,
              setup_k.launches_gather_bwd, mk.launches)
    xyz = kt.render_pixels_planar(dataclasses.replace(scene, spectra=sp),
                                  W, H, px, py, 1, DEPTH)
    loss = (xyz ** 2).mean()
    loss.backward()
    assert before == (setup_k.launches_ray_setup, setup_k.launches_gather,
                      setup_k.launches_gather_bwd, mk.launches)
    got = sp.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert abs(loss.item() - want_v) <= 1e-4 * abs(want_v)
    scale = max(np.abs(want_g).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want_g / scale, rtol=1e-3,
                               atol=1e-4)


def _jax_mean_value_and_grad(js, spp):
    """value_and_grad of mean((sum of samples 1..spp / spp) ** 2) by
    (spectra, data1) through the JAX package's render_sample."""

    def loss(spectra, d1):
        s = js._replace(spectra=spectra,
                        primitives=js.primitives._replace(data1=d1))
        img = sum(jax_pallas.render_sample(s, W, H, k, max_depth=DEPTH,
                                           backward="pallas")
                  for k in range(1, spp + 1)) / float(spp)
        return jnp.mean(img ** 2)

    v, g = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(js.spectra), jnp.asarray(js.primitives.data1))
    return float(v), [np.asarray(x) for x in g]


def test_setup_once_gradients_match_jax():
    """render_mean_xyz with its once-per-loss setup, 2 samples: the
    gradients by spectra and data1 against the JAX package's at
    tests/test_torch_train.py's tolerances."""
    js, _ = jax_scene_from_dict(jpresets.simple_scene(W, H))
    want_v, want_g = _jax_mean_value_and_grad(js, 2)
    scene = scene_from_jax(js)
    sp = scene.spectra.clone().requires_grad_(True)
    d1 = scene.primitives.data1.clone().requires_grad_(True)
    s = dataclasses.replace(scene, spectra=sp, primitives=(
        dataclasses.replace(scene.primitives, data1=d1)))
    loss = (opt.render_mean_xyz(s, W, H, 2, DEPTH) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - want_v) <= 1e-4 * abs(want_v)
    for name, got, want in (("spectra", sp.grad.numpy(), want_g[0]),
                            ("data1", d1.grad.numpy(), want_g[1])):
        assert np.isfinite(got).all() and np.abs(got).max() > 0, name
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_cpu_render_differentiates_the_camera():
    """On the CPU the wrappers run the plain versions, and a render
    differentiates the camera through RaySetupFn's plain backward."""
    scene, _ = scene_from_dict(presets.cornell_box(8, 8), device="cpu")
    eye = scene.camera.eye.clone().requires_grad_(True)
    cam_scene = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, eye=eye))
    kt.render_sample(cam_scene, 8, 8, 1, 2).sum().backward()
    assert eye.grad is not None and torch.isfinite(eye.grad).all()


@pytest.mark.parametrize("total", [3, 4, 7])
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_finish_frame_on_the_cpu_is_the_division_and_srgb(layout, total):
    from computeraytracer_tpu_torch.ops import color

    w = h = 64
    xyz = finish_case(w, h, total)
    film = xyz.view(3, h, w).permute(1, 2, 0).contiguous()
    src = xyz if layout == "planar" else film
    before = setup_k.launches_finish
    accum, mean, srgb = setup_k.finish_frame(src, total, w, h)
    assert setup_k.launches_finish == before
    want_mean = film / float(total)
    assert torch.equal(accum, film)
    assert (accum is src) == (layout == "interleaved")
    assert torch.equal(mean, want_mean)
    assert torch.equal(srgb, color.xyz_to_srgb(want_mean))
    assert 0 < float((srgb == 0).float().mean()) < 1
    assert bool(((srgb > 0) & (srgb < 0.04)).any())


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_finish_frame_backward_is_the_plain_versions_vjp(layout):
    """FinishFn on a sum that requires grad: its outputs are the plain
    version's, and the gradient it passes back to the sum, from cotangents
    on all three images, is the plain version's autograd bit for bit."""
    w, h, total = 16, 8, 3
    xyz = finish_case(w, h, 11)
    src = xyz if layout == "planar" else (
        xyz.view(3, h, w).permute(1, 2, 0).contiguous())
    gen = torch.Generator().manual_seed(12)
    gs = [torch.randn((h, w, 3), generator=gen) for _ in range(3)]
    a = src.clone().requires_grad_(True)
    got = setup_k.FinishFn.apply(a, total, w, h)
    b = src.clone().requires_grad_(True)
    want = setup_k.finish_frame_reference(b, total, w, h)
    for g, x in zip(got, want):
        assert g.requires_grad and torch.equal(g, x)
    g_got, = torch.autograd.grad(got, a, gs)
    g_want, = torch.autograd.grad(want, b, gs)
    # the plain version's own VJP is NaN where a gamma branch that where
    # drops is not finite: equal there too
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=0,
                               equal_nan=True)
    assert bool((g_got != 0).any())
