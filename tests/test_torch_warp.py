"""The warped-area reparameterization of the PyTorch port (``ops/warp.py``,
``ops/camera.py`` ``world_to_film``) against the JAX package's.

Inputs are made with numpy from a seed. The JAX values run under
``jax.disable_jit()``, op by op, as in tests/test_torch_eager.py; the
JAX gradients and tangents under ``jax.jit`` (one compile each). Every
warp is exactly the identity: the warped (u', v') equal the inputs bit for
bit and detJ == 1. The theta-gradients (the primitives' data1/2/3, and
the shade points where a warp takes them) of a fixed weighted sum of (u',
v', detJ) match jax.grad within rtol 1e-4 of each tensor's largest
entry. Clips at a tie split the gradient and the tangent in half, as
``jnp.clip`` does. Then the JAX package's two analytic cases
(tests/test_visibility_grads.py: the synthetic step flux within 12% of
its closed form, the light warp within 0.25 of -2.5), on the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import warp as jwarp
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch.ops import camera as cam
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops import sampling
from computeraytracer_tpu_torch.ops import warp
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax

W = H = 16
N = 300
GEOM = ("data1", "data2", "data3")
LIGHT = 2  # the light's row in presets.occluder_scene
FLOOR = 0


@pytest.fixture(scope="module")
def occ():
    js = jdata.as_jax(jax_scene_from_dict(jpresets.occluder_scene(W, H))[0])
    return js, scene_from_jax(js, device="cpu")


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


def _jax_with(js, geom):
    return js._replace(primitives=js.primitives._replace(
        **dict(zip(GEOM, geom))))


def _torch_leaves(ts):
    leaves = [getattr(ts.primitives, n).clone().requires_grad_(True)
              for n in GEOM]
    return leaves, dataclasses.replace(
        ts, primitives=dataclasses.replace(ts.primitives,
                                           **dict(zip(GEOM, leaves))))


def _check_warp(port, jax_fn, js, ts, u, v, extra=()):
    """port(scene, *extra) and jax_fn(scene, *extra) -> (u', v', detj):
    identity on the inputs, gradients of a weighted sum against JAX."""
    r = np.random.default_rng(7)
    wts = r.uniform(0.5, 1.5, (3, N)).astype(np.float32)
    leaves, s = _torch_leaves(ts)
    extra_t = [torch.from_numpy(e).requires_grad_(True) for e in extra]
    uw, vw, detj = port(s, *extra_t)
    assert torch.equal(uw, torch.from_numpy(u))
    assert torch.equal(vw, torch.from_numpy(v))
    assert torch.equal(detj, torch.ones_like(detj))
    wt = torch.from_numpy(wts)
    (wt[0] * uw + wt[1] * vw + wt[2] * detj).sum().backward()
    got = [t.grad.numpy() for t in leaves + extra_t]

    def loss(*args):
        s_j = _jax_with(js, args[:3])
        a, b, dj = jax_fn(s_j, *args[3:])
        return jnp.sum(wts[0] * a + wts[1] * b + wts[2] * dj)

    args = [jnp.asarray(getattr(js.primitives, n)) for n in GEOM]
    args += [jnp.asarray(e) for e in extra]
    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _close_rel(g, w, 1e-4)
    # the boundary term is there: some silhouette moves the samples
    assert np.abs(got[0]).max() > 0


def test_world_to_film_matches_jax(occ):
    js, ts = occ
    r = np.random.default_rng(0)
    x = r.uniform(-3, 3, (N, 3)).astype(np.float32)
    x[:, 2] -= 4.0
    x[:4] = np.asarray(js.camera.eye)  # at the eye: the floored depth
    c, jc = ts.camera, js.camera
    got = cam.world_to_film(c.eye, c.lookat, c.up, c.fov, W, H,
                            torch.from_numpy(x))
    with jax.disable_jit():
        want = jcam.world_to_film(jc.eye, jc.lookat, jc.up, jc.fov, W, H,
                                  jnp.asarray(x))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _mixed_prims():
    """A patch, a sphere and a triangle row in one table."""
    doc = jpresets.simple_scene(8, 8)
    doc["objects"]["meshes"] = [{
        "vertices": [[-1.0, 0.2, 0.5], [1.5, 0.4, 0.1], [0.2, 1.7, -0.3]],
        "faces": [[0, 1, 2]], "emission": "dark", "reflectance": "white",
        "type": "diffuse"}]
    return jax_scene_from_dict(doc)[0]


def test_material_point_matches_jax():
    js = jdata.as_jax(_mixed_prims())
    ts = scene_from_jax(js, device="cpu")
    cats = np.asarray(js.primitives.category)
    assert {0, 1, 2} <= set(cats.tolist())
    r = np.random.default_rng(1)
    idx = r.integers(0, len(cats), N)
    idx[:3] = [np.argmax(cats == k) for k in (0, 1, 2)]
    p = r.uniform(-2, 2, (N, 3)).astype(np.float32)
    wts = r.uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    leaves, s = _torch_leaves(ts)
    got = warp.material_point(s.primitives, torch.from_numpy(idx),
                              torch.from_numpy(p))
    (got * torch.from_numpy(wts)).sum().backward()

    def fn(*geom):
        return jwarp.material_point(_jax_with(js, geom).primitives,
                                    jnp.asarray(idx, jnp.int32),
                                    jnp.asarray(p))

    args = [jnp.asarray(getattr(js.primitives, n)) for n in GEOM]
    with jax.disable_jit():
        want = fn(*args)
        grads = jax.grad(lambda *a: jnp.sum(fn(*a) * wts),
                         argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for leaf, w in zip(leaves, grads):
        _close_rel(leaf.grad.numpy(), w, 1e-4)


@pytest.mark.parametrize("bounds", ["tensor", "constant"])
def test_clip_splits_ties_as_jnp_clip(bounds):
    """Reverse gradient and forward tangent of warp._clip at samples
    exactly on the lower and upper bound, and inside and outside."""
    x = np.array([0.2, 0.5, 1.0, -1.0, 2.0, 0.7], np.float32)
    lo = np.full_like(x, 0.2) if bounds == "tensor" else 0.2
    hi = np.full_like(x, 1.0) if bounds == "tensor" else 1.0
    lo_t = torch.from_numpy(lo) if bounds == "tensor" else lo
    hi_t = torch.from_numpy(hi) if bounds == "tensor" else hi
    xt = torch.from_numpy(x).requires_grad_(True)
    warp._clip(xt, lo_t, hi_t).sum().backward()
    want_g = jax.grad(lambda a: jnp.sum(jnp.clip(a, lo, hi)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert xt.grad[0] == 0.5 and xt.grad[2] == 0.5
    tan = np.linspace(1.0, 2.0, x.size).astype(np.float32)
    _, got_t = warp._jvp(lambda a: warp._clip(a, lo_t, hi_t),
                         torch.from_numpy(x), torch.from_numpy(tan))
    _, want_t = jax.jvp(lambda a: jnp.clip(a, lo, hi), (jnp.asarray(x),),
                        (jnp.asarray(tan),))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_edge_taper_matches_jax():
    """Values, gradient and tangent, with ties: u = margin (the clip's
    upper bound), u = 0 (its lower bound) and u = 0.5 (the min's tie)."""
    r = np.random.default_rng(2)
    uv = r.uniform(0, 1, (N, 2)).astype(np.float32)
    m = 0.125
    uv[0] = [m, 1.0 - m]
    uv[1] = [0.0, 0.5]
    wts = r.uniform(0.5, 1.5, (N, 2)).astype(np.float32)
    for margins in ((m, m), (m, None)):
        uv_t = torch.from_numpy(uv).requires_grad_(True)
        got = warp._edge_taper(uv_t, margins)
        (got * torch.from_numpy(wts)).sum().backward()
        with jax.disable_jit():
            want = jwarp._edge_taper(jnp.asarray(uv), margins)
        want_g = jax.jit(jax.grad(lambda a: jnp.sum(
            jwarp._edge_taper(a, margins) * wts)))(jnp.asarray(uv))
        _, want_t = jax.jit(lambda a, t: jax.jvp(
            lambda b: jwarp._edge_taper(b, margins), (a,), (t,)))(
                jnp.asarray(uv), jnp.asarray(wts))
        _, got_t = warp._jvp(lambda a: warp._edge_taper(a, margins),
                             torch.from_numpy(uv), torch.from_numpy(wts))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(uv_t.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=1e-6, atol=1e-6)


def test_make_field_reparam_matches_jax():
    """_make_field + _reparam on synthetic rings: a straight edge through
    some rings, its side moving with theta (2,), plus uniform rings."""
    r = np.random.default_rng(3)
    n, rad = N, 0.05
    uv = r.uniform(0.1, 0.9, (n, 2)).astype(np.float32)
    offs = jwarp._ring_offsets_np(8) * rad
    a_k = uv[:, None, :] + offs
    edge = 0.5 + 0.02 * r.standard_normal(n).astype(np.float32)
    fg = a_k[..., 0] < edge[:, None]
    z_k = np.where(fg, 1.0, 2.0).astype(np.float32)
    idx_k = np.where(fg, 1, 0).astype(np.int32)
    theta = np.array([0.0, 0.0], np.float32)
    wts = r.uniform(0.5, 1.5, (3, n)).astype(np.float32)

    def build(xp, th, conv, ops):
        a = conv(a_k)
        s_k = xp.where(conv(fg)[..., None], a + th, a)
        field = ops._make_field(a, s_k, conv(z_k), conv(idx_k),
                                bandwidth=rad, beta=8.0)
        return ops._reparam(field, conv(uv), margins=(0.1, 0.1))

    th_t = torch.from_numpy(theta).requires_grad_(True)
    uv_w, detj = build(torch, th_t, torch.from_numpy, warp)
    assert torch.equal(uv_w, torch.from_numpy(uv))
    assert torch.equal(detj, torch.ones_like(detj))
    wt = torch.from_numpy(wts)
    (wt[0] * uv_w[:, 0] + wt[1] * uv_w[:, 1] + wt[2] * detj).sum().backward()

    def loss(th):
        a, dj = build(jnp, th, jnp.asarray, jwarp)
        return jnp.sum(wts[0] * a[:, 0] + wts[1] * a[:, 1] + wts[2] * dj)

    want = jax.jit(jax.grad(loss))(jnp.asarray(theta))
    assert np.abs(np.asarray(want)).max() > 0
    _close_rel(th_t.grad.numpy(), want, 1e-4)


def test_screen_warp_matches_jax(occ):
    js, ts = occ
    r = np.random.default_rng(4)
    s = r.uniform(0, 1, N).astype(np.float32)
    t = r.uniform(0, 1, N).astype(np.float32)
    _check_warp(
        lambda sc: warp.screen_warp(sc, W, H, torch.from_numpy(s),
                                    torch.from_numpy(t)),
        lambda sc: jwarp.screen_warp(sc, W, H, jnp.asarray(s),
                                     jnp.asarray(t)),
        js, ts, s, t)


def _shade_points(r):
    x = np.stack([r.uniform(-1.5, 1.5, N), np.zeros(N),
                  r.uniform(-1.5, 2.5, N)], -1).astype(np.float32)
    u = r.uniform(0, 1, N).astype(np.float32)
    v = r.uniform(0, 1, N).astype(np.float32)
    active = r.uniform(0, 1, N) < 0.9
    return x, u, v, active


def test_light_warp_matches_jax(occ):
    js, ts = occ
    x, u, v, active = _shade_points(np.random.default_rng(5))

    def port(sc, xs):
        p = sc.primitives
        rows = torch.full((N,), LIGHT, dtype=torch.int64)
        return warp.light_warp(
            sc, xs, torch.full((N,), FLOOR, dtype=torch.int64),
            isect.take(p.data1, rows), isect.take(p.data2, rows),
            isect.take(p.data3, rows), rows, torch.from_numpy(u),
            torch.from_numpy(v), torch.from_numpy(active))

    def jax_fn(sc, xs):
        p = sc.primitives
        rows = jnp.full((N,), LIGHT, jnp.int32)
        return jwarp.light_warp(
            sc, xs, jnp.full((N,), FLOOR, jnp.int32), p.data1[rows],
            p.data2[rows], p.data3[rows], rows, jnp.asarray(u),
            jnp.asarray(v), jnp.asarray(active))

    _check_warp(port, jax_fn, js, ts, u, v, extra=(x,))


def test_hemisphere_warp_matches_jax(occ):
    js, ts = occ
    x, u, v, active = _shade_points(np.random.default_rng(6))
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (N, 1))

    def port(sc, xs):
        return warp.hemisphere_warp(
            sc, xs, torch.from_numpy(n),
            torch.full((N,), FLOOR, dtype=torch.int64), torch.from_numpy(u),
            torch.from_numpy(v), torch.from_numpy(active))

    def jax_fn(sc, xs):
        return jwarp.hemisphere_warp(
            sc, xs, jnp.asarray(n), jnp.full((N,), FLOOR, jnp.int32),
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(active))

    _check_warp(port, jax_fn, js, ts, u, v, extra=(x,))


# ---------------------------------------------------------------------------
# the JAX package's analytic cases, on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """120,000 samples through many small elementwise ops: one thread
    runs them in about a second, where torch's thread pool on a loaded
    host took up to 30 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_loss(u, w_pix, npix, a=2.0, b=0.5, s0=0.53125, rad=0.04):
    """The warp on f = a if x < s0+theta else b, with static pixel
    binning and the tent splat, as the renderer's screen domain does."""
    offs = warp.ring_offsets(8) * rad

    def loss(theta):
        a_k = u.detach()[:, None, :] + offs
        fg = a_k[..., 0] < (s0 + theta.detach())
        shift = torch.stack([theta - theta.detach(),
                             torch.zeros_like(theta)])
        s_k = torch.where(fg[..., None], a_k + shift, a_k)
        z_k = torch.where(fg, 1.0, 2.0)
        idx_k = torch.where(fg, 1, 0)
        field = warp._make_field(a_k, s_k, z_k, idx_k, bandwidth=rad,
                                 beta=8.0)
        uv_w, detj = warp._reparam(field, u, margins=(0.1, 0.1))
        f = torch.where(uv_w[:, 0] < (s0 + theta), a, b)
        pi = (u.detach() * npix).to(torch.int64).clamp(0, npix - 1)
        out = f * detj * w_pix[pi[:, 1], pi[:, 0]]
        g = uv_w * npix - 0.5
        x0 = torch.floor(g.detach())
        for dx in (0.0, 1.0):
            for dy in (0.0, 1.0):
                q = x0 + torch.tensor([dx, dy])
                kk = (isect.maximum(1.0 - (g[:, 0] - q[:, 0]).abs(), 0.0)
                      * isect.maximum(1.0 - (g[:, 1] - q[:, 1]).abs(), 0.0))
                qi = q.to(torch.int64).clamp(0, npix - 1)
                out = out + ((kk - kk.detach()) * (f * detj).detach()
                             * w_pix[qi[:, 1], qi[:, 0]])
        return out.mean()

    return loss


@pytest.mark.parametrize("wkind", ["flat", "rand"])
def test_synthetic_step_boundary_flux(one_thread, wkind):
    """AD of the warped estimator against d/dtheta of the true integral,
    (A - B) * the mean edge weight, within 12% (the JAX bound)."""
    npix = 16
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.uniform(0, 1, (120000, 2)).astype(np.float32))
    if wkind == "flat":
        w_np = np.ones((npix, npix), np.float32)
    else:
        w_np = rng.uniform(0.5, 1.5, (npix, npix)).astype(np.float32)
    theta = torch.zeros((), requires_grad=True)
    _step_loss(u, torch.from_numpy(w_np), npix)(theta).backward()
    ad = float(theta.grad)
    analytic = (2.0 - 0.5) * w_np[:, npix // 2].mean()
    assert abs(ad - analytic) <= 0.12 * analytic, (ad, analytic)


def test_light_warp_matches_analytic(one_thread):
    """Half-plane blocker at y=1 (edge x = theta), light at y=2: the
    visible fraction from the origin is 1 - (0.5 + 2.5 theta), so
    dL/dtheta = -2.5; the warp's gradient lands within 0.25 of it."""
    doc = {
        "camera": {"eye": [0, 0, 5], "lookat": [0, 0, 0], "up": [0, 1, 0],
                   "focalLength": 0.9, "width": 8, "height": 8},
        "objects": {"patches": [
            {"origin": [-10, 1, -10], "edge1": [10, 0, 0],
             "edge2": [0, 0, 20], "emission": "dark",
             "reflectance": "white", "type": "diffuse"},
            {"origin": [-0.4, 2, -0.4], "edge1": [0.8, 0, 0],
             "edge2": [0, 0, 0.8], "emission": "light",
             "reflectance": "white", "type": "light"},
        ], "spheres": []},
        "spectra": presets._cornell_spectra(),
    }
    scene0, _ = scene_from_dict(doc, device="cpu")
    n, l_prim_i = 120000, 1
    rng = np.random.default_rng(3)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u0, v0 = torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1])
    dx = torch.zeros((), requires_grad=True)
    bump = torch.zeros_like(scene0.primitives.data1)
    bump[0, 0] = 1.0
    d1 = scene0.primitives.data1 + bump * dx
    s = dataclasses.replace(scene0, primitives=dataclasses.replace(
        scene0.primitives, data1=d1))
    prims = s.primitives
    shade = torch.zeros((n, 3))
    exclude = torch.full((n,), isect.NO_INDEX, dtype=torch.int64)
    rows = torch.full((n,), l_prim_i, dtype=torch.int64)
    l_origin = isect.take(prims.data1, rows)
    l_e1 = isect.take(prims.data2, rows)
    l_e2 = isect.take(prims.data3, rows)
    uw, vw, detj = warp.light_warp(s, shade, exclude, l_origin, l_e1, l_e2,
                                   rows, u0, v0, torch.ones(n, dtype=bool))
    p = sampling.point_on_light(l_origin, l_e1, l_e2, uw, vw)
    ldir = isect.safe_normalize(p - shade)
    sh = isect.intersect_brute(shade, ldir, exclude, prims)
    vis = (sh.hit & (sh.index == l_prim_i)).to(torch.float32)
    (vis * detj).mean().backward()
    assert abs(float(dx.grad) - (-2.5)) <= 0.25, float(dx.grad)
