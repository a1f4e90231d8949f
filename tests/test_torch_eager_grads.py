"""Gradients of the port's eager tracer (``tracer/xla.py``, torch
autograd) against ``jax.grad`` of the JAX package's ``tracer.xla``, and
the kernel path's ``backward="xla"`` (the recompute-vjp through the eager
tracer) against ``backward="pallas"`` (the retrace kernel's plain
version), on ``simple_scene`` and a variant whose sphere is glass, 8x8,
depth 2. Both sides get the same scene numbers (``scene_from_jax``).

Tolerance: rtol 1e-3 and atol 1e-5, each tensor divided by its largest
magnitude (tests/test_pallas.py:191-240's limits; torch's CPU roots are
taken in float64 and rounded, and torch's ``abs`` has gradient 0 at
exactly 0 where JAX's has 1). Every gradient finite; ``use_remat=True``
bit-equal to ``use_remat=False``. Then ``train.optimize(kernel="xla")``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import xla as jax_xla
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.train import optimize as opt

W = H = 8
DEPTH = 2
# (sub-dataclass, field) of every differentiated leaf
LEAVES = ((None, "spectra"), ("primitives", "data1"),
          ("primitives", "data2"), ("primitives", "data3"),
          ("camera", "eye"), ("camera", "fov"))


def _jax_scene(variant):
    doc = jpresets.simple_scene(W, H)
    if variant == "glass":
        doc["objects"]["spheres"][0]["type"] = "glass"
    return jax_scene_from_dict(doc)[0]


def _get(scene, part, name):
    return getattr(getattr(scene, part) if part else scene, name)


def _jax_grads(js):
    def loss(*leaves):
        s = js
        for (part, name), leaf in zip(LEAVES, leaves):
            if part is None:
                s = s._replace(**{name: leaf})
            else:
                s = s._replace(**{part: getattr(s, part)._replace(
                    **{name: leaf})})
        return jnp.sum(jax_xla.render_sample(s, W, H, 1, DEPTH) ** 2)

    args = [jnp.asarray(_get(js, p, n)) for p, n in LEAVES]
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(len(LEAVES))))(*args)]


def _port_grads(scene, render):
    leaves = [_get(scene, p, n).clone().requires_grad_(True)
              for p, n in LEAVES]
    s = kt.with_leaves(scene, [
        dict(zip(LEAVES, leaves)).get(key, leaf)
        for key, leaf in zip(kt.SCENE_LEAVES, kt.scene_leaves(scene))])
    (render(s) ** 2).sum().backward()
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.fixture(scope="module", params=["simple", "glass"])
def case(request):
    js = _jax_scene(request.param)
    ts = scene_from_jax(js, device="cpu")
    eager = _port_grads(ts, lambda s: xla.render_sample(s, W, H, 1, DEPTH))
    return dict(jax=_jax_grads(js), scene=ts, eager=eager)


def _assert_close(got, want):
    for (part, name), g, w in zip(LEAVES, got, want):
        assert np.isfinite(g).all(), name
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_eager_grads_match_jax(case):
    _assert_close(case["eager"], case["jax"])


def test_use_remat_is_bit_equal(case):
    plain = _port_grads(case["scene"], lambda s: xla.render_sample(
        s, W, H, 1, DEPTH, use_remat=False))
    for g, want in zip(plain, case["eager"]):
        np.testing.assert_array_equal(g, want)


def test_backward_xla_matches_pallas_and_jax(case):
    got = _port_grads(case["scene"], lambda s: kt.render_sample(
        s, W, H, 1, DEPTH, backward="xla"))
    _assert_close(got, case["jax"])
    pallas = _port_grads(case["scene"], lambda s: kt.render_sample(
        s, W, H, 1, DEPTH, backward="pallas"))
    _assert_close(got, pallas)


def test_backward_xla_follows_grad_mode(case):
    s = dataclasses.replace(
        case["scene"], spectra=case["scene"].spectra.clone()
        .requires_grad_(True))
    with torch.no_grad():
        out = kt.render_sample(s, W, H, 1, DEPTH, backward="xla")
    assert not out.requires_grad
    out = kt.render_sample(s, W, H, 1, DEPTH, backward="xla")
    assert out.requires_grad
    assert torch.equal(out.detach(), kt.render_sample(
        s, W, H, 1, DEPTH, backward="none"))


def test_cornell_grads_finite():
    """Cornell: glass, the light's MIS at the coplanar ceiling, depth 4."""
    js = jax_scene_from_dict(jpresets.cornell_box(W, H))[0]
    ts = scene_from_jax(js, device="cpu")
    for g in _port_grads(ts, lambda s: xla.render_sample(s, W, H, 1, 4)):
        assert np.isfinite(g).all()
        assert np.abs(g).max() > 0


def test_optimize_xla_lowers_the_loss():
    scene = scene_from_jax(_jax_scene("simple"), device="cpu")
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, W, H, 1, DEPTH, kernel="xla")
    spectra = scene.spectra.clone()
    spectra[2] = spectra[2] * 0.3
    dimmed = dataclasses.replace(scene, spectra=spectra)
    _, losses = opt.optimize(dimmed, target, W, H, steps=3,
                             learning_rate=0.05, spp=1, max_depth=DEPTH,
                             kernel="xla", spectra_rows=[2])
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    loss_fn = opt.make_loss_fn(dimmed, W, H, 1, DEPTH, kernel="xla",
                               use_remat=False)
    assert float(loss_fn({"spectra": spectra}, target, 1)) == losses[0]
