"""Gradients of mesh scenes through the port's tracer vs the JAX package.

``mesh_scene(8, 8, 1)`` has 80 triangles beside its 6 patches. At the
default ``mesh_min`` (256) they stay unrolled category-2 rows, which
every backward differentiates: ``"pallas"`` (the retrace kernel, on the
CPU its plain version ``backward_reference``), ``"pallas_taped"`` (the
taped forward and the tape-fed kernel) and ``"replay"`` (the guided
replay with no mesh part). At ``mesh_min=16`` they are one mesh part,
which the tracer routes to the guided replay whatever the backward.

The reference is JAX AD of the JAX package's XLA tracer
(``tracer/xla.py``), the pattern of tests/test_pallas.py:147-187: its
gradient does not depend on mesh_min, and tests/test_pallas.py holds the
JAX package's Pallas paths (``build_backward``, the guided replay)
against it at the tolerances used here. Interpret-mode Pallas would take
minutes on the CPU (``build_backward`` over 86 unrolled rows, the
replay path's winner-taped forward). The gradient of
``sum(render_sample ** 2)`` with respect to ``data1``, ``spectra`` and
``camera.eye``, normalised by its largest entry: rtol 1e-3, atol 1e-4
(tests/test_pallas.py:184). The mesh rows (>= 6) get a non-zero vertex
gradient. Last, the CLI ``train`` on ``mesh_scene``'s mesh part.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import xla as jax_xla
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 8
DEPTH = 2


@pytest.fixture(scope="module")
def reference():
    js, _ = jax_scene_from_dict(jpresets.mesh_scene(W, H, 1))

    def loss(d1, sp, eye):
        s = js._replace(primitives=js.primitives._replace(data1=d1),
                        spectra=sp, camera=js.camera._replace(eye=eye))
        return jnp.sum(jax_xla.render_sample(s, W, H, 1,
                                             max_depth=DEPTH) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(js.primitives.data1), jnp.asarray(js.spectra),
        jnp.asarray(js.camera.eye))
    return scene_from_jax(js), [np.asarray(g) for g in grads]


def _grads(scene, static, backward):
    d1 = scene.primitives.data1.clone().requires_grad_(True)
    sp = scene.spectra.clone().requires_grad_(True)
    eye = scene.camera.eye.clone().requires_grad_(True)
    s = dataclasses.replace(
        scene, spectra=sp,
        primitives=dataclasses.replace(scene.primitives, data1=d1),
        camera=dataclasses.replace(scene.camera, eye=eye))
    img = kt.render_sample(s, W, H, 1, max_depth=DEPTH, static=static,
                           backward=backward)
    (img ** 2).sum().backward()
    return [x.grad.numpy() for x in (d1, sp, eye)]


@pytest.mark.parametrize("mesh_min,backward", [
    (256, "pallas"),        # triangle rows, the retrace backward
    (256, "pallas_taped"),  # triangle rows, the tape-fed backward
    (256, "replay"),        # triangle rows, the guided replay
    (16, "pallas"),         # a mesh part: the guided replay
])
def test_mesh_gradients_match_jax(reference, mesh_min, backward):
    scene, want = reference
    static = mk.SceneStatic.from_scene(scene, mesh_min=mesh_min)
    assert bool(static.mesh_parts) == (mesh_min == 16)
    assert static.categories.count(2) == (80 if mesh_min == 256 else 0)
    before = (mk.launches, mk.launches_mesh, mk.launches_taped,
              mk.launches_bwd, mk.launches_bwd_tape, mk.launches_winners)
    got = _grads(scene, static, backward)
    assert (mk.launches, mk.launches_mesh, mk.launches_taped,
            mk.launches_bwd, mk.launches_bwd_tape,
            mk.launches_winners) == before  # the CPU launches nothing
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3,
                                   atol=1e-4)
    assert np.abs(got[0][6:]).max() > 0


def test_mesh_part_backwards_agree(reference):
    """Every backward of a scene with a mesh part is the guided replay:
    "pallas_taped" gives "pallas"'s gradient bit for bit."""
    scene, _ = reference
    static = mk.SceneStatic.from_scene(scene, mesh_min=16)
    for a, b in zip(_grads(scene, static, "pallas"),
                    _grads(scene, static, "pallas_taped")):
        np.testing.assert_array_equal(a, b)


def test_cli_trains_mesh_scene(capsys):
    """The CLI fits the vertices of mesh_scene's 81,920-triangle mesh part
    (gradients through the guided replay) against a dimmed albedo."""
    from computeraytracer_tpu_torch import cli

    rc = cli.main(["train", "--preset", "mesh_scene", "--width", "8",
                   "--height", "8", "--spp", "1", "--depth", "2", "--steps",
                   "2", "--perturb-row", "0", "--trainable", "data1",
                   "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["steps"] == 2 and rec["final_loss"] < rec["initial_loss"]
