"""The port's BVH: builders (``bvh/builder.py``, ``native/``) and the
traversal (``bvh/traverse.py``).

- The NumPy builder's arrays equal the JAX package's bit for bit, and the
  native build's equal the JAX package's native build.
- The partition and bounds invariants (tests/test_bvh.py:29-40).
- ``intersect_bvh`` against ``intersect_brute``: hit flags and winners
  equal, t within rtol 1e-5 / atol 1e-4 (tests/test_bvh.py:74), on
  Cornell and a small mesh, with exclusion; winners equal to the JAX
  ``intersect_bvh``'s.
- A BVH render against brute force within rtol 1e-4 / atol 1e-5, and
  gradients through the BVH within rtol 1e-3 (tests/test_bvh.py:108,
  :125).
- The native loader builds into its own directory through a per-process
  temporary file; ``scene_bvh(backend="auto")`` falls back to NumPy when
  it fails, ``backend="native"`` raises.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu import bvh as jbvh
from computeraytracer_tpu import native as jnative
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch import native
from computeraytracer_tpu_torch.bvh import builder, traverse
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import xla

SCENES = {"mesh": lambda: jpresets.mesh_scene(32, 32, subdivisions=2),
          "cornell": lambda: jpresets.cornell_box(32, 32)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    js = jax_scene_from_dict(SCENES[request.param]())[0]
    return dict(name=request.param, js=js,
                ts=scene_from_jax(js, device="cpu"))


def _host(scene):
    p = scene.primitives
    return tuple(np.asarray(x) for x in (p.category, p.data1, p.data2,
                                         p.data3))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_builds_equal_jax(case, backend):
    got = builder.scene_bvh(case["ts"], backend=backend)
    if backend == "numpy":
        want = jbvh.builder.build_bvh(*_host(case["js"]))
    else:
        want = jnative.build_bvh_native(*_host(case["js"]))
    assert got.n_nodes == want.n_nodes > 1
    for name in builder.BVHArrays._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_partition_and_bounds(case, backend):
    bvh = builder.scene_bvh(case["ts"], backend=backend)
    leaf = bvh.leaf_prims
    n = case["ts"].primitives.count
    assert sorted(leaf[leaf >= 0].tolist()) == list(range(n))
    assert (bvh.miss >= 0).all() and (bvh.miss <= bvh.n_nodes).all()
    assert (bvh.miss > np.arange(bvh.n_nodes)).all()
    lo, hi = builder.primitive_bounds(*_host(case["js"]))
    for node in range(bvh.n_nodes):
        pids = leaf[node][leaf[node] >= 0]
        if len(pids):
            assert (bvh.bbox_min[node] <= lo[pids].min(0) + 1e-4).all()
            assert (bvh.bbox_max[node] >= hi[pids].max(0) - 1e-4).all()


def _random_rays(scene, n, seed):
    r = np.random.default_rng(seed)
    d1 = scene.primitives.data1.numpy()
    o = r.uniform(d1.min(0) - 50.0, d1.max(0) + 50.0,
                  size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("exclude", [False, True])
def test_traversal_matches_brute(case, exclude):
    ts = case["ts"]
    n = 512
    o, d = _random_rays(ts, n, seed=2 + exclude)
    ex = (torch.from_numpy(np.random.default_rng(3).integers(
        0, ts.primitives.count, n)) if exclude
        else torch.full((n,), -1, dtype=torch.int64))
    bvh = builder.scene_bvh(ts)
    traverse.step_log = []
    try:
        fast = traverse.intersect_bvh(o, d, ex, ts.primitives, bvh)
        steps = traverse.step_log
    finally:
        traverse.step_log = None
    brute = isect.intersect_brute(o, d, ex, ts.primitives)
    assert len(steps) == 1 and steps[0] > 0
    hit = brute.hit.numpy()
    assert 0.05 < hit.mean()
    np.testing.assert_array_equal(fast.hit.numpy(), hit)
    np.testing.assert_array_equal(fast.index.numpy()[hit],
                                  brute.index.numpy()[hit])
    np.testing.assert_allclose(fast.t.numpy()[hit], brute.t.numpy()[hit],
                               rtol=1e-5, atol=1e-4)
    # the JAX traversal picks the same winners
    jhit = jbvh.intersect_bvh(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(ex.numpy().astype(np.int32)),
        jdata.as_jax(case["js"]).primitives, jbvh.scene_bvh(case["js"]))
    np.testing.assert_array_equal(fast.index.numpy(), np.asarray(jhit.index))


@pytest.mark.parametrize("check_every", [1, 1000])
def test_compaction_keeps_winners(case, monkeypatch, check_every):
    """The host check's period and the compaction it allows change no
    winner (a ray that escaped no longer changes)."""
    ts = case["ts"]
    o, d = _random_rays(ts, 256, seed=4)
    ex = torch.full((256,), -1, dtype=torch.int64)
    bvh = builder.scene_bvh(ts)
    want = traverse.intersect_bvh(o, d, ex, ts.primitives, bvh)
    monkeypatch.setattr(traverse, "CHECK_EVERY", check_every)
    got = traverse.intersect_bvh(o[:, None], d[:, None], ex[:, None],
                                 ts.primitives, bvh)
    assert got.index.shape == (256, 1)
    assert torch.equal(got.index[:, 0], want.index)
    assert torch.equal(got.t[:, 0], want.t)


def test_bvh_render_matches_brute():
    js = jax_scene_from_dict(SCENES["mesh"]())[0]
    ts = scene_from_jax(js, device="cpu")
    bvh = builder.to_device(jbvh.scene_bvh(js), "cpu")  # a JAX-built BVH
    assert bvh.bbox_min.dtype == torch.float32
    assert bvh.leaf_prims.dtype == torch.int32
    want = xla.render_sample(ts, 16, 16, 1, max_depth=3)
    got = xla.render_sample(ts, 16, 16, 1, max_depth=3, bvh=bvh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    acc = xla.render_accumulate(ts, 8, 8, 2, max_depth=2, bvh=bvh)
    np.testing.assert_allclose(
        acc.numpy(), xla.render_accumulate(ts, 8, 8, 2, 2).numpy(),
        rtol=1e-4, atol=1e-5)


def test_gradients_through_bvh():
    js = jax_scene_from_dict(SCENES["mesh"]())[0]
    ts = scene_from_jax(js, device="cpu")
    bvh = builder.scene_bvh(ts)
    grads = []
    for b in (bvh, None):
        sp = ts.spectra.clone().requires_grad_(True)
        d1 = ts.primitives.data1.clone().requires_grad_(True)
        s = dataclasses.replace(ts, spectra=sp, primitives=dataclasses.replace(
            ts.primitives, data1=d1))
        (xla.render_sample(s, 8, 8, 1, max_depth=2, bvh=b) ** 2
         ).sum().backward()
        grads.append((sp.grad.numpy(), d1.grad.numpy()))
    for g_bvh, g_brute in zip(*grads):
        assert np.isfinite(g_bvh).all() and np.abs(g_brute).max() > 0
        scale = np.abs(g_brute).max()
        np.testing.assert_allclose(g_bvh / scale, g_brute / scale,
                                   rtol=1e-3, atol=1e-6)


def test_native_builds_into_its_own_directory(tmp_path, monkeypatch):
    import subprocess

    calls = []
    run = subprocess.run

    def record(cmd, **kw):
        calls.append(list(cmd))
        return run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "libcrtbvh.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", record)
    assert native.available()
    (cmd,) = calls
    out = cmd[cmd.index("-o") + 1]
    assert out == str(tmp_path / "build" / f"libcrtbvh.{os.getpid()}.tmp")
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        "libcrtbvh.so"]
    # loaded once per process: a second call compiles nothing
    assert native.available() and len(calls) == 1


def test_scene_bvh_backends(monkeypatch):
    ts = scene_from_jax(jax_scene_from_dict(SCENES["cornell"]())[0],
                        device="cpu")

    def broken(*a, **k):
        raise RuntimeError("no toolchain")

    monkeypatch.setattr(native, "build_bvh_native", broken)
    monkeypatch.setattr(builder, "NATIVE_MIN", 0)
    with pytest.raises(RuntimeError, match="no toolchain"):
        builder.scene_bvh(ts, backend="native")
    got = builder.scene_bvh(ts, backend="auto")
    want = builder.build_bvh(*_host(ts))
    for name in builder.BVHArrays._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
