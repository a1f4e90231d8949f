"""The eager tracer of the PyTorch port (``tracer/xla.py``) and its ops.

Each op against the JAX package's on random inputs made with numpy: the
JAX side runs under ``jax.disable_jit()``, op by op, so that XLA fuses
no multiply-add (``jnp.cross`` is jitted inside) and rounds as eager
torch does: bit-equal where no transcendental is involved, else within
rtol = atol = 1e-6. The einsum of ``spectral_to_xyz`` sums in another
order: rtol 1e-6.

Renders against the JAX ``tracer.xla`` (``render_sample``,
``render_accumulate``), the NumPy oracle ``tracer/reference_cpu.py`` and
the port's own kernel path, at the convention of
tests/test_torch_slice.py: at least 99% of pixels within rtol = atol =
2e-4 and the image mean within 1e-3; against the oracle with
tests/test_tracer_parity.py's limits (0.995 of pixels within rel 1e-3,
divergent energy at most 1e-3). Not every pixel: an ulp of difference
in exp, sin or cos can flip a rare sampling decision.

Then the API (``render(kernel="xla")``, banded and whole) and the CLI
(``--kernel xla``, ``--bvh``, ``--progressive``, ``train``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.ops import fresnel as jfr
from computeraytracer_tpu.ops import intersect as jisect
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import sampling as jsampling
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import reference_cpu as oracle
from computeraytracer_tpu.tracer import xla as jax_xla
from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.ops import fresnel as fr
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops import sampling
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.utils import read_png

N = 2048


def _unit(r, n):
    d = r.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    box = lambda: r.uniform(-2, 2, (N, 3)).astype(np.float32)  # noqa: E731
    return dict(o=box(), d=_unit(r, N), a=box(), b=box(), c=box(),
                n=_unit(r, N), x=r.normal(size=N).astype(np.float32),
                u=r.random(N).astype(np.float32),
                v=r.random(N).astype(np.float32),
                eta=np.where(r.random(N) < 0.5, 1.5, 1 / 1.5).astype(
                    np.float32),
                spectra=r.random((5, 301)).astype(np.float32),
                idx=r.integers(0, 5, N).astype(np.int32),
                lam=r.integers(0, 301, (N, 4)).astype(np.int32),
                rad=r.random((N, 4)).astype(np.float32))


def _cornell():
    return jax_scene_from_dict(jpresets.cornell_box(8, 8))[0]


# name -> (port call, JAX call, exact); each call takes the inputs dict
# (tensors for the port, arrays for JAX)
OPS = {
    "safe_normalize": (lambda i: isect.safe_normalize(i["a"]),
                       lambda i: jisect.safe_normalize(i["a"]), True),
    "safe_sqrt": (lambda i: isect.safe_sqrt(i["x"]),
                  lambda i: jisect.safe_sqrt(i["x"]), True),
    "patch_candidates": (
        lambda i: isect.patch_candidates(i["o"], i["d"], i["a"], i["b"],
                                         i["c"]),
        lambda i: jisect.patch_candidates(i["o"], i["d"], i["a"], i["b"],
                                          i["c"]), True),
    "sphere_candidates": (
        lambda i: isect.sphere_candidates(i["o"], i["d"], i["a"],
                                          i["x"].abs() + 0.1, 0.001,
                                          isect.INF),
        lambda i: jisect.sphere_candidates(i["o"], i["d"], i["a"],
                                           jnp.abs(i["x"]) + 0.1, 0.001,
                                           jisect.INF), True),
    "triangle_candidates": (
        lambda i: isect.triangle_candidates(i["o"], i["d"], i["a"], i["b"],
                                            i["c"]),
        lambda i: jisect.triangle_candidates(i["o"], i["d"], i["a"],
                                             i["b"], i["c"]), True),
    "power_heuristic": (
        lambda i: sampling.power_heuristic(1.0, i["u"], 1.0, i["v"] * 1e3),
        lambda i: jsampling.power_heuristic(1.0, i["u"], 1.0,
                                            i["v"] * 1e3), True),
    "cosine_hemisphere": (
        lambda i: sampling.cosine_hemisphere(i["n"], i["u"], i["v"]),
        lambda i: jsampling.cosine_hemisphere(i["n"], i["u"], i["v"]),
        False),
    "pick_light": (lambda i: sampling.pick_light(i["u"], 3),
                   lambda i: jsampling.pick_light(i["u"], 3), True),
    "point_on_light": (
        lambda i: sampling.point_on_light(i["a"], i["b"], i["c"], i["u"],
                                          i["v"]),
        lambda i: jsampling.point_on_light(i["a"], i["b"], i["c"], i["u"],
                                           i["v"]), True),
    "light_solid_angle_pdf": (
        lambda i: sampling.light_solid_angle_pdf(i["a"], i["b"], 2, i["n"],
                                                 i["d"], i["c"], i["o"]),
        lambda i: jsampling.light_solid_angle_pdf(i["a"], i["b"], 2, i["n"],
                                                  i["d"], i["c"], i["o"]),
        True),
    "fresnel_s": (lambda i: fr.fresnel_s(i["d"], i["n"], 1.0, 1.5),
                  lambda i: jfr.fresnel_s(i["d"], i["n"], 1.0, 1.5), True),
    "reflect": (lambda i: fr.reflect(i["d"], i["n"]),
                lambda i: jfr.reflect(i["d"], i["n"]), True),
    "refract": (lambda i: fr.refract(i["d"], i["n"], i["eta"]),
                lambda i: jfr.refract(i["d"], i["n"], i["eta"]), True),
    "sample_spectrum": (
        lambda i: spec.sample_spectrum(i["spectra"], i["idx"],
                                       i["lam"].long()),
        lambda i: jspec.sample_spectrum(i["spectra"], i["idx"], i["lam"]),
        True),
    "spectral_to_xyz": (
        lambda i: spec.spectral_to_xyz(
            torch.from_numpy(jspec.cie_1931_tables()), i["rad"],
            i["lam"].long()),
        lambda i: jspec.spectral_to_xyz(jspec.cie_1931_tables(), i["rad"],
                                        i["lam"]), False),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    port_fn, jax_fn, exact = OPS[name]
    inputs = _inputs()
    got = _as_tuple(port_fn({k: torch.from_numpy(v)
                             for k, v in inputs.items()}))
    with jax.disable_jit():
        want = _as_tuple(jax_fn(inputs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if exact or g.dtype == bool or not np.issubdtype(g.dtype,
                                                         np.floating):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_sample_wavelengths_matches_jax():
    px = np.arange(N, dtype=np.uint32)
    seed = np.asarray(jrng.seed_pixel(px, px[::-1].copy(), np.uint32(3)))
    lam, new_seed = spec.sample_wavelengths(
        torch.from_numpy(seed.astype(np.int64)))
    jlam, jseed = jspec.sample_wavelengths(seed)
    np.testing.assert_array_equal(lam.numpy(), np.asarray(jlam))
    np.testing.assert_array_equal(new_seed.numpy(), np.asarray(jseed))


@pytest.mark.parametrize("exclude", [False, True])
def test_scene_intersection_matches_jax(exclude):
    """scene_candidates, shading_normal and intersect_brute on Cornell
    (patches, spheres, the light coplanar with the ceiling)."""
    js = _cornell()
    prims = scene_from_jax(js, device="cpu").primitives
    r = np.random.default_rng(1)
    o = r.uniform(50, 500, (N, 3)).astype(np.float32)
    d = _unit(r, N)
    ex = (r.integers(0, prims.count, N) if exclude
          else np.full(N, -1)).astype(np.int32)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, ok = isect.scene_candidates(to, td, prims)
    hit = isect.intersect_brute(to, td, torch.from_numpy(ex).long(), prims)
    with jax.disable_jit():
        jt, jok = jisect.scene_candidates(o, d, js.primitives)
        jhit = jisect.intersect_brute(o, d, ex, js.primitives)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(t.numpy()[ok.numpy()],
                                  np.asarray(jt)[np.asarray(jok)])
    assert 0.3 < float(hit.hit.float().mean()) < 1.0
    for name in isect.Hit._fields:
        np.testing.assert_array_equal(getattr(hit, name).numpy(),
                                      np.asarray(getattr(jhit, name)),
                                      err_msg=name)


def _close(got, want):
    close = np.isclose(got, want, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert np.isfinite(got).all()
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels match"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


SCENES = {"simple_scene": (24, 4), "cornell_box": (24, 8)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    side, depth = SCENES[request.param]
    js = jax_scene_from_dict(getattr(jpresets, request.param)(side, side))[0]
    return dict(name=request.param, side=side, depth=depth, js=js,
                ts=scene_from_jax(js, device="cpu"))


def test_render_sample_matches_jax(case):
    side, depth = case["side"], case["depth"]
    want = np.asarray(jax_xla.render_sample(case["js"], side, side, 2,
                                            depth))
    got = xla.render_sample(case["ts"], side, side, 2, depth)
    assert got.shape == (side, side, 3)
    _close(got.numpy(), want)


def test_render_accumulate_matches_jax(case):
    side = 16
    want = np.asarray(jax_xla.render_accumulate(
        case["js"], side, side, 2, case["depth"], first_sample=3))
    got = xla.render_accumulate(case["ts"], side, side, 2, case["depth"],
                                first_sample=3)
    _close(got.numpy(), want)


def test_render_matches_kernel_path(case):
    side, depth = 16, case["depth"]
    got = xla.render_sample(case["ts"], side, side, 1, depth)
    want = kt.render_sample(case["ts"], side, side, 1, depth)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("preset,side,sample,depth", [
    ("simple_scene", 24, 1, 2),
    ("cornell_box", 20, 1, 5),
    ("cornell_box", 12, 7, 8),
])
def test_render_matches_reference_cpu(preset, side, sample, depth):
    js = jax_scene_from_dict(getattr(jpresets, preset)(64, 64))[0]
    want = oracle.render_sample(js, side, side, sample, depth)
    got = xla.render_sample(scene_from_jax(js, device="cpu"), side, side,
                            sample, depth).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    close = (rel < 1e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} match"
    div_energy = np.abs(got - want)[~close].sum()
    assert div_energy <= 1e-3 * (np.abs(want).sum() + 1e-12)


def test_stratified_false_changes_only_the_jitter(case):
    side, depth = 8, case["depth"]
    want = np.asarray(jax_xla.render_sample(case["js"], side, side, 1,
                                            depth, stratified=False))
    got = xla.render_sample(case["ts"], side, side, 1, depth,
                            stratified=False).numpy()
    _close(got, want)
    assert not np.array_equal(
        got, xla.render_sample(case["ts"], side, side, 1, depth).numpy())


def test_api_render_xla(case):
    side, depth = 16, case["depth"]
    cfg = RenderConfig(width=side, height=side, spp=2, max_depth=depth,
                       kernel="xla")
    out = api.render(case["ts"], cfg)
    want = xla.render_accumulate(case["ts"], side, side, 2, depth)
    assert torch.equal(out["accum_xyz"], want)
    assert out["samples"] == 2 and out["srgb"].shape == (side, side, 3)
    banded = api.render(case["ts"], cfg.replace(ray_chunk=side * 5))
    # per-ray work does not depend on the band, and the samples are
    # summed in the same order
    assert torch.equal(banded["accum_xyz"], out["accum_xyz"])
    one = api.render_sample(case["ts"], side, side, 1, depth, kernel="xla")
    assert torch.equal(one, xla.render_sample(case["ts"], side, side, 1,
                                              depth))


def test_unknown_vis_grads_and_depth_skip():
    s = scene_from_jax(_cornell(), device="cpu")
    with pytest.raises(ValueError, match="unknown vis_grads"):
        xla.render_sample(s, 4, 4, 1, vis_grads=("sky",))
    # a domain name alone is one domain; its image is the unstratified one
    assert torch.equal(xla.render_sample(s, 4, 4, 1, vis_grads="light"),
                       xla.render_sample(s, 4, 4, 1, stratified=False))
    # rays that all left the scene end the bounce loop early: depth 50
    # gives what depth 50 gives without the skip, i.e. depth 50 of JAX
    px, py = xla.tile_coords(4, 4, 0)
    got = xla.render_pixels(s, 4, 4, px, py, 1, max_depth=50)
    want = np.asarray(jax_xla.render_sample(_cornell(), 4, 4, 1, 50))
    _close(got.numpy(), want.reshape(-1, 3))


@pytest.mark.parametrize("extra", [[], ["--progressive", "1"]])
def test_cli_render_xla_with_bvh(tmp_path, capsys, extra):
    out = tmp_path / "x.png"
    rc = cli.main(["render", "--kernel", "xla", "--bvh", "on", "--width",
                   "8", "--height", "6", "--spp", "2", "--depth", "2",
                   "--device", "cpu", "--out", str(out)] + extra)
    assert rc == 0
    assert read_png(str(out)).shape == (6, 8, 3)
    err = capsys.readouterr().err
    assert "BVH:" in err and "nodes over 18 primitives" in err


def test_cli_train_xla(capsys):
    rc = cli.main(["train", "--kernel", "xla", "--width", "8", "--height",
                   "8", "--spp", "1", "--depth", "2", "--steps", "3",
                   "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["steps"] == 3 and rec["final_loss"] < rec["initial_loss"]
