"""The tape-fed backward of the PyTorch port vs the JAX package's.

``backward="pallas_taped"``: under grad the forward writes every
bounce's input carry (``build_forward(taped="full")``) and the backward
sweeps that tape without a replay (``build_backward_from_tape``). The
port's plain versions, ``forward_taped_reference`` and
``backward_from_tape_reference``, are held against the JAX kernels in
Pallas interpret mode on identical inputs built with the JAX package's
own ray generation and hero gather:

- taped forward (Cornell box and ``simple_scene``, 256 rays, depth 3):
  radiance as tests/test_torch_megakernel.py holds the forward (at least
  99% of rays within rel 1e-4, denominator floored at 1e-2); the int
  planes of the tape (seed words, exclude, specular, in_trans, active)
  equal on at least 99% of rays and its float planes within rel 1e-4 on
  at least 99% of rays (the denominator floored at 1e-2 of the plane's
  largest magnitude, or at 1e-2 when that is below 1). Not every ray:
  exp, sin and cos differ by an ulp between the frameworks, so a rare
  sampling decision flips and sends that path elsewhere.
- tape-fed backward (``simple_scene`` and a glass variant, on the JAX
  tape): the tolerances of tests/test_torch_backward.py. Cornell's
  backward takes minutes in interpret mode and is held on the card
  (tests/test_torch_cuda.py, chip_smoke.py).
- against the port's own retrace backward: allclose at rtol 1e-5; only
  the order of the sums across bounces differs.
- end to end: the gradient of sum(render_sample ** 2) with respect to
  spectra and data1 against the JAX package's render_sample with
  backward="pallas_taped" (the pattern of tests/test_pallas.py:190-213:
  8x8, depth 2, rtol 1e-3 / atol 1e-5, data1 scaled by its largest
  entry).
"""

import dataclasses
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.kernels import megakernel as jmk
from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import data as jdata
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 32
R = 256
MAX_DEPTH = 3
RR_START = 1
CSRC = (pathlib.Path(__file__).resolve().parents[1]
        / "computeraytracer_tpu_torch" / "kernels" / "csrc")


def _doc(variant):
    if variant == "cornell":
        return jpresets.cornell_box(W, H)
    doc = jpresets.simple_scene(W, H)
    if variant == "glass":
        doc["objects"]["spheres"][0]["type"] = "glass"
    return doc


def _inputs(variant):
    """Kernel inputs for R random pixels, numpy, from the JAX package's
    own ray generation and hero gather."""
    js, _ = jax_scene_from_dict(_doc(variant))
    g = np.random.default_rng(0)
    px = g.integers(0, W, R).astype(np.uint32)
    py = g.integers(0, H, R).astype(np.uint32)
    sample = np.uint32(3)
    c = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, W, H,
                                      px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    spect = np.ascontiguousarray(np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)])
    return {
        "scene": js,
        "static": jmk.SceneStatic.from_scene(js),
        "prims": np.asarray(jmk.pack_prims(jdata.as_jax(js))),
        "rays": np.asarray(jnp.concatenate([o, d], axis=0)),
        "seeds": np.asarray(seed_p),
        "spect": spect,
        "dL": g.standard_normal((4, R)).astype(np.float32),
    }


def _planes(x):
    x = np.asarray(x)
    return jnp.asarray(x).reshape(x.shape[:-1] + (R // jmk.LANES, jmk.LANES))


def _torch_inputs(inp):
    return (mk.SceneStatic.from_scene(scene_from_jax(inp["scene"])),
            torch.from_numpy(inp["prims"].copy()),
            torch.from_numpy(inp["rays"].copy()),
            torch.from_numpy(inp["seeds"].astype(np.int64)),
            torch.from_numpy(inp["spect"].copy()))


def _jax_taped(inp):
    """The JAX taped="full" forward in interpret mode -> (radiance (4, R),
    tape_f (D, 16, R), tape_u (D, 4, R), tape_i (D, 4, R))."""
    fwd = jmk.build_forward(inp["static"], MAX_DEPTH, RR_START, tile_m=2,
                            interpret=True, taped="full")
    out = jax.block_until_ready(fwd(
        jnp.asarray(inp["prims"]), _planes(inp["rays"]),
        _planes(inp["seeds"]), _planes(inp["spect"])))
    return tuple(np.asarray(a).reshape(a.shape[:-2] + (R,)) for a in out)


@pytest.fixture(scope="module", params=["cornell", "simple"])
def taped_case(request):
    inp = _inputs(request.param)
    inp["jax"] = _jax_taped(inp)
    return inp


@pytest.fixture(scope="module", params=["simple", "glass"])
def tape_bwd_case(request):
    """The JAX tape and the JAX tape-fed backward on it (interpret mode);
    dL zeroed on rays whose forward radiance differs between the two
    frameworks (another path after a flipped sampling decision)."""
    inp = _inputs(request.param)
    rad, tf, tu, ti = _jax_taped(inp)
    inp["jax"] = (rad, tf, tu, ti)
    static, *tin = _torch_inputs(inp)
    port = mk.forward_reference(static, MAX_DEPTH, RR_START, *tin).numpy()
    rel = np.abs(port - rad) / np.maximum(np.abs(rad), 1e-6)
    inp["same_path"] = (rel <= 1e-4).all(axis=0)
    inp["dL"][:, ~inp["same_path"]] = 0.0
    bwd = jmk.build_backward_from_tape(inp["static"], MAX_DEPTH, RR_START,
                                       tile_m=2, interpret=True)
    dp, dr, ds = jax.block_until_ready(bwd(
        jnp.asarray(inp["prims"]), _planes(inp["spect"]), _planes(tf),
        _planes(tu), _planes(ti), _planes(inp["dL"])))
    inp["want"] = (np.asarray(dp), np.asarray(dr).reshape(6, R),
                   np.asarray(ds).reshape(-1, R))
    return inp


def _port_tape_from_jax(tf, tu, ti):
    """The JAX package's three tape arrays as the port's (tape_f, tape_i)."""
    f = torch.from_numpy(np.array(tf).reshape(-1, R))
    i = np.concatenate([np.asarray(tu).view(np.int32), ti], axis=1)
    return f, torch.from_numpy(np.ascontiguousarray(i).reshape(-1, R))


def test_taped_forward_matches_pallas(taped_case):
    static, *tin = _torch_inputs(taped_case)
    rad, tape_f, tape_i = mk.forward_taped_reference(static, MAX_DEPTH,
                                                     RR_START, *tin)
    D = MAX_DEPTH + 1
    assert tape_f.shape == (D * 16, R) and tape_f.dtype == torch.float32
    assert tape_i.shape == (D * 8, R) and tape_i.dtype == torch.int32
    # the untaped forward computes the same radiance
    assert torch.equal(rad, mk.forward_reference(static, MAX_DEPTH,
                                                 RR_START, *tin))
    j_rad, j_f, j_u, j_i = taped_case["jax"]
    rel = np.abs(rad.numpy() - j_rad) / np.maximum(np.abs(j_rad), 1e-2)
    assert (rel < 1e-4).all(axis=0).mean() >= 0.99
    p_f, p_u, p_i = mk.tape_to_jax(tape_f, tape_i)
    assert p_f.shape == j_f.shape and p_u.dtype == j_u.dtype == np.uint32
    assert p_i.shape == j_i.shape and p_i.dtype == j_i.dtype
    ints_equal = ((p_u == j_u).all(axis=(0, 1))
                  & (p_i == j_i).all(axis=(0, 1)))
    assert ints_equal.mean() >= 0.99, ints_equal.mean()
    # the forward's floor of 1e-2 is for values of order 1: scale it by
    # each plane's magnitude (Cornell coordinates reach 555, and XLA fuses
    # o + t*d into an FMA that leaves 7e-6 where the port rounds to 0)
    scale = np.maximum(np.abs(j_f).max(axis=(0, 2), keepdims=True), 1.0)
    rel_f = np.abs(p_f - j_f) / np.maximum(np.abs(j_f), 1e-2 * scale)
    assert (rel_f < 1e-4).all(axis=(0, 1)).mean() >= 0.99
    # every ray starts active; the last row of a ray that died is dead
    assert (p_i[0, 3] == 1).all()
    assert (p_i[:, 3] == j_i[:, 3]).all(axis=0).mean() >= 0.99


def test_dead_rows_hold_the_final_carry(taped_case):
    static, *tin = _torch_inputs(taped_case)
    _, tape_f, tape_i = mk.forward_taped_reference(static, MAX_DEPTH,
                                                   RR_START, *tin)
    f = tape_f.reshape(-1, 16, R)
    i = tape_i.reshape(-1, 8, R)
    for depth in range(1, MAX_DEPTH + 1):
        dead = i[depth - 1, 7] == 0
        assert torch.equal(f[depth][:, dead], f[depth - 1][:, dead])
        assert torch.equal(i[depth][:, dead], i[depth - 1][:, dead])
    # a live row's active flag never comes back once cleared
    assert (i[1:, 7] <= i[:-1, 7]).all()


def _assert_backward_close(got, want):
    for g in got:
        assert np.isfinite(g).all()
    scale = np.abs(want[0]).max()
    assert scale > 0
    np.testing.assert_allclose(got[0] / scale, want[0] / scale, rtol=1e-3,
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        den = np.maximum(np.abs(w), 1e-3 * np.abs(w).max())
        assert (np.abs(g - w) / den).max() < 1e-3


def test_backward_from_tape_matches_pallas(tape_bwd_case):
    case = tape_bwd_case
    assert case["same_path"].mean() >= 0.99
    static, prims, _, _, spect = _torch_inputs(case)
    tape_f, tape_i = _port_tape_from_jax(*case["jax"][1:])
    got = [x.numpy() for x in mk.backward_from_tape_reference(
        static, MAX_DEPTH, RR_START, prims, spect, tape_f, tape_i,
        torch.from_numpy(case["dL"]))]
    _assert_backward_close(got, case["want"])


@pytest.mark.parametrize("variant", ["cornell", "glass"])
def test_tape_fed_matches_retrace_reference(variant):
    inp = _inputs(variant)
    static, prims, rays, seeds, spect = _torch_inputs(inp)
    dL = torch.from_numpy(inp["dL"])
    _, tape_f, tape_i = mk.forward_taped_reference(static, MAX_DEPTH,
                                                   RR_START, prims, rays,
                                                   seeds, spect)
    got = mk.backward_from_tape_reference(static, MAX_DEPTH, RR_START,
                                          prims, spect, tape_f, tape_i, dL)
    want = mk.backward_reference(static, MAX_DEPTH, RR_START, prims, rays,
                                 seeds, spect, dL)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    assert float(got[0].abs().max()) > 0


def test_tracetapedfn_cpu_runs_the_tape_pair(monkeypatch):
    """Under grad: the taped forward once, the tape-fed backward once, no
    untaped forward and no retrace backward; the gradients are the
    plain tape-fed backward's."""
    inp = _inputs("simple")
    static, prims, rays, seeds, spect = _torch_inputs(inp)
    calls = []
    for name in ("forward", "forward_taped", "backward",
                 "backward_from_tape"):
        real = getattr(mk, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mk, name, spy)
    leaves = [x.clone().requires_grad_(True) for x in (prims, rays, spect)]
    out = mk.TraceTapedFn.apply(static, MAX_DEPTH, RR_START, leaves[0],
                                leaves[1], seeds, leaves[2])
    dL = torch.from_numpy(inp["dL"])
    out.backward(dL)
    assert calls == ["forward_taped", "backward_from_tape"]
    rad, tape_f, tape_i = mk.forward_taped_reference(static, MAX_DEPTH,
                                                     RR_START, prims, rays,
                                                     seeds, spect)
    assert torch.equal(out.detach(), rad)
    want = mk.backward_from_tape_reference(static, MAX_DEPTH, RR_START,
                                           prims, spect, tape_f, tape_i, dL)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)

    calls.clear()
    with torch.no_grad():
        plain = mk.TraceTapedFn.apply(static, MAX_DEPTH, RR_START,
                                      leaves[0], leaves[1], seeds, leaves[2])
    no_leaf = mk.TraceTapedFn.apply(static, MAX_DEPTH, RR_START, prims, rays,
                                    seeds, spect)
    assert calls == ["forward", "forward"]
    assert not plain.requires_grad and not no_leaf.requires_grad
    assert torch.equal(plain, rad) and torch.equal(no_leaf, rad)


@pytest.fixture(scope="module")
def simple_jax():
    return jax_scene_from_dict(jpresets.simple_scene(8, 8))[0]


def test_render_sample_taped_gradient_matches_jax(simple_jax):
    w = h = 8

    def loss_jax(spectra, data1):
        s = simple_jax._replace(
            spectra=spectra,
            primitives=simple_jax.primitives._replace(data1=data1))
        img = jax_pallas.render_sample(s, w, h, 1, max_depth=2,
                                       backward="pallas_taped", tile_m=1)
        return jnp.sum(img ** 2)

    want = [np.asarray(g) for g in jax.grad(loss_jax, argnums=(0, 1))(
        jnp.asarray(simple_jax.spectra),
        jnp.asarray(simple_jax.primitives.data1))]
    scene = scene_from_jax(simple_jax)
    sp = scene.spectra.clone().requires_grad_(True)
    d1 = scene.primitives.data1.clone().requires_grad_(True)
    s = dataclasses.replace(scene, spectra=sp, primitives=dataclasses.replace(
        scene.primitives, data1=d1))
    (kt.render_sample(s, w, h, 1, max_depth=2, backward="pallas_taped")
     ** 2).sum().backward()
    got = [sp.grad.numpy(), d1.grad.numpy()]
    for g in got:
        assert np.isfinite(g).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-5)
    scale = np.abs(want[1]).max()
    assert scale > 0
    np.testing.assert_allclose(got[1] / scale, want[1] / scale, rtol=1e-3,
                               atol=1e-5)


def test_backward_knob():
    scene, _ = scene_from_dict(presets.simple_scene(4, 4), device="cpu")
    sp = scene.spectra.clone().requires_grad_(True)
    s = dataclasses.replace(scene, spectra=sp)
    # backward="xla": the kernel path's forward, the eager backward
    eager = kt.render_sample(s, 4, 4, 1, max_depth=1, backward="xla")
    assert eager.requires_grad
    assert torch.equal(eager.detach(), kt.render_sample(
        s, 4, 4, 1, max_depth=1, backward="none"))
    with pytest.raises(ValueError, match="unknown backward"):
        kt.render_sample(s, 4, 4, 1, max_depth=1, backward="taped")
    plain = kt.render_sample(s, 4, 4, 1, max_depth=2, backward="none")
    assert not plain.requires_grad
    taped = kt.render_sample(s, 4, 4, 1, max_depth=2,
                             backward="pallas_taped")
    retrace = kt.render_sample(s, 4, 4, 1, max_depth=2)
    replay = kt.render_sample(s, 4, 4, 1, max_depth=2, backward="replay")
    assert taped.requires_grad and retrace.requires_grad
    assert replay.requires_grad
    assert torch.equal(taped.detach(), plain)
    assert torch.equal(retrace.detach(), plain)
    assert torch.equal(replay.detach(), plain)


def test_c_signatures_match_sources():
    """The ctypes argument kinds of every kernel entry point agree with
    its C declaration in csrc/ (a mismatch would cut a pointer to 32
    bits or shift every later argument on the card)."""
    found = {}
    for src in CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                             src.read_text(), re.S):
            args = [a.strip() for a in m.group(2).split(",")]
            found[m.group(1)] = "".join(
                "p" if "*" in a else ("q" if "long long" in a else
                                      "f" if a.startswith("float") else "i")
                for a in args)
    assert found == mk.SIGNATURES


@pytest.mark.parametrize("bad", ["tape_f_rows", "tape_i_dtype", "dL_shape",
                                 "spect_rays"])
def test_backward_from_tape_checks_inputs(bad):
    inp = _inputs("simple")
    static, prims, rays, seeds, spect = _torch_inputs(inp)
    _, tape_f, tape_i = mk.forward_taped_reference(static, MAX_DEPTH,
                                                   RR_START, prims, rays,
                                                   seeds, spect)
    dL = torch.from_numpy(inp["dL"])
    if bad == "tape_f_rows":
        tape_f = tape_f[:-16]
    elif bad == "tape_i_dtype":
        tape_i = tape_i.to(torch.int64)
    elif bad == "dL_shape":
        dL = dL[:3]
    else:
        spect = spect[:, :-1].contiguous()
    with pytest.raises(ValueError):
        mk.backward_from_tape(static, MAX_DEPTH, RR_START, prims, spect,
                              tape_f, tape_i, dL)


def test_cli_train_with_the_tape_fed_backward(capsys):
    """The CLI trains through either backward; the two agree to the order
    of the sums across bounces."""
    from computeraytracer_tpu_torch import cli

    common = ["train", "--width", "12", "--height", "12", "--spp", "1",
              "--depth", "2", "--steps", "3", "--device", "cpu"]
    runs = {}
    for bw in ("pallas", "pallas_taped"):
        assert cli.main(common + ["--backward", bw]) == 0
        runs[bw] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert runs["pallas_taped"]["final_loss"] < runs["pallas_taped"][
        "initial_loss"]
    for key in ("initial_loss", "final_loss"):
        np.testing.assert_allclose(runs["pallas_taped"][key],
                                   runs["pallas"][key], rtol=1e-4)
