"""The reverse sweep shared by the port's two backward kernels.

On the card the retrace kernel launches the taped forward's kernel, then
the tape-fed kernel's reverse sweep (csrc/reverse.cuh sweep_kernel), so
both backward kernels end in the same sweep; its timed build adds each
section's cycles to a ``times`` tensor. Held here, on the CPU:

- the plain versions of both kernels against the JAX package's, run as
  tests/test_torch_backward.py and tests/test_torch_taped.py run them
  (``build_backward`` and ``build_backward_from_tape`` in Pallas interpret
  mode, 256 rays, depth 3), on two scenes beyond those files': "wide",
  ``simple_scene`` with a glass sphere and four more spectra, two of them
  read (S = 10, each ray's d_spect column 40 rows), and "mixed",
  ``simple_scene`` with a glass and a mirror sphere beside its diffuse
  rows and light. A ray whose forward radiance differs between the
  frameworks by more than rel 1e-4 took another path after a flipped
  sampling decision (exp, sin and cos differ by an ulp); it gets dL = 0
  on both sides. Tolerances are those files': d_prims within rtol 1e-3 /
  atol 1e-4 of its largest entry, d_rays and d_spect within rel 1e-3 of a
  denominator floored at 1e-3 of the plane's largest magnitude;
- the sections of the timed build (``mk.SWEEP_SECTIONS``) against the
  kernel's enum, and the wrappers' checks of ``times``: the plain
  versions time nothing, so a CPU call with ``times`` raises, as does a
  tensor of the wrong shape or type.

The card's kernels against these plain versions, and against each other,
are held in tests/test_torch_cuda.py and chip_smoke.py.
"""

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
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt

W = H = 32
R = 256
MAX_DEPTH = 3
RR_START = 1
REVERSE = (pathlib.Path(__file__).resolve().parents[1]
           / "computeraytracer_tpu_torch" / "kernels" / "csrc"
           / "reverse.cuh")


def test_sections_are_the_kernels():
    """mk.SWEEP_SECTIONS names the timed build's T_* counters in order."""
    enum = re.search(r"enum \{\s*(T_TAPE.*?)\};", REVERSE.read_text(), re.S)
    values = dict((k, int(v)) for k, v in re.findall(r"(T_\w+) = (\d+)",
                                                      enum.group(1)))
    names = {"T_TAPE": "tape_read", "T_SCAN": "scans",
             "T_RECOMP": "recompute_rest", "T_ADJOINT": "adjoint",
             "T_DSPECT": "d_spect", "T_FOLD": "fold", "T_OTHER": "other"}
    assert values.pop("T_KINDS") == len(mk.SWEEP_SECTIONS) == len(names)
    assert [names[k] for k in sorted(values, key=values.get)] == list(
        mk.SWEEP_SECTIONS)


@pytest.mark.parametrize("kernel", ["retrace", "tape_fed"])
@pytest.mark.parametrize("bad", ["cpu", "length", "dtype"])
def test_times_checks(kernel, bad):
    """times selects the card's timed build: on CPU tensors, or with a
    tensor of the wrong length or type, the wrapper raises."""
    scene, _ = scene_from_dict(presets.simple_scene(4, 4), device="cpu")
    static = mk.SceneStatic.from_scene(scene)
    n = len(mk.SWEEP_SECTIONS)
    times = {"cpu": torch.zeros(n, dtype=torch.int64),
             "length": torch.zeros(n + 1, dtype=torch.int64),
             "dtype": torch.zeros(n, dtype=torch.int32)}[bad]
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, 4, 4, *kt.tile_coords(4, 4, 0, "cpu"), 1), static)
    dL = torch.ones((4, args[1].shape[1]))
    with pytest.raises(ValueError):
        if kernel == "retrace":
            mk.backward(static, 2, 1, *args, dL, times=times)
        else:
            _, tape_f, tape_i = mk.forward_taped(static, 2, 1, *args)
            mk.backward_from_tape(static, 2, 1, args[0], args[3], tape_f,
                                  tape_i, dL, times=times)


def _doc(variant):
    doc = jpresets.simple_scene(W, H)
    doc["objects"]["spheres"][0]["type"] = "glass"
    if variant == "wide":
        doc["spectra"].update({
            f"pad{i}": {"wavelength": [400, 550, 700],
                        "value": [0.2 + 0.1 * i, 0.5, 0.6 - 0.1 * i]}
            for i in range(4)})
        doc["objects"]["patches"][0]["reflectance"] = "pad0"
        doc["objects"]["patches"][1]["reflectance"] = "pad1"
    else:
        doc["objects"]["spheres"].append({
            "center": [1.6, 0.6, 0.4], "radius": 0.55, "emission": "dark",
            "reflectance": "white", "type": "mirror"})
    return doc


def _planes(x):
    x = np.asarray(x)
    return jnp.asarray(x).reshape(x.shape[:-1] + (R // jmk.LANES, jmk.LANES))


def _torch_inputs(inp):
    return (mk.SceneStatic.from_scene(scene_from_jax(inp["scene"])),
            torch.from_numpy(inp["prims"].copy()),
            torch.from_numpy(inp["rays"].copy()),
            torch.from_numpy(inp["seeds"].astype(np.int64)),
            torch.from_numpy(inp["spect"].copy()))


def _case(variant):
    """Inputs for R random pixels from the JAX package's own ray
    generation and hero gather; the JAX taped forward, the JAX retrace
    backward and the JAX tape-fed backward on them (interpret mode), with
    dL zeroed on rays whose paths differ between the frameworks."""
    js, _ = jax_scene_from_dict(_doc(variant))
    g = np.random.default_rng(1)
    px = g.integers(0, W, R).astype(np.uint32)
    py = g.integers(0, H, R).astype(np.uint32)
    sample = np.uint32(2)
    c = jdata.as_jax(js).camera
    seed_p = jrng.seed_pixel_p(px, py, sample)
    o, d, seed_p = jcam.camera_rays_p(c.eye, c.lookat, c.up, c.fov, W, H,
                                      px, py, sample, seed_p)
    hero, seed_p = jspec.sample_wavelengths_p(seed_p)
    spect = np.ascontiguousarray(np.asarray(jspec.expand_hero_table(
        jnp.asarray(js.spectra)))[:, np.asarray(hero)])
    inp = {
        "scene": js,
        "prims": np.asarray(jmk.pack_prims(jdata.as_jax(js))),
        "rays": np.asarray(jnp.concatenate([o, d], axis=0)),
        "seeds": np.asarray(seed_p),
        "spect": spect,
        "dL": g.standard_normal((4, R)).astype(np.float32),
    }
    static = jmk.SceneStatic.from_scene(js)
    ops = [jnp.asarray(inp["prims"])] + [
        _planes(inp[k]) for k in ("rays", "seeds", "spect")]
    fwd = jmk.build_forward(static, MAX_DEPTH, RR_START, tile_m=2,
                            interpret=True, taped="full")
    rad, tf, tu, ti = (np.asarray(a).reshape(a.shape[:-2] + (R,))
                       for a in jax.block_until_ready(fwd(*ops)))
    inp["tape"] = (tf, tu, ti)
    static_t, *tin = _torch_inputs(inp)
    port = mk.forward_reference(static_t, MAX_DEPTH, RR_START, *tin).numpy()
    rel = np.abs(port - rad) / np.maximum(np.abs(rad), 1e-6)
    inp["same_path"] = (rel <= 1e-4).all(axis=0)
    inp["dL"][:, ~inp["same_path"]] = 0.0
    bwd = jmk.build_backward(static, MAX_DEPTH, RR_START, tile_m=2,
                             interpret=True)
    dp, dr, ds = jax.block_until_ready(bwd(*ops, _planes(inp["dL"])))
    inp["want_retrace"] = (np.asarray(dp), np.asarray(dr).reshape(6, R),
                           np.asarray(ds).reshape(-1, R))
    bwd_t = jmk.build_backward_from_tape(static, MAX_DEPTH, RR_START,
                                         tile_m=2, interpret=True)
    dp, dr, ds = jax.block_until_ready(bwd_t(
        jnp.asarray(inp["prims"]), _planes(inp["spect"]), _planes(tf),
        _planes(tu), _planes(ti), _planes(inp["dL"])))
    inp["want_tape"] = (np.asarray(dp), np.asarray(dr).reshape(6, R),
                        np.asarray(ds).reshape(-1, R))
    return inp


@pytest.fixture(scope="module", params=["wide", "mixed"])
def case(request):
    inp = _case(request.param)
    inp["variant"] = request.param
    return inp


def _assert_close(got, want):
    for g in got:
        assert np.isfinite(g).all()
    scale = np.abs(want[0]).max()
    assert scale > 0
    np.testing.assert_allclose(got[0] / scale, want[0] / scale, rtol=1e-3,
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        den = np.maximum(np.abs(w), 1e-3 * np.abs(w).max())
        assert (np.abs(g - w) / den).max() < 1e-3


def _check_scene(case, static, d_spect):
    """The scene is the one the variant names, and the rows that make it
    so carry gradient."""
    if case["variant"] == "wide":
        assert static.n_spectra == 10
        # the floor's and the back wall's reflectances are added rows
        for row in (static.reflectance_idx[0], static.reflectance_idx[1]):
            assert np.abs(d_spect[4 * row:4 * row + 4]).max() > 0
    else:
        assert set(static.materials) >= {0, 1, 2, 3}  # diffuse .. mirror
    # Beer-Lambert reached the extinction row (the last spectrum)
    assert np.abs(d_spect[-4:]).max() > 0


def test_backward_reference_matches_pallas(case):
    assert case["same_path"].mean() >= 0.99
    static, *tin = _torch_inputs(case)
    got = [x.numpy() for x in mk.backward_reference(
        static, MAX_DEPTH, RR_START, *tin, torch.from_numpy(case["dL"]))]
    _assert_close(got, case["want_retrace"])
    _check_scene(case, static, got[2])


def test_backward_from_tape_reference_matches_pallas(case):
    assert case["same_path"].mean() >= 0.99
    static, prims, _, _, spect = _torch_inputs(case)
    tf, tu, ti = case["tape"]
    tape_f = torch.from_numpy(np.array(tf).reshape(-1, R))
    tape_i = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.asarray(tu).view(np.int32), ti], axis=1)).reshape(-1, R))
    got = [x.numpy() for x in mk.backward_from_tape_reference(
        static, MAX_DEPTH, RR_START, prims, spect, tape_f, tape_i,
        torch.from_numpy(case["dL"]))]
    _assert_close(got, case["want_tape"])
    _check_scene(case, static, got[2])
