"""The forward slice of the PyTorch port end to end.

``tracer.api.render(kernel="pallas")`` of the port vs the JAX package's
``tracer.pallas.render_accumulate`` (Pallas interpret mode on the CPU)
on the Cornell box, plus the API's options, the CLI and the rule that
the port never imports jax.

Tolerance: at least 99% of pixels within rtol = atol = 2e-4 (the
Pallas-vs-XLA tolerance of tests/test_pallas.py) and the image mean
within 1e-3. Not every pixel: an ulp of difference in exp, sin or cos,
or an FMA that XLA fuses on the CPU, can flip a rare sampling decision
and send that pixel's path elsewhere.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.utils import RenderMeter, read_png, write_png

REPO = pathlib.Path(__file__).resolve().parents[1]
W = H = 16
SPP = 2
DEPTH = 4


@pytest.fixture(scope="module")
def jax_accum():
    js, _ = jax_scene_from_dict(jpresets.cornell_box(W, H))
    out = jax_pallas.render_accumulate(js, W, H, SPP, DEPTH)
    return np.asarray(jax.block_until_ready(out))


@pytest.fixture(scope="module")
def scene():
    return scene_from_dict(presets.cornell_box(W, H))[0]


@pytest.fixture(scope="module")
def port_out(scene):
    return api.render(scene, RenderConfig(width=W, height=H, spp=SPP,
                                          max_depth=DEPTH, kernel="pallas"))


def test_render_matches_jax_pallas(port_out, jax_accum):
    got = port_out["accum_xyz"].numpy()
    assert got.shape == jax_accum.shape == (H, W, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, jax_accum, rtol=2e-4, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels match"
    assert abs(got.mean() - jax_accum.mean()) <= 1e-3 * abs(jax_accum.mean())


def test_render_outputs(port_out):
    assert port_out["samples"] == SPP
    np.testing.assert_array_equal(port_out["mean_xyz"].numpy(),
                                  port_out["accum_xyz"].numpy()
                                  / np.float32(SPP))
    srgb = port_out["srgb"]
    assert srgb.shape == (H, W, 3)
    assert 0.0 <= float(srgb.min()) and float(srgb.max()) <= 1.0
    assert float(srgb.mean()) > 0.0


def test_default_config_runs_the_megakernel(scene):
    assert RenderConfig().kernel == "pallas"
    out = api.render(scene, width=8, height=4, spp=1, max_depth=1)
    assert out["accum_xyz"].shape == (4, 8, 3)


def test_xla_kernel_not_ported(scene):
    with pytest.raises(NotImplementedError, match="not ported"):
        api.render(scene, width=8, height=8, kernel="xla")


def test_ray_chunk_bands_match_whole_film(scene, port_out):
    banded = api.render(scene, RenderConfig(width=W, height=H, spp=SPP,
                                            max_depth=DEPTH, ray_chunk=W * 5))
    # per-ray work is independent of the band, and the sums run in the
    # same sample order
    assert torch.equal(banded["accum_xyz"], port_out["accum_xyz"])


def test_progressive_chunks_sum_to_one_shot(scene, port_out):
    a = kt.render_accumulate(scene, W, H, 1, DEPTH, first_sample=1)
    b = kt.render_accumulate(scene, W, H, 1, DEPTH, first_sample=2)
    # counter-based seeding: chunked accumulation is bit-identical
    assert torch.equal(a + b, port_out["accum_xyz"])


def test_render_sample_is_planar_transpose(scene):
    planar = kt.render_sample_planar(scene, W, H, 3, DEPTH)
    hwc = kt.render_sample(scene, W, H, 3, DEPTH)
    assert torch.equal(planar.permute(1, 2, 0), hwc)


def test_cpu_render_launches_no_kernel(scene):
    before = mk.launches
    kt.render_sample(scene, 8, 8, 1, 1)
    assert mk.launches == before


def test_cli_render_writes_png(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    metrics = tmp_path / "m.jsonl"
    rc = cli.main(["render", "--preset", "cornell_box", "--width", "12",
                   "--height", "8", "--spp", "2", "--depth", "2",
                   "--device", "cpu", "--out", str(out),
                   "--metrics", str(metrics)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (8, 12, 3) and img.max() > 0
    rec = json.loads(metrics.read_text().splitlines()[-1])
    assert rec["paths"] == 12 * 8 * 2 and rec["device"] == "cpu"
    assert "wrote" in capsys.readouterr().out


def test_cli_progressive_matches_one_shot(tmp_path):
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    common = ["render", "--width", "8", "--height", "8", "--spp", "3",
              "--depth", "2", "--device", "cpu"]
    assert cli.main(common + ["--out", str(a)]) == 0
    assert cli.main(common + ["--out", str(b), "--progressive", "2"]) == 0
    assert np.abs(read_png(str(a)).astype(int)
                  - read_png(str(b)).astype(int)).max() <= 1


@pytest.mark.parametrize("flag", [["--sharded"], ["--bvh", "on"],
                                  ["--profile", "trace_dir"]])
def test_cli_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["render", "--width", "4", "--height", "4", "--spp", "1",
                  "--device", "cpu", "--out", str(tmp_path / "x.png")]
                 + flag)


def test_cli_info(capsys):
    assert cli.main(["info", "--preset", "simple_scene"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["primitives"] == 4 and info["spheres"] == 1
    assert info["lights"] == 1 and info["resolution"] == [256, 256]


def test_png_and_meter(tmp_path):
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, torch.from_numpy(img))
    np.testing.assert_array_equal(
        read_png(path), np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8))
    meter = RenderMeter()
    meter.start()
    rec = meter.stop(paths=100, width=10)
    assert rec["paths"] == 100 and rec["width"] == 10
    assert meter.total_paths == 100


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "before = set(sys.modules)\n"
        "import computeraytracer_tpu_torch as p\n"
        "import computeraytracer_tpu_torch.__main__\n"
        "from computeraytracer_tpu_torch import cli, config\n"
        "from computeraytracer_tpu_torch.kernels import _build, megakernel\n"
        "from computeraytracer_tpu_torch.tracer import api, kernel\n"
        "from computeraytracer_tpu_torch.scene import presets\n"
        "from computeraytracer_tpu_torch.utils import image, metrics\n"
        "s, _ = p.scene_from_dict(presets.simple_scene(4, 4))\n"
        "api.render(s, width=4, height=4, spp=1, max_depth=1)\n"
        "new = set(sys.modules) - before\n"
        "assert not any(m.startswith(('jax.', 'jaxlib', 'computeraytracer_tpu.'))\n"
        "               for m in new), sorted(new)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result when there is no
    CUDA device (here) or no package beside it."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        if torch.cuda.is_available() and cwd == REPO:
            continue
        res = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
