"""The observability helpers of the PyTorch port (``utils/profiling.py``,
``utils/debug.py``) against tests/test_observability.py's cases.

The roofline's counts (flops, bytes) equal the JAX package's for the
same arguments; only the peak rates differ (the card's). ``trace``
writes a Chrome trace on the CPU. ``checked`` passes a clean eager render
and catches a NaN in the spectra, forward and backward.
``measure_mean_depth`` lands within 1% of the mean trips per ray of the
forward's tape (tests/test_torch_schedule.py holds that mean to the JAX
package's measure_mean_depth). ``detect_chip`` names the H100 and raises
on any other device or none.
"""

import dataclasses

import pytest
import torch

from computeraytracer_tpu.utils import profiling as jprofiling
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.utils import debug, profiling


@pytest.mark.parametrize("args,kw", [
    ((1024, 1024, 1, 8, 18), dict(mean_depth=3.0)),
    ((256, 256, 1, 4, 18), dict(backward=True)),
    ((64, 32, 4, 8, 5), dict(mean_depth=2.37, backward=True))])
def test_roofline_counts_match_jax(args, kw):
    got = profiling.roofline(*args, **kw)
    want = jprofiling.roofline(*args, **kw)
    assert got.flops == want.flops and got.hbm_bytes == want.hbm_bytes
    assert got.intensity == want.intensity


def test_roofline_sane():
    r = profiling.roofline(1024, 1024, 1, 8, 18, mean_depth=3.0)
    assert profiling.CHIP_PEAKS["h100"] == (989.0, 67.0, 3350.0)
    assert r.bound == "compute"  # path tracing is f32-bound
    assert r.sol_s == max(r.sol_compute_s, r.sol_memory_s)
    assert r.sol_compute_s == r.flops / 67e12
    assert 0 < r.fraction(r.sol_s * 10) < 1
    assert r.to_dict()["intensity"] == pytest.approx(r.intensity)
    bwd = profiling.roofline(256, 256, 1, 4, 18, backward=True)
    assert bwd.flops > profiling.roofline(256, 256, 1, 4, 18).flops


def test_trace_writes_profile(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), "cpu"):
        with profiling.annotate("tiny-matmul"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    files = list(logdir.glob("trace.*.json"))
    assert len(files) == 1
    assert "tiny-matmul" in files[0].read_text()


def _render(scene):
    return xla.render_sample(scene, 8, 8, 1, max_depth=2, use_remat=False)


@pytest.fixture(scope="module")
def cornell():
    return scene_from_dict(presets.cornell_box(8, 8), device="cpu")[0]


def test_checked_clean_render_passes(cornell):
    img = debug.checked(_render)(cornell)
    assert torch.isfinite(img).all()
    assert torch.equal(img, _render(cornell))


def test_checked_catches_nan(cornell):
    """A NaN in one spectra entry never reaches this image, but ops make
    it on the way, forward and (under detect_anomaly) backward."""
    bad = cornell.spectra.clone()
    bad[0, 0] = float("nan")
    scene = dataclasses.replace(cornell, spectra=bad)
    assert torch.isfinite(_render(scene)).all()
    with pytest.raises(debug.CheckError, match="nan"):
        debug.checked(_render)(scene)
    leaf = torch.zeros((), requires_grad=True)

    def backward_nan():  # finite forward; 0 * inf in sqrt's backward
        (torch.sqrt(leaf) * 0.0).backward()

    with pytest.raises(debug.CheckError, match="nan"):
        debug.checked(backward_nan)()
    assert issubclass(debug.CheckError, RuntimeError)


def test_measure_mean_depth_matches_tape():
    side = 16
    scene = scene_from_dict(presets.cornell_box(side, side), device="cpu")[0]
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(side, side, 0)
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, side, side, px,
                                                     py, 1))
    _, _, tape_i = mk.forward_taped_reference(static, 8, 1, *args)
    want = mk.trips_from_tape(tape_i).double().mean().item()
    got = profiling.measure_mean_depth(scene, side, side, sample=1,
                                       max_depth=8, rr_start=1)
    assert abs(got - want) <= 1e-2 * want, (got, want)


@pytest.mark.parametrize("name,want", [
    (None, None), ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100 80GB HBM3", "h100")])
def test_detect_chip(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: name is not None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    if want is None:
        with pytest.raises(ValueError, match="A100" if name else "no CUDA"):
            profiling.detect_chip()
    else:
        assert profiling.detect_chip() == want
