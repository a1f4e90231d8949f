"""The observability helpers of the PyTorch port (``utils/profiling.py``,
``utils/debug.py``) against tests/test_observability.py's cases.

``trace`` writes a Chrome trace on the CPU, with an ``annotate`` span in
it (tests/test_torch_spans.py holds the port's spans). ``checked`` passes
a clean eager render and catches a NaN in the spectra, forward and
backward. ``measure_mean_depth`` lands within 1% of the mean trips per
ray of the forward's tape (tests/test_torch_schedule.py holds that mean
to the JAX package's measure_mean_depth).
"""

import dataclasses

import pytest
import torch

from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.utils import debug, profiling


def test_trace_writes_profile(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), "cpu"):
        with profiling.annotate("tiny-matmul"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    files = list(logdir.glob("trace.*.json"))
    assert len(files) == 1
    assert "crt:tiny-matmul" in files[0].read_text()


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
