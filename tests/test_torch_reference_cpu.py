"""The port's scalar oracle (``tracer/reference_cpu.py``).

Bit-equal to the JAX package's oracle (both NumPy, the same scalar
control flow and python-int RNG streams) on the same scene, then the
port's eager tracer (``tracer/xla.py``) against the port's oracle with
tests/test_tracer_parity.py's limits: at least 0.995 of pixels within
rel 1e-3 (denominator floored at 1e-2) and the divergent pixels' energy
at most 1e-3 of the image's; the kernel path (the plain versions here)
at chip_smoke.py phase 28's cell, Cornell 16^2, depth 5, sample 1, with
the same limits.
"""

import numpy as np
import pytest

from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import reference_cpu as jax_oracle
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import reference_cpu as oracle
from computeraytracer_tpu_torch.tracer import xla


def _scenes(preset):
    js = jax_scene_from_dict(getattr(jpresets, preset)(64, 64))[0]
    return js, scene_from_jax(js, device="cpu")


@pytest.mark.parametrize("preset", ["simple_scene", "cornell_box"])
@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("sample", [1, 7])
def test_oracle_bit_equal_to_jax(preset, depth, sample):
    js, ts = _scenes(preset)
    want = jax_oracle.render_sample(js, 8, 8, sample, depth)
    got = oracle.render_sample(ts, 8, 8, sample, depth)
    assert got.dtype == np.float32 and got.shape == (8, 8, 3)
    assert np.isfinite(got).all() and np.abs(got).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_rng_streams_match_jax():
    for px, py, s in ((0, 0, 1), (5, 3, 7), (1023, 1023, 4096)):
        a, b = oracle.Pcg4dRng(px, py, s), jax_oracle.Pcg4dRng(px, py, s)
        assert [a.rand() for _ in range(16)] == [b.rand() for _ in range(16)]
    assert oracle.tea(123, 456) == jax_oracle.tea(123, 456)


def _assert_matches_oracle(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    close = (rel < 1e-3).all(axis=-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} match"
    div_energy = np.abs(got - want)[~close].sum()
    assert div_energy <= 1e-3 * (np.abs(want).sum() + 1e-12)


@pytest.mark.parametrize("preset,side,sample,depth", [
    ("simple_scene", 24, 1, 2),
    ("cornell_box", 20, 1, 5),
    ("cornell_box", 12, 7, 8),
])
def test_eager_tracer_matches_oracle(preset, side, sample, depth):
    _, ts = _scenes(preset)
    _assert_matches_oracle(
        xla.render_sample(ts, side, side, sample, depth).numpy(),
        oracle.render_sample(ts, side, side, sample, depth))


def test_kernel_path_matches_oracle():
    _, ts = _scenes("cornell_box")
    _assert_matches_oracle(kt.render_sample(ts, 16, 16, 1, 5).numpy(),
                           oracle.render_sample(ts, 16, 16, 1, 5))
