"""Per-lane ops of the PyTorch port vs the JAX package.

Inputs come from a NumPy seed and go to both packages. RNG streams,
wavelength draws, table gathers and resampled tables must be equal bit
for bit; float pipelines agree to rtol 1e-6 (transcendentals and the
order XLA picks for small dots differ by an ulp or so between the two
frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computeraytracer_tpu.ops import camera as jcam
from computeraytracer_tpu.ops import color as jcolor
from computeraytracer_tpu.ops import rng as jrng
from computeraytracer_tpu.ops import spectrum as jspec
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu_torch.ops import camera as tcam
from computeraytracer_tpu_torch.ops import color as tcolor
from computeraytracer_tpu_torch.ops import rng as trng
from computeraytracer_tpu_torch.ops import spectrum as tspec

N = 4096


def _u32(shape, seed):
    """Random u32 words covering the whole range (half are >= 2^31)."""
    g = np.random.default_rng(seed)
    return g.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(x):
    return torch.from_numpy(np.array(x).astype(np.int64))


def _same_words(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        np.int64))


def test_u32_inputs_cover_high_half():
    assert (_u32(N, 0) >= 2 ** 31).mean() > 0.4


def test_tea_bit_exact():
    a, b = _u32(N, 1), _u32(N, 2)
    _same_words(trng.tea(_t(a), _t(b)), jrng.tea(a, b))


@pytest.mark.parametrize("planar", [False, True])
def test_seed_pixel_bit_exact(planar):
    g = np.random.default_rng(3)
    px = g.integers(0, 4096, N).astype(np.uint32)
    py = g.integers(0, 4096, N).astype(np.uint32)
    sample = np.uint32(3_000_000_000)
    if planar:
        _same_words(trng.seed_pixel_p(_t(px), _t(py), int(sample)),
                    jrng.seed_pixel_p(px, py, sample))
    else:
        _same_words(trng.seed_pixel(_t(px), _t(py), int(sample)),
                    jrng.seed_pixel(px, py, sample))


@pytest.mark.parametrize("planar", [False, True])
def test_pcg4d_and_rand_bit_exact(planar):
    if planar:
        s = _u32((4, N), 4)
        got_u, got_s = trng.rand_p(_t(s))
        want_u, want_s = jrng.rand_p(jnp.asarray(s))
        _same_words(trng.pcg4d_p(_t(s)), jrng.pcg4d_p(jnp.asarray(s)))
    else:
        s = _u32((N, 4), 5)
        got_u, got_s = trng.rand(_t(s))
        want_u, want_s = jrng.rand(jnp.asarray(s))
        _same_words(trng.pcg4d(_t(s)), jrng.pcg4d(jnp.asarray(s)))
    _same_words(got_s, want_s)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


def test_rand_masked_bit_exact():
    s = _u32((N, 4), 6)
    mask = np.random.default_rng(7).random(N) < 0.5
    got_u, got_s = trng.rand_masked(_t(s), torch.from_numpy(mask))
    want_u, want_s = jrng.rand_masked(jnp.asarray(s), jnp.asarray(mask))
    _same_words(got_s, want_s)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    _same_words(got_s[~torch.from_numpy(mask)], s[~mask])


@pytest.mark.parametrize("planar", [False, True])
def test_sample_wavelengths_bit_exact(planar):
    if planar:
        s = _u32((4, N), 8)
        got_h, got_s = tspec.sample_wavelengths_p(_t(s))
        want_h, want_s = jspec.sample_wavelengths_p(jnp.asarray(s))
    else:
        s = _u32((N, 4), 9)
        got_h, got_s = tspec.sample_wavelengths(_t(s))
        want_h, want_s = jspec.sample_wavelengths(jnp.asarray(s))
    _same_words(got_h, want_h)
    _same_words(got_s, want_s)


def test_host_tables_bit_exact():
    np.testing.assert_array_equal(tspec.cie_1931_tables(),
                                  jspec.cie_1931_tables())
    wl, vals = [400, 455.5, 530, 700], [0.1, 0.7, 0.33, 0.9]
    np.testing.assert_array_equal(tspec.resample_spectrum(wl, vals),
                                  jspec.resample_spectrum(wl, vals))


def test_hero_tables_and_gather_bit_exact():
    scene, _ = jax_scene_from_dict(jpresets.cornell_box(8, 8))
    hero = np.random.default_rng(10).integers(0, 301, N)
    for jfn, tfn, table in (
            (jspec.expand_hero_table, tspec.expand_hero_table, scene.spectra),
            (jspec.cie_window_exp, tspec.cie_window_exp, scene.cie)):
        want = np.asarray(jfn(jnp.asarray(table)))
        got = tfn(torch.from_numpy(table))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tspec.gather_hero(got, torch.from_numpy(hero)).numpy(),
            want[:, hero])


def test_sqrt_correctly_rounded():
    x = np.random.default_rng(11).random(1 << 16).astype(np.float32) * 7
    np.testing.assert_array_equal(tcam.sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def _camera(name="cornell_box", w=48, h=32):
    scene, _ = jax_scene_from_dict(getattr(jpresets, name)(w, h))
    c = scene.camera
    return (c.eye, c.lookat, c.up, c.fov), w, h


@pytest.mark.parametrize("name", ["cornell_box", "simple_scene"])
@pytest.mark.parametrize("planar", [False, True])
def test_camera_rays_allclose(name, planar):
    cam, w, h = _camera(name)
    g = np.random.default_rng(12)
    px = g.integers(0, w, N).astype(np.uint32)
    py = g.integers(0, h, N).astype(np.uint32)
    sample = 21
    tcam_args = tuple(torch.from_numpy(np.asarray(a)) for a in cam)
    jcam_args = tuple(jnp.asarray(a) for a in cam)
    if planar:
        seed = jrng.seed_pixel_p(px, py, np.uint32(sample))
        want = jcam.camera_rays_p(*jcam_args, w, h, px, py,
                                  np.uint32(sample), seed)
        got = tcam.camera_rays_p(*tcam_args, w, h, _t(px), _t(py), sample,
                                 _t(seed))
    else:
        seed = jrng.seed_pixel(px, py, np.uint32(sample))
        want = jcam.camera_rays(*jcam_args, w, h, px, py,
                                np.uint32(sample), seed)
        got = tcam.camera_rays(*tcam_args, w, h, _t(px), _t(py), sample,
                               _t(seed))
    for g_, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-7)
    _same_words(got[2], want[2])


def _spectral_inputs():
    g = np.random.default_rng(13)
    cie = jspec.cie_1931_tables()
    rad = (g.random((4, N)) * 3).astype(np.float32)
    hero = g.integers(0, 301, N)
    return cie, rad, hero


def test_spectral_to_xyz_p_allclose():
    cie, rad, hero = _spectral_inputs()
    cw = np.asarray(jspec.cie_window_exp(jnp.asarray(cie)))[:, hero]
    want = np.asarray(jspec.spectral_to_xyz_p(jnp.asarray(cw), rad))
    got = tspec.spectral_to_xyz_p(torch.from_numpy(cw), torch.from_numpy(rad))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_spectral_to_xyz_allclose():
    cie, rad, hero = _spectral_inputs()
    lam = np.stack([hero, (hero + 4) % 301, (hero + 8) % 301,
                    (hero + 12) % 301], -1)
    rad_r = np.ascontiguousarray(rad.T)
    want = np.asarray(jspec.spectral_to_xyz(jnp.asarray(cie), rad_r, lam))
    got = tspec.spectral_to_xyz(torch.from_numpy(cie),
                                torch.from_numpy(rad_r), torch.from_numpy(lam))
    # the JAX einsum may sum the four terms in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_xyz_to_srgb_allclose():
    xyz = np.random.default_rng(14).random((N, 3)).astype(np.float32)
    want = np.asarray(jcolor.xyz_to_srgb(xyz))
    got = tcolor.xyz_to_srgb(torch.from_numpy(xyz)).numpy()
    # XLA's CPU dot rounds the 3x3 product in its own order; the matrix
    # has negative entries, so near-cancelling channels carry an absolute
    # (not relative) difference of a few 1e-7 through tone map and gamma
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0
