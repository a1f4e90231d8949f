"""Sharded rendering and training of the PyTorch port (``parallel/``).

One spawn of four gloo ranks on the CPU (a file store in tmp_path, so
test workers never share a port) runs every sharded case and saves each
rank's results; the tests below read them. The parent process holds them
against:
- the port's single-process render: bit-equal for a dp-only mesh
  (4, 1), and bit-equal to the per-sample images summed in the grouping
  of the (2, 2) mesh, (s1+s2)+(s3+s4): seeds come from global pixel
  coordinates, and the all-reduce adds exact zeros;
- the JAX ``render_accumulate_sharded`` on the 8-device CPU mesh (4, 2),
  with tests/test_sharding.py's bounds (``_assert_mostly_equal``);
- the single-process gradients and the JAX sharded gradients, and (2, 2)
  against (4, 1), at tests/test_sharding.py's rtol 1e-4, atol 1e-7.

The ranks import no jax: this module imports it only inside the parent's
fixtures, so that a spawned rank, which imports this module to find its
function, pays for torch and the port alone.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch.bvh import builder as bvh_builder
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.parallel import distributed
from computeraytracer_tpu_torch.parallel import mesh as mesh_mod
from computeraytracer_tpu_torch.parallel import render_sharded as rsh
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import xla
from computeraytracer_tpu_torch.train import optimize as opt
from computeraytracer_tpu_torch.utils import read_png

WORLD = 4
SIDE, SPP, DEPTH = 16, 4, 3       # tests/test_sharding.py's render
GRAD_SPP, GRAD_DEPTH = 2, 2       # its gradient
LAYOUT_SPP = 4                    # its layout case
MESH_SCENE = (16, 2, 2)           # side, subdivisions, spp (eager, BVH)
KERNEL_MESH = (32, 2, 2, 64)      # side, subdivisions, spp, mesh_min
RTOL, ATOL = 1e-4, 1e-7


def _cornell():
    return scene_from_dict(presets.cornell_box(64, 64), device="cpu")[0]


def _mesh_scene(side, subdivisions):
    return scene_from_dict(presets.mesh_scene(side, side, subdivisions),
                           device="cpu")[0]


def _grad(loss_fn, scene, names, target):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in opt.split_scene(scene, names)[0].items()}
    loss = loss_fn(params, target, 1)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def _kernel_mesh_static(scene):
    return mk.SceneStatic.from_scene(scene, mesh_min=KERNEL_MESH[3])


def _rank(rank, store, out):
    """One rank of the spawned world: every sharded case, saved to out."""
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    distributed.initialize(f"file://{store}", WORLD, rank,
                           device_type="cpu")
    try:
        res = {}
        m22 = mesh_mod.make_mesh()
        res["default_shape"] = tuple(m22.shape)
        res["global_sp1"] = tuple(distributed.global_mesh(sp=1).shape)
        try:
            mesh_mod.make_mesh((3, 1))
        except ValueError:
            res["bad_shape_raised"] = True
        meshes = {"22": m22, "41": mesh_mod.make_mesh((4, 1))}
        scene = _cornell()
        for name, mesh in meshes.items():
            for kernel in ("xla", "pallas"):
                res[f"{kernel}_{name}"] = rsh.render_accumulate_sharded(
                    scene, SIDE, SIDE, SPP, mesh, max_depth=DEPTH,
                    kernel=kernel)
        side, sub, spp = MESH_SCENE
        ms = _mesh_scene(side, sub)
        res["bvh_22"] = rsh.render_accumulate_sharded(
            ms, side, side, spp, m22, max_depth=2, kernel="xla",
            bvh=bvh_builder.scene_bvh(ms, backend="numpy"))
        side, sub, spp, _ = KERNEL_MESH
        ks = _mesh_scene(side, sub)
        res["kmesh_41"] = rsh.render_accumulate_sharded(
            ks, side, side, spp, meshes["41"], max_depth=2, kernel="pallas",
            static=_kernel_mesh_static(ks))

        target = torch.zeros((SIDE, SIDE, 3))
        for kernel, names in (("xla", ("spectra",)),
                              ("pallas", ("spectra", "data1"))):
            loss_fn = opt.make_loss_fn(scene, SIDE, SIDE, GRAD_SPP,
                                       GRAD_DEPTH, mesh=m22, kernel=kernel)
            res[f"grad_{kernel}"] = _grad(loss_fn, scene, names, target)
        for name, mesh in meshes.items():
            loss_fn = opt.make_loss_fn(scene, SIDE, SIDE, LAYOUT_SPP,
                                       GRAD_DEPTH, mesh=mesh, kernel="xla")
            res[f"layout_{name}"] = _grad(loss_fn, scene, ("spectra",),
                                          target)[1]
        res["optimize"] = _optimize(scene, m22)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def _optimize(scene, mesh):
    """3 Adam steps of optimize(mesh=) recovering a dimmed spectrum."""
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, SIDE, SIDE, GRAD_SPP,
                                     GRAD_DEPTH, mesh=mesh)
    spectra = scene.spectra.clone()
    spectra[2] = spectra[2] * 0.3
    _, losses = opt.optimize(
        dataclasses.replace(scene, spectra=spectra), target, SIDE, SIDE,
        steps=3, learning_rate=0.05, spp=GRAD_SPP, max_depth=GRAD_DEPTH,
        mesh=mesh)
    return losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (one spawn of WORLD gloo ranks)."""
    tmp = tmp_path_factory.mktemp("world")
    mp.start_processes(_rank, args=(str(tmp / "store"), str(tmp)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The port's single-process renders: per-sample images and their
    sum in sample order, by kernel."""
    scene = _cornell()
    out = {}
    for kernel, render in (("xla", xla.render_sample),
                           ("pallas", kt.render_sample)):
        out[kernel] = [render(scene, SIDE, SIDE, s, DEPTH)
                       for s in range(1, SPP + 1)]
    out["accum_xla"] = xla.render_accumulate(scene, SIDE, SIDE, SPP, DEPTH)
    out["accum_pallas"] = kt.render_accumulate(scene, SIDE, SIDE, SPP,
                                               DEPTH)
    return out


def _assert_mostly_equal(got, want, frac=0.99, tol=1e-3, energy_frac=1e-3):
    """tests/test_sharding.py's comparison of a sharded render."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    close = (rel < tol).all(axis=-1)
    assert close.mean() >= frac, (
        f"only {close.mean():.4f} pixels match, worst rel {rel.max():.3g}")
    assert np.median(rel) < 1e-5
    div_energy = np.abs(got - want)[~close].sum()
    assert div_energy <= energy_frac * (np.abs(want).sum() + 1e-12)


def test_every_rank_holds_the_same_results(ranks):
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, ranks[0][k]), k
        assert r["optimize"] == ranks[0]["optimize"]


def test_make_mesh_shapes(ranks):
    assert ranks[0]["default_shape"] == (2, 2)
    assert ranks[0]["global_sp1"] == (4, 1)
    assert ranks[0]["bad_shape_raised"]
    for n, want in ((1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (6, (3, 2)),
                    (8, (4, 2))):
        assert mesh_mod.default_shape(n) == want


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_dp_only_bit_equal_to_single(ranks, single, kernel):
    got = ranks[0][f"{kernel}_41"]
    assert got.shape == (SIDE, SIDE, 3) and torch.isfinite(got).all()
    assert torch.equal(got, single[f"accum_{kernel}"])


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_dp_sp_bit_equal_to_grouped_sum(ranks, single, kernel):
    s = single[kernel]
    want = (s[0] + s[1]) + (s[2] + s[3])
    assert torch.equal(ranks[0][f"{kernel}_22"], want)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_sharded_render_matches_jax(ranks, kernel):
    import jax

    from computeraytracer_tpu.parallel import mesh as jmesh
    from computeraytracer_tpu.parallel import render_sharded as jrsh
    from computeraytracer_tpu.scene import presets as jpresets
    from computeraytracer_tpu.scene import scene_from_dict as jscene

    js = jscene(jpresets.cornell_box(64, 64))[0]
    mesh42 = jmesh.make_mesh(jax.devices()[:8], (4, 2))
    # the JAX package's default "xla" tracer: its Pallas kernel would run
    # in interpret mode, which the port's CPU tests do not run
    want = np.asarray(jrsh.render_accumulate_sharded(
        js, SIDE, SIDE, SPP, mesh42, max_depth=DEPTH))
    _assert_mostly_equal(ranks[0][f"{kernel}_22"].numpy(), want)


def test_sharded_bvh_render_equal_to_single(ranks):
    side, sub, spp = MESH_SCENE
    ms = _mesh_scene(side, sub)
    want = xla.render_accumulate(ms, side, side, spp, 2,
                                 bvh=bvh_builder.scene_bvh(ms,
                                                           backend="numpy"))
    assert torch.equal(ranks[0]["bvh_22"], want)


def test_sharded_kernel_mesh_render_equal_to_single(ranks):
    side, sub, spp, _ = KERNEL_MESH
    ks = _mesh_scene(side, sub)
    static = _kernel_mesh_static(ks)
    assert static.mesh_parts
    packs = kt.mesh_packs_for(ks, static)
    want = torch.zeros((3, side, side))
    for s in range(1, spp + 1):
        want = want + kt.render_sample_planar(ks, side, side, s, 2,
                                              static=static,
                                              mesh_packs=packs)
    assert torch.equal(ranks[0]["kmesh_41"], want.permute(1, 2, 0))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_sharded_gradient_matches_single(ranks, kernel):
    scene = _cornell()
    loss_s, got = ranks[0][f"grad_{kernel}"]
    loss_fn = opt.make_loss_fn(scene, SIDE, SIDE, GRAD_SPP, GRAD_DEPTH,
                               kernel=kernel)
    loss, want = _grad(loss_fn, scene, tuple(got),
                       torch.zeros((SIDE, SIDE, 3)))
    np.testing.assert_allclose(loss_s.item(), loss.item(), rtol=1e-6)
    for k in want:
        assert torch.count_nonzero(want[k]) > 0
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_sharded_gradient_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    from computeraytracer_tpu.parallel import mesh as jmesh
    from computeraytracer_tpu.scene import presets as jpresets
    from computeraytracer_tpu.scene import scene_from_dict as jscene
    from computeraytracer_tpu.train import optimize as jopt

    js = jscene(jpresets.cornell_box(64, 64))[0]
    params, static = jopt.split_scene(js, ("spectra",))
    mesh42 = jmesh.make_mesh(jax.devices()[:8], (4, 2))
    loss = jopt.make_loss_fn(static, SIDE, SIDE, GRAD_SPP, GRAD_DEPTH,
                             mesh=mesh42)
    want = jax.grad(loss)(params, jnp.zeros((SIDE, SIDE, 3), jnp.float32),
                          jnp.uint32(1))
    np.testing.assert_allclose(ranks[0]["grad_xla"][1]["spectra"].numpy(),
                               np.asarray(want["spectra"]),
                               rtol=RTOL, atol=ATOL)


def test_sharded_gradient_layout_independent(ranks):
    a, b = ranks[0]["layout_22"]["spectra"], ranks[0]["layout_41"]["spectra"]
    assert torch.count_nonzero(a) > 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_sharded_optimize_lowers_the_loss(ranks):
    losses = ranks[0]["optimize"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_initialize_single_process_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device_type="cpu") is False
    assert not torch.distributed.is_initialized()


def test_initialize_needs_address_and_count(monkeypatch, tmp_path):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="both a coordinator address"):
        distributed.initialize("localhost:29500", device_type="cpu")
    with pytest.raises(ValueError, match="both a coordinator address"):
        distributed.initialize(num_processes=2, device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="both a coordinator address"):
        distributed.initialize(process_id=0, device_type="cpu")
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize(f"file://{tmp_path}/s", 1, 0, "nccl",
                               device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(f"file://{tmp_path}/s", 1, 0)
    assert not torch.distributed.is_initialized()


def test_cli_render_sharded_equal_to_unsharded(tmp_path, capsys):
    out = {}
    for name, extra in (("plain", []), ("sharded", ["--sharded"])):
        path = str(tmp_path / f"{name}.png")
        assert cli.main(["render", "--width", "16", "--height", "16",
                         "--spp", "2", "--depth", "3", "--device", "cpu",
                         "--out", path, *extra]) == 0
        out[name] = read_png(path)
    assert not torch.distributed.is_initialized()
    assert out["plain"].shape == (16, 16, 3) and out["plain"].any()
    np.testing.assert_array_equal(out["sharded"], out["plain"])
    assert cli.main(["render", "--width", "16", "--height", "16", "--spp",
                     "2", "--depth", "2", "--device", "cpu", "--out",
                     str(tmp_path / "p.png"), "--sharded",
                     "--progressive", "1"]) == 0
    assert "--progressive ignores --sharded" in capsys.readouterr().err
