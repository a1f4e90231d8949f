"""Training slice of the PyTorch port vs the JAX package's.

Gradients of a render through ``tracer.kernel.render_sample`` (the
``TraceFn`` autograd Function, whose CPU backward is autograd of the
plain forward) are held against ``tracer/pallas.py`` with
``backward="pallas"`` (the backward megakernel in interpret mode), and
``train.optimize`` against the JAX ``optimize(kernel="pallas")``, on
``simple_scene`` and a variant whose sphere is glass. Both sides get the
same scene numbers (``scene_from_jax``).

Also here: the checkpoint format and bit-exact resume, the Adam details
(clamp, frozen rows, cosine schedule) and the CLI ``train``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from computeraytracer_tpu import config as jconfig
from computeraytracer_tpu.scene import presets as jpresets
from computeraytracer_tpu.scene import scene_from_dict as jax_scene_from_dict
from computeraytracer_tpu.tracer import pallas as jax_pallas
from computeraytracer_tpu.train import optimize as jopt
from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.parallel import distributed
from computeraytracer_tpu_torch.parallel import mesh as mesh_mod
from computeraytracer_tpu_torch.scene import scene_from_jax
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.train import checkpoint as ckpt
from computeraytracer_tpu_torch.train import optimize as opt

W = H = 8
DEPTH = 2
PERTURB_ROW = 2


def _jax_scene(variant):
    doc = jpresets.simple_scene(W, H)
    if variant == "glass":
        doc["objects"]["spheres"][0]["type"] = "glass"
    return jax_scene_from_dict(doc)[0]


def _jax_render_grads(js):
    """d sum(render_sample ** 2) / d (spectra, data1, camera.eye)."""

    def loss(spectra, d1, eye):
        s = js._replace(spectra=spectra,
                        primitives=js.primitives._replace(data1=d1),
                        camera=js.camera._replace(eye=eye))
        img = jax_pallas.render_sample(s, W, H, 1, max_depth=DEPTH,
                                       backward="pallas")
        return jnp.sum(img ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(js.spectra), jnp.asarray(js.primitives.data1),
        jnp.asarray(js.camera.eye))
    return [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def jax_grads():
    return {v: _jax_render_grads(_jax_scene(v)) for v in ("simple", "glass")}


def _port_render_grads(scene):
    leaves = [scene.spectra.clone().requires_grad_(True),
              scene.primitives.data1.clone().requires_grad_(True),
              scene.camera.eye.clone().requires_grad_(True)]
    s = dataclasses.replace(
        scene, spectra=leaves[0],
        primitives=dataclasses.replace(scene.primitives, data1=leaves[1]),
        camera=dataclasses.replace(scene.camera, eye=leaves[2]))
    (kt.render_sample(s, W, H, 1, max_depth=DEPTH) ** 2).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("variant", ["simple", "glass"])
def test_render_gradients_match_jax_pallas(jax_grads, variant):
    """spectra, geometry and camera gradients at the tolerances of
    tests/test_pallas.py (scaled by the largest entry)."""
    got = _port_render_grads(scene_from_jax(_jax_scene(variant)))
    for name, gp, gj in zip(("spectra", "data1", "eye"), got,
                            jax_grads[variant]):
        assert np.isfinite(gp).all(), name
        scale = max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(gp / scale, gj / scale, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    assert np.abs(got[1]).max() > 0 and np.abs(got[2]).max() > 0


@pytest.fixture(scope="module")
def recovery():
    """The CLI's demo problem at 8x8: row 2 dimmed x0.3, the undimmed
    render as target (both packages render it)."""
    js = _jax_scene("simple")
    target = jopt.render_mean_xyz(js, W, H, 1, DEPTH, kernel="pallas")
    dimmed = js._replace(
        spectra=jnp.asarray(js.spectra).at[PERTURB_ROW].mul(0.3))
    return {"target": np.array(target), "dimmed_jax": dimmed,
            "dimmed": scene_from_jax(dimmed)}


def _port_optimize(rec, **kw):
    args = dict(steps=3, learning_rate=0.05, spp=1, max_depth=DEPTH)
    args.update(kw)
    return opt.optimize(rec["dimmed"], torch.from_numpy(rec["target"]),
                        W, H, **args)


def test_optimize_losses_match_jax(recovery):
    """3 cosine-scheduled Adam steps on the dimmed row. Training is
    restricted to that row on both sides: Adam divides each entry's step
    by that entry's own gradient scale, so an entry whose gradient is
    rounding residue of order Adam's eps (1e-8) in one framework and
    exactly 0 in the other takes a step of a sizeable share of lr in one
    of them only."""
    kw = dict(lr_schedule="cosine", spectra_rows=[PERTURB_ROW])
    _, want = jopt.optimize(recovery["dimmed_jax"],
                            jnp.asarray(recovery["target"]), W, H, steps=3,
                            learning_rate=0.05, spp=1, max_depth=DEPTH,
                            kernel="pallas", **kw)
    _, got = _port_optimize(recovery, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]


def test_cosine_learning_rates_equal_optax():
    steps = 7
    sched = optax.cosine_decay_schedule(0.05, steps)
    p = torch.zeros(3, requires_grad=True)
    adam = torch.optim.Adam([p], lr=0.05)
    lr = torch.optim.lr_scheduler.LambdaLR(adam, opt.cosine_decay(steps))
    got = []
    for _ in range(steps + 2):
        got.append(adam.param_groups[0]["lr"])
        adam.step()
        lr.step()
    want = [float(sched(c)) for c in range(steps + 2)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_spectra_clamped_nonnegative(recovery):
    """A step far larger than the spectra drives entries below 0; the
    projected step clamps them to exactly 0."""
    scene, _ = _port_optimize(recovery, steps=1, learning_rate=5.0)
    assert (scene.spectra >= 0).all()
    assert (scene.spectra == 0).sum() > (recovery["dimmed"].spectra
                                         == 0).sum()


def test_spectra_rows_freeze_the_other_rows(recovery):
    scene, _ = _port_optimize(recovery, spectra_rows=[PERTURB_ROW])
    before = recovery["dimmed"].spectra
    others = [r for r in range(before.shape[0]) if r != PERTURB_ROW]
    assert torch.equal(scene.spectra[others], before[others])
    assert not torch.equal(scene.spectra[PERTURB_ROW], before[PERTURB_ROW])


def test_geometry_training_moves_data1(recovery):
    scene, losses = _port_optimize(recovery, steps=2,
                                   trainable=("spectra", "data1"))
    assert np.isfinite(losses).all()
    assert not torch.equal(scene.primitives.data1,
                           recovery["dimmed"].primitives.data1)


def test_resume_repeats_the_uninterrupted_run(recovery, tmp_path):
    """A 4-step run stopped during step 3 (its last checkpoint at step 2)
    and resumed: the params and the remaining losses equal one
    uninterrupted run bit for bit, the cosine schedule's position
    included."""
    kw = dict(steps=4, lr_schedule="cosine", fresh_samples=True)
    full_scene, full_losses = _port_optimize(recovery, **kw)
    d = str(tmp_path / "ck")

    class Stop(Exception):
        pass

    def stop_in_step_3(i, loss, params):
        if i == 2:
            raise Stop

    with pytest.raises(Stop):
        _port_optimize(recovery, checkpoint_dir=d, checkpoint_every=2,
                       callback=stop_in_step_3, **kw)
    assert ckpt.Checkpointer(d).latest_step() == 2
    resumed, rest = _port_optimize(recovery, checkpoint_dir=d,
                                   checkpoint_every=2, **kw)
    assert rest == full_losses[2:]
    assert torch.equal(resumed.spectra, full_scene.spectra)
    assert ckpt.Checkpointer(d).latest_step() == 4


@pytest.mark.parametrize("version", [1, None])
def test_wrong_layout_version_raises(tmp_path, version):
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(3, {"spectra": torch.ones(2, 2)})
    assert c.restore(3)["layout_version"] == ckpt.LAYOUT_VERSION
    payload = {"params": {"spectra": torch.ones(2, 2)}, "step": 5}
    if version is not None:
        payload["layout_version"] = version
    torch.save(payload, c._path(5))
    with pytest.raises(ValueError, match="layout"):
        c.restore_latest()


def test_optimizer_state_roundtrip(tmp_path):
    p = torch.arange(12.0).reshape(3, 4).requires_grad_(True)
    adam = torch.optim.Adam([p], lr=1e-2)
    p.grad = torch.ones_like(p)
    adam.step()
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(5, {"spectra": p}, {"adam": adam.state_dict()})
    c.save(9, {"spectra": p}, {"adam": adam.state_dict()})
    assert c.latest_step() == 9
    params, state, step = c.restore_latest()
    assert step == 9 and torch.equal(params["spectra"], p.detach())
    fresh = torch.optim.Adam([torch.zeros(3, 4, requires_grad=True)])
    fresh.load_state_dict(state["adam"])
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"],
                       adam.state_dict()["state"][0]["exp_avg"])


def test_render_state_roundtrip(tmp_path):
    accum = torch.rand(4, 5, 3, generator=torch.Generator().manual_seed(0))
    assert ckpt.load_render_state(str(tmp_path)) is None
    ckpt.save_render_state(str(tmp_path), accum, sample_count=3)
    back, count = ckpt.load_render_state(str(tmp_path))
    assert count == 3 and torch.equal(back, accum)


def test_train_config_fields_match_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(C.TrainConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(
        jconfig.TrainConfig)]
    assert port == ref


def test_optimize_config_runs(recovery):
    cfg = C.TrainConfig(steps=1, spp_per_step=1,
                        render=C.RenderConfig(max_depth=DEPTH))
    _, losses = opt.optimize_config(recovery["dimmed"],
                                    torch.from_numpy(recovery["target"]), W,
                                    H, cfg)
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_split_merge_roundtrip(recovery):
    scene = recovery["dimmed"]
    params, static = opt.split_scene(scene, ("spectra", "data2"))
    assert set(params) == {"spectra", "data2"}
    merged = opt.merge_scene(static, {"spectra": params["spectra"] * 2,
                                      "data2": params["data2"]})
    assert torch.equal(merged.spectra, scene.spectra * 2)
    with pytest.raises(ValueError, match="not trainable"):
        opt.split_scene(scene, ("camera",))


@pytest.mark.parametrize("kw", [dict(kernel="xla", mesh=True),
                                dict(mesh=True),
                                dict(kernel="xla", use_remat=True,
                                     vis_grads=True),
                                dict(vis_grads=True)])
def test_unported_options_raise(recovery, kw, tmp_path):
    """mesh= (sharded training, ported) renders in a world of one the
    image of mesh=None, and raises ValueError with vis_grads; vis_grads
    renders on the eager tracer and raises ValueError on the kernel
    path."""
    scene = recovery["dimmed"]
    if "mesh" in kw:
        kernel = kw.get("kernel", "pallas")
        want = opt.render_mean_xyz(scene, W, H, 1, DEPTH, kernel=kernel)
        distributed.initialize(f"file://{tmp_path}/store", 1, 0,
                               device_type="cpu")
        try:
            mesh = mesh_mod.make_mesh()
            got = opt.render_mean_xyz(scene, W, H, 1, DEPTH, kernel=kernel,
                                      mesh=mesh)
            with pytest.raises(ValueError, match="no sharded path"):
                opt.render_mean_xyz(scene, W, H, 1, DEPTH, kernel="xla",
                                    mesh=mesh, vis_grads=True)
        finally:
            distributed.shutdown()
        assert torch.equal(got, want)
    elif kw.get("kernel") == "xla":
        img = opt.render_mean_xyz(scene, W, H, 1, DEPTH, **kw)
        assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    else:
        with pytest.raises(ValueError, match="kernel='xla'"):
            opt.render_mean_xyz(scene, W, H, 1, DEPTH, **kw)


def test_cli_train_cpu(capsys):
    rc = cli.main(["train", "--preset", "cornell_box", "--width", "8",
                   "--height", "8", "--spp", "1", "--depth", "2", "--steps",
                   "3", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rc == 0
    assert rec["steps"] == 3 and rec["final_loss"] < rec["initial_loss"]


def test_cli_train_unported_kernel_raises():
    # both of the JAX CLI's kernels are ported; any other is refused
    with pytest.raises(SystemExit):
        cli.main(["train", "--width", "8", "--height", "8", "--spp", "1",
                  "--depth", "1", "--steps", "1", "--device", "cpu",
                  "--kernel", "triton"])
    with pytest.raises(ValueError, match="unknown kernel"):
        opt.render_mean_xyz(None, W, H, 1, DEPTH, kernel="triton")


def test_cpu_training_launches_no_kernel(recovery):
    before = mk.launches, mk.launches_bwd
    _port_optimize(recovery, steps=1)
    assert (mk.launches, mk.launches_bwd) == before
