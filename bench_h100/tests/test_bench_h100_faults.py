"""The comparison fails what it should, at a tiny film on the CPU:
- the control, the reference computed in bfloat16 in the program's place;
- each fault a cell can have, planted in the program under a whole run
  (the harness's look for a card skipped): a frame or step that leaves
  its state unchanged, half of the film left out, an answer altered
  where it is produced. A cell on one device has no exchange to leave
  out.
"""

import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_h100.harness import cells, check, control, runner  # noqa: E402

BENCH = cells.load_benchmark()
TINY = {"width": 8, "height": 8, "pixels": 32, "block_pixels": 32,
        "warmup_units": 1}
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(name):
    return cells.cell(BENCH, name, TINY)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    c = tiny(name)
    for seed in (11, 12, 13):
        ok, shown = check.verdict(
            c, control.readings(c, seed, torch.device("cpu"), "bf16"))
        assert not ok, shown


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_in_reference_place_fails(name, fault):
    c = tiny(name)
    ok, shown = check.verdict(
        c, control.readings(c, 21, torch.device("cpu"), fault))
    assert not ok, shown


def _render_faults(monkeypatch, fault):
    from computeraytracer_tpu_torch.tracer import api

    real = api.render
    last = {}

    def render(scene, cfg=None, **kw):
        out = real(scene, cfg, **kw)
        if fault == "unchanged":
            out, last["out"] = last.get("out", out), out
        elif fault == "half_batch":
            h = out["accum_xyz"].shape[0] // 2
            out = dict(out, accum_xyz=torch.cat(
                [out["accum_xyz"][:h], torch.zeros_like(
                    out["accum_xyz"][h:])]))
        elif fault == "altered":
            out = dict(out, accum_xyz=out["accum_xyz"] * 1.01)
        return out

    monkeypatch.setattr(api, "render", render)


def _fit_faults(monkeypatch, fault):
    from computeraytracer_tpu_torch.train import optimize

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        def make_loss_fn(static_scene, width, height, spp, max_depth,
                         rr_start=1, mesh=None, use_remat=True,
                         kernel="pallas", backward="pallas"):
            def loss_fn(params, target, first_sample):
                scene = optimize.merge_scene(static_scene, params)
                img = optimize.render_mean_xyz(
                    scene, width, height, spp, max_depth, rr_start,
                    first_sample, backward=backward)
                h = height // 2
                return torch.mean((img[:h] - target[:h]) ** 2)
            return loss_fn
        monkeypatch.setattr(optimize, "make_loss_fn", make_loss_fn)
    elif fault == "altered":
        real = optimize.make_train_step

        def make_train_step(*a, **kw):
            step = real(*a, **kw)
            return lambda *args: step(*args) * 1.01
        monkeypatch.setattr(optimize, "make_train_step", make_train_step)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_in_program_fails_the_run(monkeypatch, name, fault):
    c = tiny(name)
    if c.entry == "render":
        _render_faults(monkeypatch, fault)
    else:
        _fit_faults(monkeypatch, fault)
    ctx = runner.Ctx(c, 2 ** 31 + 9, torch.device("cpu"))
    result = runner.run(ctx, 0.2, False, time.perf_counter())
    assert result["correct"] is False, result["checks"]
