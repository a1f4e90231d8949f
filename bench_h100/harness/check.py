"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``bench_h100/reference``), which builds its
own scene from the same document and is handed the same target.

- ``render`` cells: the kept frames at pixels drawn from the seed. A pixel
  is off when its accumulated XYZ differs from the reference's by more
  than ``pixel_tol`` of the reference's value (floored at a thousandth of
  the sample's mean), or its sRGB by more than ``pixel_tol``, or is not
  finite; a frame whose sample counter is wrong is off at every pixel.
  The number compared is ``bad_pixel_share``: off pixels over those
  compared. Monte Carlo paths that part on a rounding difference make a
  few pixels off in a sound run.
- ``fit`` cells: the reference follows the first steps from the same
  leaves. ``loss_gap``: |first step's loss - reference| over the
  reference (later steps' losses are printed, not compared: Adam's first
  update moves every element by the learning rate whatever its
  gradient's size, so an element whose gradient is rounding noise moves
  either way, and in the Cornell box that can hide or show the light,
  which is coplanar with the ceiling). ``grad_gap``: the worst leaf's gap
  between the norms of the first gradient and the reference's, over the
  larger of the reference leaf's norm and the median leaf's.
  ``grad_gap.<leaf>``: that leaf's gap over its own reference norm alone,
  floored at rounding level (a millionth of the median leaf's), so that a
  leaf whose gradient is small beside the others' (the Cornell box's
  ``data1`` beside its ``spectra``) is held too.
  ``change_gap``: the same as ``grad_gap`` of the leaves' change over the
  followed steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's.

A check file's ``limits`` say which of these numbers a cell compares.
"""

from __future__ import annotations

import math
import statistics

import torch

from bench_h100.reference import fit as ref_fit
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import scene as ref_scene
from bench_h100.reference import tracer as ref_tracer

# a number that is not finite reads as this
NOT_FINITE = 1e30


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def serve_reference(cell, doc, answers, device, dtype=torch.float32):
    """The reference's accumulated XYZ and sRGB at each answer's pixels."""
    scene = ref_scene.build(doc, device, dtype)
    out = []
    for a in answers:
        idx = torch.from_numpy(a["idx"]).to(device)
        px, py = idx % cell.width, idx // cell.width
        with torch.no_grad():
            acc = ref_tracer.accumulate(
                scene, cell.width, cell.height, px, py, a["first_sample"],
                int(cell.mix["spp"]), int(cell.config["max_depth"]),
                int(cell.config["rr_start"]))
            total = a["first_sample"] + int(cell.mix["spp"]) - 1
            srgb = ref_ops.xyz_to_srgb(acc / float(total))
        out.append({"accum": acc.float().cpu(), "srgb": srgb.float().cpu(),
                    "samples": total})
    return out


def serve_numbers(cell, answers, refs) -> dict:
    tol = float(cell.check["pixel_tol"])
    bad = n = 0
    for a, r in zip(answers, refs):
        got, want = a["accum"].double(), r["accum"].double()
        floor = 1e-3 * float(want.abs().mean())
        rel = ((got - want).abs() / want.abs().clamp(min=floor)).amax(dim=1)
        off = ~(rel <= tol)
        if a["srgb"] is not None:
            off |= ~((a["srgb"].double() - r["srgb"].double()).abs()
                     .amax(dim=1) <= tol)
        if a["samples"] is not None and a["samples"] != r["samples"]:
            off[:] = True
        bad += int(off.sum())
        n += off.numel()
    return {"bad_pixel_share": bad / max(n, 1)}


def _norm(t) -> float:
    return float(t.double().norm())


def _norm_gaps(got: dict, want: dict, names, own=False) -> dict:
    """|norm of got - norm of want| by leaf, over the larger of the want
    leaf's norm and the median leaf's (own: over the leaf's norm alone,
    floored at a millionth of the median leaf's)."""
    scale = statistics.median(_norm(v) for v in want.values())
    if own:
        scale *= 1e-6
    return {k: _finite(abs(_norm(got[k]) - _norm(want[k]))
                       / max(_norm(want[k]), scale, 1e-30)) for k in names}


def fit_reference(cell, doc, target, first_sample, device,
                  dtype=torch.float32) -> dict:
    """The reference's first steps from the configuration's own leaves:
    {losses, first_grad, theta0, theta}."""
    scene = ref_scene.build(doc, device, dtype)
    leaves = {"spectra": scene.spectra, "data1": scene.prims.data1}
    leaves = {k: leaves[k] for k in cell.mix["trainable"]}
    mix = cell.mix
    losses, first, theta = ref_fit.follow(
        scene, leaves, target.to(device), int(mix["followed_steps"]),
        float(mix["learning_rate"]), cell.width, cell.height,
        int(mix["spp"]), first_sample, int(cell.config["max_depth"]),
        int(cell.config["rr_start"]), int(cell.check["block_pixels"]))
    return {"losses": losses, "first_grad": first,
            "theta0": {k: v.detach() for k, v in leaves.items()},
            "theta": theta}


def fit_numbers(got: dict, want: dict, log=None) -> dict:
    steps = [_finite(abs(a - b) / abs(b))
             for a, b in zip(got["losses"], want["losses"])]
    g_got = {k: v.detach().cpu() for k, v in got["first_grad"].items()}
    g_want = {k: v.detach().cpu() for k, v in want["first_grad"].items()}
    scale = statistics.median(_norm(v) for v in g_want.values())
    moved = [k for k in g_want if _norm(g_want[k]) >= 1e-3 * scale]

    def change(d):
        return {k: (d["theta"][k].detach().cpu().double()
                    - d["theta0"][k].detach().cpu().double())
                for k in d["theta"]}

    grads = _norm_gaps(g_got, g_want, list(g_want))
    own = _norm_gaps(g_got, g_want, list(g_want), own=True)
    changes = _norm_gaps(change(got), change(want), moved)
    if log is not None:
        norms = {k: _norm(v) for k, v in g_want.items()}
        log(f"loss gap by step {steps}; gradient gap by leaf {grads}; "
            f"over its own norm {own}; change gap by leaf {changes}; "
            f"reference gradient norms {norms}")
    out = {"loss_gap": steps[0], "grad_gap": max(grads.values()),
           "change_gap": max(changes.values(), default=0.0)}
    out.update({f"grad_gap.{k}": v for k, v in own.items()})
    return out


def verdict(cell, numbers: dict) -> tuple:
    """(correct, {name: {value, limit}}) against the cell's limits."""
    limits = cell.check["limits"]
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok, shown
