"""The control of the comparison, and faults planted in its place.

The control is the reference put in the program's place and computed one
precision below the configuration's (float32 -> bfloat16: the path
tracer has no matrix products, so TF32 does not apply). It produces what
the timed path would hand the comparison (a render cell's kept frames, a
fit cell's followed steps) from the same seed, and the comparison judges
it as it judges the program. ``correct`` has to come out false.

The faults are planted in the float32 reference in the same place:
- ``unchanged``: a render returns the frame before; a fit step leaves its
  state unchanged (its loss repeats, Adam holds no gradient);
- ``half_batch``: half of the film's rows left out (a render's pixels
  there are 0; a fit's loss is the mean over the other half);
- ``altered``: an answer altered where it is produced (a frame's image, a
  step's loss, scaled by 1.01).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.harness import cells, check
from bench_h100.harness.entries import first_sample, seeded, target_image
from bench_h100.reference import fit as ref_fit
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import scene as ref_scene
from bench_h100.reference import tracer as ref_tracer

FAULTS = ("unchanged", "half_batch", "altered")
FRAMES = 3


def _serve_answers(cell, doc, seed, device, dtype, fault):
    scene = ref_scene.build(doc, device, dtype)
    spp = int(cell.mix["spp"])
    first = first_sample(cell, seed, int(cell.mix["warmup_units"]))
    n_film = cell.width * cell.height
    out = []
    for j in range(FRAMES):
        sample = first + j * spp
        shown = sample - spp if fault == "unchanged" and j > 0 else sample
        idx = np.sort(seeded(seed, 10 + j).choice(
            n_film, size=min(int(cell.check["pixels"]), n_film),
            replace=False))
        ti = torch.from_numpy(idx).to(device)
        px, py = ti % cell.width, ti // cell.width
        with torch.no_grad():
            acc = ref_tracer.accumulate(
                scene, cell.width, cell.height, px, py, shown, spp,
                int(cell.config["max_depth"]), int(cell.config["rr_start"]))
            if fault == "half_batch":
                acc = torch.where((py >= cell.height // 2)[:, None], 0.0, acc)
            if fault == "altered":
                acc = acc * 1.01
            srgb = ref_ops.xyz_to_srgb(acc / float(sample + spp - 1))
        out.append({"frame": j, "first_sample": sample,
                    "samples": sample + spp - 1, "idx": idx,
                    "accum": acc.float().cpu(), "srgb": srgb.float().cpu()})
    return out


def _fit_answers(cell, doc, seed, device, dtype, fault, target, first):
    scene = ref_scene.build(doc, device, dtype)
    leaves = {"spectra": scene.spectra, "data1": scene.prims.data1}
    leaves = {k: leaves[k] for k in cell.mix["trainable"]}
    mix = cell.mix
    rows = cell.height // 2 if fault == "half_batch" else None
    steps = 1 if fault == "unchanged" else int(mix["followed_steps"])
    losses, grad, theta = ref_fit.follow(
        scene, leaves, target.to(device), steps,
        float(mix["learning_rate"]), cell.width, cell.height,
        int(mix["spp"]), first, int(cell.config["max_depth"]),
        int(cell.config["rr_start"]), int(cell.check["block_pixels"]), rows)
    if fault == "unchanged":
        losses = losses * int(mix["followed_steps"])
        grad = {k: torch.zeros_like(v) for k, v in grad.items()}
        theta = leaves
    if fault == "altered":
        losses = [x * 1.01 for x in losses]
    return {"losses": losses, "first_grad": grad,
            "theta0": {k: v.detach() for k, v in leaves.items()},
            "theta": theta}


def readings(cell, seed: int, device, mode: str, log=None) -> dict:
    """The comparison's numbers for the control (mode "bf16") or a planted
    fault, at the cell's own sizes, from one seed."""
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    fault = None if mode == "bf16" else mode
    doc = cells.scene_doc(cell)
    if cell.entry == "render":
        answers = _serve_answers(cell, doc, seed, device, dtype, fault)
        refs = check.serve_reference(cell, doc, answers, device)
        return check.serve_numbers(cell, answers, refs)
    target = target_image(cell, seed, device)
    first = first_sample(cell, seed, 0)
    got = _fit_answers(cell, doc, seed, device, dtype, fault, target, first)
    want = check.fit_reference(cell, doc, target, first, device)
    return check.fit_numbers(got, want, log)
