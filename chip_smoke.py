#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (computeraytracer_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: nvcc compiles every kernel source (registers and spills shown).
3. kernel vs plain: the CUDA forward megakernel and its plain torch
   version on the same CUDA tensors, Cornell box 1024^2, depth 8, sample
   1: at least 99.9% of rays within rel 1e-4 (denominator floored at
   1e-2), all finite.
4. served path: tracer.api.render at 1024^2, spp 4, depth 8 with the
   launch counter reset just before; exactly 4 kernel launches, a finite
   non-zero image whose mean XYZ is within 1e-3 relative of the same
   render through the plain version; the PNG is written to a temp dir.
5. timing: forward kernel and plain version at the phase-3 shape (CUDA
   events, after a warm-up).
6. backward kernel vs plain: the CUDA backward megakernel and
   backward_reference (in bands of at most 131072 rays) at the phase-3
   shape, for a radiance cotangent dL from a fixed seed: d_prims within
   1e-3 of its largest entry; d_rays and d_spect with at least 99.9% of
   rays within rel 1e-3 (denominator floored at 1e-3 of the plane's
   largest magnitude); all finite.
7. training path: value_and_grad of mean((accum / 4) ** 2) at 1024^2,
   spp 4, depth 8 with respect to spectra and primitives.data1, with both
   launch counters reset just before: exactly 4 forward and 4 backward
   launches, finite gradients, non-zero in every spectra row the render
   reads. Then train.optimize (kernel="pallas") for 3 Adam steps (lr
   0.05) from the Cornell scene with spectra row 2 dimmed x0.3 against
   the undimmed target, training that row (spectra_rows: with every row
   free, Adam's first step moves every entry of every row by about lr,
   against albedos of 0.04-0.74, and raised the loss at this size):
   finite losses, the last below the first.
8. timing: the backward kernel per sample and the plain backward on one
   band (CUDA events, after a warm-up); the fwd+bwd step on the host
   clock, split into its forward pass, backward pass and Adam step. Then
   one JSON line of kernels.
The last line is {"ok": true, "device": {...}}. It needs no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import _build
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer.api import render
from computeraytracer_tpu_torch.train import optimize as opt
from computeraytracer_tpu_torch.utils.image import read_png, write_png

WIDTH = HEIGHT = 1024
MAX_DEPTH = 8
RR_START = 1
SPP = 4
BAND = 131072  # rays per band of the plain backward
TRAIN_STEPS = 3
PERTURB_ROW = 2


def _events_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _plain_render_accum(scene, static, spp):
    """The served render's accumulation, traced by forward_reference."""
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, scene.device)
    accum = torch.zeros((3, WIDTH * HEIGHT), device=scene.device)
    for s in range(1, spp + 1):
        o, d, hero, seed = kt.camera_planes(scene, WIDTH, HEIGHT, px, py, s)
        radiance = mk.forward_reference(
            static, MAX_DEPTH, RR_START,
            *kt.kernel_inputs(scene, o, d, hero, seed))
        cie_p = spec.gather_hero(spec.cie_window_exp(scene.cie), hero)
        accum = accum + spec.spectral_to_xyz_p(cie_p, radiance)
    return accum.T.reshape(HEIGHT, WIDTH, 3)


def _host_s(fn):
    """Host seconds of fn(), synchronised before and after; returns
    (seconds, fn's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _train_leaves(scene):
    """(spectra, data1) as fresh leaves that require grad, and the scene
    that holds them."""
    sp = scene.spectra.detach().clone().requires_grad_(True)
    d1 = scene.primitives.data1.detach().clone().requires_grad_(True)
    return sp, d1, dataclasses.replace(
        scene, spectra=sp,
        primitives=dataclasses.replace(scene.primitives, data1=d1))


def _headline_loss(scene, static):
    """mean((accum / spp) ** 2) of the planar accumulation over samples
    1..SPP (bench.py's fwd+bwd workload)."""
    accum = torch.zeros((3, HEIGHT, WIDTH), device=scene.device)
    for s in range(1, SPP + 1):
        accum = accum + kt.render_sample_planar(
            scene, WIDTH, HEIGHT, s, MAX_DEPTH, RR_START, static)
    return torch.mean((accum / float(SPP)) ** 2)


def _vg(scene, static):
    """value_and_grad of the headline loss: the loss value; gradients
    land in the scene's leaves."""
    loss = _headline_loss(scene, static)
    loss.backward()
    return loss.item()


def _rows_read(static):
    """Spectra rows the trace reads: diffuse reflectances, light
    emissions, and the extinction row when the scene has glass."""
    rows = set()
    for m, e, r in zip(static.materials, static.emission_idx,
                       static.reflectance_idx):
        if m == C.DIFFUSE:
            rows.add(r)
        elif m == C.LIGHT:
            rows.add(e)
        elif m == C.GLASS:
            rows.add(static.n_spectra - 1)
    return sorted(rows)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")

    # 3. kernel vs plain version at the main path's shape
    scene, _ = scene_from_dict(presets.cornell_box(WIDTH, HEIGHT), device=dev)
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    o, d, hero, seed = kt.camera_planes(scene, WIDTH, HEIGHT, px, py, 1)
    args = kt.kernel_inputs(scene, o, d, hero, seed)
    got = mk.forward(static, MAX_DEPTH, RR_START, *args)
    want = mk.forward_reference(static, MAX_DEPTH, RR_START, *args)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite radiance")
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-2)
    frac = (rel < 1e-4).all(dim=0).float().mean().item()
    max_abs_err = abs_err.max().item()
    exact = (got == want).all(dim=0).float().mean().item()
    print(f"kernel vs plain: {frac:.6f} of {got.shape[1]} rays within rel "
          f"1e-4; worst rel {rel.max().item():.3g}, worst abs "
          f"{max_abs_err:.3g}; bit-equal {exact:.6f}")
    if frac < 0.999:
        raise RuntimeError(f"kernel disagrees with plain version: {frac}")

    # 4. the served path
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_depth=MAX_DEPTH, kernel="pallas")
    mk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(scene, cfg)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = mk.launches
    if launches != SPP:
        raise RuntimeError(f"{launches} kernel launches, expected {SPP}")
    accum = out["accum_xyz"]
    if not torch.isfinite(accum).all() or not (accum != 0).any():
        raise RuntimeError("render is not finite and non-zero")
    mean_xyz = out["mean_xyz"].mean(dim=(0, 1))
    plain_mean = (_plain_render_accum(scene, static, SPP)
                  / float(out["samples"])).mean(dim=(0, 1))
    rel_mean = ((mean_xyz - plain_mean).abs() / plain_mean.abs()).max().item()
    print(f"render: {WIDTH}x{HEIGHT} spp {SPP} depth {MAX_DEPTH} in "
          f"{render_s:.3f} s ({WIDTH * HEIGHT * SPP / render_s / 1e6:.3f} "
          f"Mpaths/s end to end), {launches} launches, mean XYZ "
          f"{mean_xyz.tolist()} vs plain {plain_mean.tolist()} "
          f"(rel {rel_mean:.3g})")
    if rel_mean > 1e-3:
        raise RuntimeError(f"mean XYZ off the plain render by {rel_mean}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.png")
        write_png(path, out["srgb"])
        if read_png(path).shape != (HEIGHT, WIDTH, 3):
            raise RuntimeError("PNG did not round-trip")
    print(f"png: {WIDTH}x{HEIGHT} written and read back")

    # 5. timing at the phase-3 shape
    ms = _events_ms(lambda: mk.forward(static, MAX_DEPTH, RR_START, *args), 5)
    plain_ms = _events_ms(
        lambda: mk.forward_reference(static, MAX_DEPTH, RR_START, *args), 2)
    rays = args[1].shape[1]
    print(f"forward: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms per "
          f"sample of {rays} rays")

    # 6. backward kernel vs plain version at the phase-3 shape
    gen = torch.Generator(device=dev).manual_seed(0)
    dL = torch.randn((4, rays), generator=gen, device=dev)
    got_b = mk.backward(static, MAX_DEPTH, RR_START, *args, dL)
    t_plain_b, want_b = _host_s(lambda: mk.backward_reference(
        static, MAX_DEPTH, RR_START, *args, dL, ray_chunk=BAND))
    names = ("d_prims", "d_rays", "d_spect")
    for nm, g, w in zip(names, got_b, want_b):
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise RuntimeError(f"non-finite {nm}")
    bwd_abs_err = max((g - w).abs().max().item()
                      for g, w in zip(got_b, want_b))
    prims_err = ((got_b[0] - want_b[0]).abs().max()
                 / want_b[0].abs().max()).item()
    report = [f"d_prims worst err {prims_err:.3g} of its largest entry"]
    fracs = []
    for nm, g, w in zip(names[1:], got_b[1:], want_b[1:]):
        den = torch.maximum(w.abs(), 1e-3 * w.abs().max())
        rel = (g - w).abs() / den
        fracs.append((rel < 1e-3).all(dim=0).float().mean().item())
        report.append(f"{nm} {fracs[-1]:.6f} of rays within rel 1e-3, "
                      f"worst rel {rel.max().item():.3g}")
    equal = ((got_b[1] == want_b[1]).all(dim=0)
             & (got_b[2] == want_b[2]).all(dim=0)).float().mean().item()
    print(f"backward vs plain ({rays} rays, plain in bands of {BAND}, "
          f"{t_plain_b:.1f} s): " + "; ".join(report)
          + f"; bit-equal rays {equal:.6f}; max abs err {bwd_abs_err:.3g}")
    if prims_err > 1e-3 or min(fracs) < 0.999:
        raise RuntimeError("backward kernel disagrees with plain version")
    del want_b

    # 7. the training path at full width
    sp, d1, train_scene = _train_leaves(scene)
    mk.launches = 0
    mk.launches_bwd = 0
    step_s, loss = _host_s(lambda: _vg(train_scene, static))
    launches_fwd, launches_bwd = mk.launches, mk.launches_bwd
    if (launches_fwd, launches_bwd) != (SPP, SPP):
        raise RuntimeError(f"value_and_grad made {launches_fwd} forward and "
                           f"{launches_bwd} backward launches, expected "
                           f"{SPP} each")
    for nm, g in (("spectra", sp.grad), ("data1", d1.grad)):
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"{nm} gradient missing or not finite")
    rows = _rows_read(static)
    dead = [r for r in rows if not (sp.grad[r] != 0).any()]
    if dead or not (d1.grad != 0).any():
        raise RuntimeError(f"zero gradient in spectra rows {dead} or data1")
    print(f"value_and_grad: loss {loss:.6e}, {launches_fwd} forward + "
          f"{launches_bwd} backward launches, {step_s * 1e3:.1f} ms "
          f"(first call); |d spectra| per read row "
          f"{[float(sp.grad[r].abs().sum()) for r in rows]}, |d data1| "
          f"{float(d1.grad.abs().sum()):.6g}")
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, WIDTH, HEIGHT, SPP, MAX_DEPTH,
                                     RR_START)
    spectra = scene.spectra.clone()
    spectra[PERTURB_ROW] = spectra[PERTURB_ROW] * 0.3
    train_s, (_, losses) = _host_s(lambda: opt.optimize(
        dataclasses.replace(scene, spectra=spectra), target, WIDTH, HEIGHT,
        steps=TRAIN_STEPS, learning_rate=0.05, spp=SPP, max_depth=MAX_DEPTH,
        rr_start=RR_START, kernel="pallas", spectra_rows=[PERTURB_ROW]))
    print(f"optimize: {TRAIN_STEPS} steps in {train_s:.2f} s, losses "
          f"{losses}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"optimize did not lower the loss: {losses}")

    # 8. timing
    bwd_ms = _events_ms(
        lambda: mk.backward(static, MAX_DEPTH, RR_START, *args, dL), 5)
    band = [a.contiguous() for a in (args[1][:, :BAND], args[2][:, :BAND],
                                     args[3][:, :BAND], dL[:, :BAND])]
    plain_bwd_ms = _events_ms(lambda: mk.backward_reference(
        static, MAX_DEPTH, RR_START, args[0], *band), 1)
    print(f"backward: kernel {bwd_ms:.4f} ms per sample of {rays} rays; "
          f"plain {plain_bwd_ms:.1f} ms per band of {BAND} rays")
    steps = [_host_s(lambda: _vg(_train_leaves(scene)[2], static))[0]
             for _ in range(3)]
    paths = WIDTH * HEIGHT * SPP
    print(f"fwd+bwd step (value_and_grad, spp {SPP}): "
          f"{[round(t * 1e3, 3) for t in steps]} ms, "
          f"{[round(paths / t / 1e6, 3) for t in steps]} Mpaths/s")
    sp, d1, train_scene = _train_leaves(scene)
    adam = torch.optim.Adam([sp, d1], lr=0.05)
    fwd_s, loss = _host_s(lambda: _headline_loss(train_scene, static))
    bwd_s, _ = _host_s(loss.backward)
    adam_s, _ = _host_s(adam.step)
    print(f"train step breakdown: forward pass {fwd_s * 1e3:.3f} ms "
          f"({SPP} forward kernels of ~{ms:.3f} ms, the rest setup ops and "
          f"CIE), backward pass {bwd_s * 1e3:.3f} ms ({SPP} backward "
          f"kernels of ~{bwd_ms:.3f} ms, the rest autograd of the setup "
          f"ops), Adam {adam_s * 1e3:.3f} ms")
    print(f"chip_smoke phases 1-8: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897",
        "launches": launches,
        "launches_train": launches_fwd,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_per_sample": ms,
        "plain_ms_per_sample": plain_ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "max_depth": MAX_DEPTH,
    }, {
        "name": "megakernel_backward",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/megakernel_bwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:1314",
        "launches": launches_bwd,
        "max_abs_err": bwd_abs_err,
        "ms": bwd_ms,
        "plain_ms": plain_bwd_ms,
        "plain_rays": BAND,
        "rays": rays,
        "max_depth": MAX_DEPTH,
        "fwdbwd_mpaths_per_s": [paths / t / 1e6 for t in steps],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
