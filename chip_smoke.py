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
5. timing: kernel and plain version at the phase-3 shape (CUDA events,
   after a warm-up), printed as one JSON line of kernels.
The last line is {"ok": true, "device": {...}}. It needs no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import _build
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer.api import render
from computeraytracer_tpu_torch.utils.image import read_png, write_png

WIDTH = HEIGHT = 1024
MAX_DEPTH = 8
RR_START = 1
SPP = 4


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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda", 0)

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
    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_per_sample": ms,
        "plain_ms_per_sample": plain_ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "max_depth": MAX_DEPTH,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
