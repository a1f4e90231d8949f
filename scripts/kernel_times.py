#!/usr/bin/env python3
"""Time the kernels of one checkout of the port on a CUDA card.

    python3 scripts/kernel_times.py [ROOT] [--parts cornell,tri_rows,mesh,e2e]

ROOT (default: the checkout holding this script) is the root of a
checkout of the repository; its package is imported and its kernels are
built from its own sources. The workloads, the timer (CUDA events, the
mean of a few calls after a warm-up) and the recorders of the wavefront's
launches and casts are those of ``chip_smoke.py`` beside this script, run
on ROOT's package. The script prints the card's name and power limit,
each kernel's name, registers and spills from ``-Xptxas -v``, and one
JSON line of times in ms:
- ``cornell``: the forward, taped forward, retrace backward and tape-fed
  backward per sample at Cornell 1024^2, depth 8 (phases 5, 8 and 10),
  and the sections of both backward kernels from their sweep's timed
  build (``sections``: each section's share of the clock64() cycles
  summed over warps, and the timed build's own ms; the retrace kernel's
  replay is the taped forward's launch; absent where ROOT's package has
  no timed build), and the bounce loop's schedule (``schedule``:
  ``chip_smoke.py`` ``_schedule``, the one-thread schedule's SIMT
  efficiency from the taped forward's tape and the refill schedule's
  counted lane and warp trips; where ROOT's package has no refill
  schedule, the efficiency from the tape alone);
- ``tri_rows``: the same at ``mesh_scene(1024, 1024, 1)``, 80 triangle
  rows, depth 3 (phase 12);
- ``mesh``: at ``mesh_scene(1024, 1024, 6)``, 81,920 triangles in one
  mesh part, depth 3 (phases 11, 13, 17 and 19): the mesh-mode forward
  and the winner-taped forward per sample, one ``wavefront=True`` sample
  (host reads included), every launch of that sample's wavefront kernels
  in launch order (``shade``, ``candidates``, ``pair_closest``,
  ``pair_any``, ``walk``, with the walks' active rays), and each of its
  casts walked whole as phase 19 seeds it (``walk_casts``).
- ``e2e``: the served render (``tracer.api.render``, Cornell 1024^2,
  spp 4, depth 8; phase 4) and one retrace training step (phase 7's
  ``value_and_grad``), each on the host clock around work that ends in a
  synchronize (``render_ms``, ``step_ms``: a few runs after a warm-up)
  and as device time under torch.profiler (``render_device_ms``,
  ``step_device_ms``: one run each).
Compare two checkouts in turns within one call (parent, change, change,
parent): times taken on different cards or calls differ by a few percent.
``--parts`` runs only the named parts (all four by default).
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
REPS = {"cornell": 10, "tri_rows": 10, "mesh": 3, "e2e": 3}


def _chip_smoke():
    """chip_smoke.py beside this script, importing ROOT's package."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _four_kernels(cs, static, depth, args, seed):
    """The forward, taped forward and both backward kernels on args."""
    mk, torch = cs.mk, cs.torch
    R = args[1].shape[1]
    dL = torch.randn((4, R), generator=torch.Generator(device=args[1].device)
                     .manual_seed(seed), device=args[1].device)
    _, tape_f, tape_i = mk.forward_taped(static, depth, cs.RR_START, *args)
    return {
        "forward": lambda: mk.forward(static, depth, cs.RR_START, *args),
        "forward_taped": lambda: mk.forward_taped(static, depth, cs.RR_START,
                                                  *args),
        "backward": lambda: mk.backward(static, depth, cs.RR_START, *args,
                                        dL),
        "backward_from_tape": lambda: mk.backward_from_tape(
            static, depth, cs.RR_START, args[0], args[3], tape_f, tape_i,
            dL),
    }


def _sections(cs, static, depth, args, seed, reps):
    """The timed builds of both backward kernels on args (chip_smoke.py
    _sections: each section's share of the cycles, the cycles and the
    timed build's ms); None when the package has no timed build."""
    mk, torch = cs.mk, cs.torch
    if not hasattr(mk, "SWEEP_SECTIONS"):
        return None
    R = args[1].shape[1]
    dL = torch.randn((4, R), generator=torch.Generator(device=args[1].device)
                     .manual_seed(seed), device=args[1].device)
    _, tape_f, tape_i = mk.forward_taped(static, depth, cs.RR_START, *args)
    return {
        "backward": cs._sections(lambda t: mk.backward(
            static, depth, cs.RR_START, *args, dL, times=t), reps),
        "backward_from_tape": cs._sections(lambda t: mk.backward_from_tape(
            static, depth, cs.RR_START, args[0], args[3], tape_f, tape_i, dL,
            times=t), reps)}


def _schedule(cs, static, depth, args):
    """The bounce loop's schedule at args (chip_smoke.py _schedule); for a
    package without the refill schedule, the one-thread schedule's SIMT
    efficiency from the tape alone (warps of 32 consecutive rays)."""
    mk, torch = cs.mk, cs.torch
    if hasattr(mk, "TRIP_COUNTS"):
        return cs._schedule(static, depth, args, mk.forward(
            static, depth, cs.RR_START, *args))
    _, _, tape_i = mk.forward_taped(static, depth, cs.RR_START, *args)
    R = tape_i.shape[1]
    trips = tape_i.reshape(-1, mk.TAPE_I, R)[:, 7].to(torch.int64).sum(0)
    warps = torch.nn.functional.pad(trips, (0, -R % 32)).reshape(-1, 32)
    return {"mean_trips": trips.double().mean().item(),
            "simt_efficiency_one_thread":
                trips.sum().item() / (32 * warps.amax(dim=1).sum().item())}


def _film(cs, scene, static, dev):
    kt = cs.kt
    px, py = kt.tile_coords(cs.WIDTH, cs.HEIGHT, 0, dev)
    return kt.kernel_inputs(scene, *kt.camera_planes(
        scene, cs.WIDTH, cs.HEIGHT, px, py, 1), static)


def main() -> int:
    argv = sys.argv[1:]
    parts = set(REPS)
    if "--parts" in argv:
        k = argv.index("--parts")
        parts = set(argv[k + 1].split(","))
        del argv[k:k + 2]
    root = pathlib.Path(argv[0] if argv else HERE)
    sys.path.insert(0, str(root.resolve()))
    cs = _chip_smoke()
    torch, mk, bn, kt = cs.torch, cs.mk, cs.bn, cs.kt
    presets, scene_from_dict = cs.presets, cs.scene_from_dict

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip())
    cs._build.build_all()
    for src, log in cs._build.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas[{src}]: {line.strip()}")
    dev = torch.device("cuda", 0)
    timed = lambda fns, reps: {k: cs._events_ms(fn, reps)
                               for k, fn in fns.items()}
    ms = {}

    for part, doc, depth, seed in (
            ("cornell", presets.cornell_box(cs.WIDTH, cs.HEIGHT),
             cs.MAX_DEPTH, 0),
            ("tri_rows", presets.mesh_scene(cs.WIDTH, cs.HEIGHT,
                                            cs.TRI_SUBDIVISIONS),
             cs.MESH_DEPTH, 1)):
        if part not in parts:
            continue
        scene, _ = scene_from_dict(doc, device=dev)
        static = mk.SceneStatic.from_scene(scene)
        args = _film(cs, scene, static, dev)
        ms[part] = timed(_four_kernels(cs, static, depth, args, seed),
                         REPS[part])
        ms[part]["sections"] = _sections(cs, static, depth, args, seed,
                                         REPS[part])
        ms[part]["schedule"] = _schedule(cs, static, depth, args)
    if "e2e" in parts:
        scene, _ = scene_from_dict(presets.cornell_box(cs.WIDTH, cs.HEIGHT),
                                   device=dev)
        static = mk.SceneStatic.from_scene(scene)
        cfg = cs.RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, spp=cs.SPP,
                              max_depth=cs.MAX_DEPTH, kernel="pallas")
        step = lambda: cs._vg(cs._train_leaves(scene)[2], static)
        e2e = {}
        for key, fn in (("render", lambda: cs.render(scene, cfg)),
                        ("step", step)):
            fn()
            e2e[key + "_ms"] = [cs._host_s(fn)[0] * 1e3
                                for _ in range(REPS["e2e"])]
            e2e[key + "_device_ms"] = cs._profile(fn)[1]
        ms["e2e"] = e2e
    if "mesh" not in parts:
        print(json.dumps({"root": str(root), "device":
                          torch.cuda.get_device_name(0), "ms": ms}))
        return 0

    scene, _ = scene_from_dict(presets.mesh_scene(cs.WIDTH, cs.HEIGHT,
                                                  cs.MESH_SUBDIVISIONS),
                               device=dev)
    static = mk.SceneStatic.from_scene(scene)
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    args = _film(cs, scene, static, dev)
    reps = REPS["mesh"]
    mesh = timed({
        "mesh": lambda: mk.forward(static, cs.MESH_DEPTH, cs.RR_START, *args,
                                   *arrays),
        "winners": lambda: mk.forward_winners(static, cs.MESH_DEPTH,
                                              cs.RR_START, *args, *arrays),
        "wavefront": lambda: kt.wavefront_forward(
            static, cs.MESH_DEPTH, cs.RR_START, *args, *arrays),
    }, reps)
    rad, calls = cs._recorded_wavefront(static, args, arrays)
    if not torch.equal(rad, mk.forward(static, cs.MESH_DEPTH, cs.RR_START,
                                       *args, *arrays)):
        raise RuntimeError("the wavefront's radiance is not the mesh "
                           "kernel's")
    for kind, (mod, attr, _) in cs.WAVEFRONT_KERNELS.items():
        mesh[kind] = [cs._events_ms(lambda: getattr(mod, attr)(*a, **k),
                                    reps)
                      for c, a, k, _ in calls if c == kind]
    mesh["walk_rays"] = [int((a[2][0] > -math.inf).sum())
                         for c, a, _, _ in calls if c == "walk"]
    mesh["walk_casts"] = [
        cs._events_ms(lambda c=c: cs._walk_seeded(static, arrays, *c[1:]),
                      reps)
        for c in cs._recorded_casts(static, args, arrays)]
    for key in ("walk", "walk_casts"):
        mesh[key + "_sum"] = sum(mesh[key])
    ms["mesh"] = mesh
    print(json.dumps({"root": str(root), "device":
                      torch.cuda.get_device_name(0), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
