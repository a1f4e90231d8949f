#!/usr/bin/env python3
"""Time the kernels of one checkout of the port on a CUDA card.

    python3 scripts/kernel_times.py [ROOT] \
        [--parts cornell,tri_rows,mesh,e2e,binned,setup,finish,wide]

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
  no timed build), the bounce loop's schedule (``schedule``:
  ``chip_smoke.py`` ``_schedule``, the one-thread schedule's SIMT
  efficiency from the taped forward's tape, the refill schedule's
  counted lane and warp trips and, where ROOT's package has the taped
  forward's group schedule, its counted SIMT efficiency beside the
  model's; where ROOT's package has no refill schedule, the efficiency
  from the tape alone), and the SHA-256 of the taped forward's radiance,
  tape_f and tape_i bytes in that order (``taped_sha256``: equal in two
  checkouts when their taped forwards write the same tape);
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
  spp 4, depth 8; phase 4), one retrace training step (phase 7's
  ``value_and_grad``) and one tape-fed step (phase 10's, ``step_taped``),
  each on the host clock around work that ends in a synchronize
  (``render_ms``, ``step_ms``, ``step_taped_ms``: a few runs after a
  warm-up) and under torch.profiler (one run each): device time
  (``*_device_ms``), idle share (``*_idle``) and the device time of the
  taped forward's kernel (``*_taped_kernel_ms``: the retrace step's
  replay, the tape-fed step's taped forward; either tree's kernel).
- ``binned``: at the same workload, the binned casts' kernels alone:
  each candidate, ``pair_closest`` and ``pair_any`` launch of one
  wavefront sample timed, the candidate kernel's counting build per
  launch (active rays, slab tests, the chunk loop's warp and lane trips
  and their SIMT efficiency, lane trips over 32 per warp trip), the pair
  scans' timed build per launch where ROOT's package has one
  (``bn.pair_sections``: each section's share of the lanes' clock64()
  cycles), and the SASS of ``csrc/pair.cu`` and ``csrc/candidates.cu``
  (``cuobjdump -sass``, written to ``sass/`` in ROOT's kernel build
  directory, ``kernels/build/``, with each
  kernel's instruction count printed).
- ``setup``: the per-sample setup's kernels at Cornell 1024^2 (phase
  29's shape: the ray setup alone and through its wrapper, the hero
  gather of the spectra and CIE tables in one launch and of the spectra
  alone, the column sums of a (24, R) cotangent; the ray setup's, the
  gather's and the column sums' device time under torch.profiler, the
  mean of the launches it records) beside the PyTorch calls
  that compute the same (``table[:, hero]``, ``index_put_`` with
  accumulate, ``index_add_``), and the retrace and tape-fed training
  steps (phase 10): host ms, and under torch.profiler device ms, idle
  share, kernel launches, host-issued ops and top kernels. ROOT's package
  needs ``kernels/setup.py`` with ``hero_gather_tables`` and the
  ray-setup kernel that reads the camera's tensors; an older checkout's
  own copy of this script times its own.
- ``finish``: a rendered frame's tail on a frame's planar XYZ sum,
  Cornell 1024^2 (spp 4, depth 8) and rtnw-final 800^2 (spp 1, depth
  40): the finish kernel (``kernels/setup.py`` ``finish_frame``, phase 34)
  in turns with the torch tail it replaced (``chip_smoke.py``
  ``_finish_tail``; kernel, tail, tail, kernel), its device time under
  torch.profiler, its plain version's time and its bound. ROOT's package
  needs ``finish_frame``.
- ``wide``: the forward's global-table builds a sample at 800^2, depth 40
  (phases 32, 33 and 35): on rtnw-final the radiance build
  (``refill_fwd_wide``) and the XYZ build (``refill_fwd_wide_xyz``), and,
  where ROOT's package takes mesh parts past the shared tables, the mesh
  build (``refill_fwd_wide_mesh``) on rtnw-final-mesh, the same geometry
  with its ground as a mesh.
Compare two checkouts in turns within one call (parent, change, change,
parent): times taken on different cards or calls differ by a few percent.
``--parts`` runs only the named parts (all eight by default).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
REPS = {"cornell": 10, "tri_rows": 10, "mesh": 3, "e2e": 3, "binned": 5,
        "setup": 20, "finish": 20, "wide": 3}
# The taped forward's kernel in either tree: the group schedule, or the
# one-thread kernel that ran it before (not launched by a Cornell step of
# a tree with the group schedule).
TAPED_KERNELS = ("group_taped_kernel", "megakernel_fwd_kernel")


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


def _taped_sha256(cs, static, depth, args):
    """SHA-256 of one taped forward's radiance, tape_f and tape_i bytes."""
    sha = hashlib.sha256()
    for t in cs.mk.forward_taped(static, depth, cs.RR_START, *args):
        sha.update(t.cpu().numpy().tobytes())
    return sha.hexdigest()


def _sass(cs, root):
    """cuobjdump -sass of the pair and candidate libraries, written to
    sass/ in the kernel build directory; {kernel symbol: instruction
    count}."""
    build = cs._build
    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    out_dir = build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    for stem in ("pair", "candidates"):
        lib = next(build.BUILD_DIR.glob(f"{stem}.*.so"))
        sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
        (out_dir / f"{root.name or 'root'}_{stem}.sass").write_text(sass)
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = 0
            elif name and line.strip().startswith("/*") and "*/" in line \
                    and line.strip()[2:6].strip().isalnum():
                counts[name] += 1
    return counts


def _binned(cs, static, args, arrays, reps):
    """The binned casts' kernels of one wavefront sample on args: times,
    the candidate kernel's per-launch counts and the pair scans' sections."""
    torch, bn, mk = cs.torch, cs.bn, cs.mk
    _, calls = cs._recorded_wavefront(static, args, arrays)
    out = {"candidates": [], "pair_closest": [], "pair_any": []}
    for kind, a, k, _ in calls:
        if kind not in out:
            continue
        mod, attr, _ = cs.WAVEFRONT_KERNELS[kind]
        entry = {"ms": cs._events_ms(lambda: getattr(mod, attr)(*a, **k),
                                     reps)}
        work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64,
                           device=a[0].device)
        getattr(mod, attr)(*a, work=work)
        w = work.tolist()
        if kind == "candidates":
            entry.update(rays=w[0], slab_tests=w[1], warp_trips=w[4],
                         lane_trips=w[5],
                         simt_efficiency=w[5] / max(32 * w[4], 1))
        else:
            entry.update(live=w[0], plane_tests=w[2], inside_tests=w[3])
            if hasattr(bn, "pair_sections"):
                t = bn.pair_sections(*a, kind == "pair_any").tolist()
                entry["sections"] = {
                    name: t[i] / max(t[-1], 1)
                    for i, name in enumerate(bn.PAIR_SECTIONS[:-1])}
                entry["loop_cycles_per_plane_test"] = t[-1] / max(w[2], 1)
        out[kind].append(entry)
    for kind in list(out):
        out[kind + "_sum_ms"] = sum(e["ms"] for e in out[kind])
    return out


def _setup(cs, dev):
    """The setup part: its kernels and the PyTorch calls beside them, and
    the two training steps."""
    torch, kt, spec, setup_k = cs.torch, cs.kt, cs.spec, cs.setup_k
    scene, _ = cs.scene_from_dict(cs.presets.cornell_box(cs.WIDTH, cs.HEIGHT),
                                  device=dev)
    static = cs.mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(cs.WIDTH, cs.HEIGHT, 0, dev)
    cam = scene.camera
    hero = setup_k.ray_setup(cam, cs.WIDTH, cs.HEIGHT, px, py, 1)[2]
    spect_t = spec.expand_hero_table(scene.spectra)
    cie_t = spec.cie_window_exp(scene.cie)
    g = torch.randn((spect_t.shape[0], px.shape[0]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    zeros = torch.zeros(spect_t.shape, device=dev)
    n_cols = spect_t.shape[1]
    operands = (cam.eye, cam.lookat, cam.up, cam.fov)
    ray_setup = lambda: setup_k.ray_setup(cam, cs.WIDTH, cs.HEIGHT, px, py,
                                          1)
    column_sums = lambda: setup_k.hero_column_sums(g, hero, n_cols)
    out = {k: cs._events_ms(fn, REPS["setup"]) for k, fn in {
        "ray_setup": lambda: setup_k.ray_setup_launch(
            *operands, cs.WIDTH, cs.HEIGHT, px, py, 1),
        "ray_setup_wrapper": ray_setup,
        "gather": lambda: setup_k.hero_gather_tables((spect_t, cie_t), hero),
        "gather_spectra": lambda: setup_k.hero_gather(spect_t, hero),
        "index": lambda: spect_t[:, hero],
        "column_sums": column_sums,
        "index_put_accumulate": lambda: torch.ops.aten.index_put_(
            zeros.clone(), [None, hero], g, True),
        "index_add": lambda: zeros.clone().index_add_(1, hero, g),
    }.items()}
    (out["ray_setup_device_ms"], _,
     out["ray_setup_profiled_launches"]) = cs._kernel_device_ms(
        ray_setup, REPS["setup"], "ray_setup")
    out["gather_device_ms"] = cs._kernel_device_ms(
        lambda: setup_k.hero_gather_tables((spect_t, cie_t), hero),
        REPS["setup"], "hero_gather")[0]
    (out["column_sums_device_ms"], out["column_sums_device_ms_passes"],
     out["column_sums_profiled_launches"]) = cs._kernel_device_ms(
        column_sums, REPS["setup"], "hero_sort", "hero_sums", "hero_reduce")
    for bw in ("pallas", "pallas_taped"):
        def step():
            return cs._vg(cs._train_leaves(scene)[2], static, bw)
        step()
        out[bw + "_step_ms"] = [cs._host_s(step)[0] * 1e3
                                for _ in range(REPS["e2e"])]
        wall, dev_ms, idle, n_k, top, n_ops = cs._profile(step, top=8,
                                                          host_ops=True)
        out[bw + "_step_profile"] = {
            "wall_ms": wall, "device_ms": dev_ms, "idle": idle,
            "launches": n_k, "host_ops": n_ops, "top": top}
    return out


def _finish(cs, dev):
    """The finish part: the finish kernel and the torch tail in turns on
    Cornell's and rtnw-final's frames."""
    kt, setup_k = cs.kt, cs.setup_k
    with open(cs.WIDE_CONFIG) as f:
        wide_doc = json.load(f)["scene"]
    out = {}
    for name, doc, side, spp, depth in (
            ("cornell", cs.presets.cornell_box(cs.WIDTH, cs.HEIGHT),
             cs.WIDTH, cs.SPP, cs.MAX_DEPTH),
            ("rtnw-final", wide_doc, cs.WIDE_SIDE, 1, cs.WIDE_DEPTH)):
        scene, _ = cs.scene_from_dict(doc, device=dev)
        planar = kt.accumulate_pixels(scene, side, side, None, None, 1, spp,
                                      depth)[1]
        kernel = lambda: setup_k.finish_frame(planar, spp, side, side)
        tail = lambda: cs._finish_tail(planar, spp, side, side)
        turns = [(nm, cs._events_ms(fn, REPS["finish"])) for nm, fn in (
            ("kernel", kernel), ("tail", tail), ("tail", tail),
            ("kernel", kernel))]
        device = cs._kernel_device_ms(kernel, REPS["finish"],
                                      "finish_frame")[0]
        plain = cs._events_ms(lambda: setup_k.finish_frame_reference(
            planar, spp, side, side), REPS["finish"])
        out[name] = {"turns": turns, "device_ms": device, "plain_ms": plain,
                     "bound_ms": cs._bound(4 * planar.numel() * 4, 0)[0]}
    return out


def _wide(cs, dev):
    """The wide part: the global-table builds on rtnw-final and, where
    ROOT's package has it, rtnw-final-mesh, sample 1."""
    mk, kt, spec, torch = cs.mk, cs.kt, cs.spec, cs.torch
    side, depth = cs.WIDE_SIDE, cs.WIDE_DEPTH
    px, py = kt.tile_coords(side, side, 0, dev)

    def case(path):
        with open(path) as f:
            scene, _ = cs.scene_from_dict(json.load(f)["scene"], device=dev)
        static = mk.SceneStatic.from_scene(scene)
        planes = kt.camera_planes(scene, side, side, px, py, 1)
        return scene, static, planes, kt.kernel_inputs(scene, *planes,
                                                       static)

    scene, static, (o, d, hero, seed), args = case(cs.WIDE_CONFIG)
    setup = kt.setup_operands(scene, static)
    spect, cie = spec.gather_hero_tables(
        (setup.spect_table, setup.cie_table), hero)
    accum = torch.zeros((3, px.numel()), device=dev)
    fns = {"forward_wide": lambda: mk.forward(static, depth, cs.RR_START,
                                              *args),
           "forward_wide_xyz": lambda: mk.forward_xyz(
               static, depth, cs.RR_START, setup.prims, o, d, seed, spect,
               cie, accum, mk._ray_counter(dev))}
    out = {k: cs._events_ms(fn, REPS["wide"]) for k, fn in fns.items()}
    # built after the timings above, so that both trees time them after
    # the same allocations
    if hasattr(mk, "launches_wide_mesh"):
        m_scene, m_static, _, m_args = case(cs.WIDE_MESH_CONFIG)
        arrays = tuple(a for p in kt.mesh_packs_for(m_scene, m_static)
                       for a in p.arrays)
        out["forward_wide_mesh"] = cs._events_ms(lambda: mk.forward(
            m_static, depth, cs.RR_START, *m_args, *arrays), REPS["wide"])
    return out


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
        if part == "cornell":
            ms[part]["taped_sha256"] = _taped_sha256(cs, static, depth, args)
            print(f"taped forward sha256: {ms[part]['taped_sha256']}")
    if "e2e" in parts:
        scene, _ = scene_from_dict(presets.cornell_box(cs.WIDTH, cs.HEIGHT),
                                   device=dev)
        static = mk.SceneStatic.from_scene(scene)
        cfg = cs.RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, spp=cs.SPP,
                              max_depth=cs.MAX_DEPTH, kernel="pallas")
        e2e = {}
        for key, fn in (
                ("render", lambda: cs.render(scene, cfg)),
                ("step", lambda: cs._vg(cs._train_leaves(scene)[2], static)),
                ("step_taped", lambda: cs._vg(cs._train_leaves(scene)[2],
                                              static, "pallas_taped"))):
            fn()
            e2e[key + "_ms"] = [cs._host_s(fn)[0] * 1e3
                                for _ in range(REPS["e2e"])]
            _, dev_ms, idle, _, _, named = cs._profile(fn,
                                                       named=TAPED_KERNELS)
            e2e[key + "_device_ms"] = dev_ms
            e2e[key + "_idle"] = idle
            e2e[key + "_taped_kernel_ms"] = sum(named.values())
        ms["e2e"] = e2e
    if "setup" in parts:
        ms["setup"] = _setup(cs, dev)
    if "finish" in parts:
        ms["finish"] = _finish(cs, dev)
    if "wide" in parts:
        ms["wide"] = _wide(cs, dev)
    if "binned" in parts:
        print(f"sass instructions: {_sass(cs, root)}")
    if not parts & {"mesh", "binned"}:
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
    if "binned" in parts:
        ms["binned"] = _binned(cs, static, args, arrays, REPS["binned"])
    if "mesh" not in parts:
        print(json.dumps({"root": str(root), "device":
                          torch.cuda.get_device_name(0), "ms": ms}))
        return 0
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
