"""Command-line entry points: render / train / info (port of
computeraytracer_tpu/cli.py).

    python -m computeraytracer_tpu_torch render --preset cornell_box \
        --spp 16 --out cornell.png
    python -m computeraytracer_tpu_torch render --scene my_scene.json \
        --device cpu --spp 4 --out out.png
    python -m computeraytracer_tpu_torch train --preset cornell_box \
        --steps 30 --backward pallas_taped

    python -m computeraytracer_tpu_torch render --preset mesh_scene \
        --width 256 --height 256 --spp 4 --depth 3 --out mesh.png
    python -m computeraytracer_tpu_torch render --preset mesh_scene \
        --kernel xla --bvh on --width 64 --height 64 --spp 1 --depth 3

The flags are the JAX CLI's. ``--kernel xla`` renders and trains through
the eager tracer; ``--bvh auto|on|off`` builds a BVH for it (auto: above
64 primitives with ``--kernel xla``). ``--profile DIR`` writes a
``torch.profiler`` trace of the render (utils/profiling.py) under DIR.
``--sharded`` renders over a (dp, sp) mesh of the running world
(parallel/): under torchrun, one rank per device,

    torchrun --nproc-per-node 4 -m computeraytracer_tpu_torch render \
        --sharded --preset cornell_box --spp 16 --out cornell.png

and without a launcher, a world of one. Only rank 0 writes ``--out``,
``--metrics`` and the summary line.
``--device`` (default ``cuda``) picks where the scene of ``render`` and
``train`` lives: there is no silent move to the CPU. ``info`` traces
nothing and reads the scene on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

# --bvh auto builds a BVH for the eager tracer above this many primitives.
BVH_AUTO_MIN = 64


def _load(args):
    from computeraytracer_tpu_torch.scene import (load_scene, presets,
                                                  scene_from_dict)

    device = getattr(args, "device", "cpu")
    if args.scene:
        scene, meta = load_scene(args.scene, args.cie, device=device)
    else:
        w = args.width or 256
        h = args.height or 256
        doc = getattr(presets, args.preset)(w, h)
        scene, meta = scene_from_dict(doc, device=device)
    w = args.width or meta["width"]
    h = args.height or meta["height"]
    return scene, w, h


def _require_device(device: str) -> None:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device is available (pass "
            "--device cpu to run the plain torch kernel versions)")


def _scene_bvh(args, scene):
    """The BVH --bvh asks for (printing its node count), or None."""
    from computeraytracer_tpu_torch.bvh import builder

    n_prims = int(scene.primitives.category.shape[0])
    if not (args.bvh == "on" or (args.bvh == "auto" and n_prims > BVH_AUTO_MIN
                                 and args.kernel == "xla")):
        return None
    t0 = time.perf_counter()
    bvh = builder.scene_bvh(scene)
    print(f"BVH: {bvh.n_nodes} nodes over {n_prims} primitives "
          f"({time.perf_counter() - t0:.2f}s)", file=sys.stderr)
    return builder.to_device(bvh, scene.device)


@contextlib.contextmanager
def _world(device: str):
    """The process group of --sharded: torchrun's (from its environment),
    else a world of one over a file store; destroyed on exit."""
    from computeraytracer_tpu_torch.parallel import distributed

    device_type = "cpu" if device == "cpu" else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            if not distributed.initialize(device_type=device_type):
                distributed.initialize(
                    "file://" + os.path.join(tmp, "store"), 1, 0,
                    device_type=device_type)
            yield
        finally:
            distributed.shutdown()


def _render_accum(args, scene, w, h, bvh):
    """The summed XYZ of --spp samples, by --kernel (``tracer.api``); with
    --sharded, over make_mesh() of the running world; with --progressive
    N, rendered in N-sample chunks, --out rewritten after each (and
    --sharded ignored)."""
    from computeraytracer_tpu_torch.ops import color
    from computeraytracer_tpu_torch.tracer import api
    from computeraytracer_tpu_torch.utils.image import write_png

    if args.sharded and not args.progressive:
        from computeraytracer_tpu_torch.parallel import mesh as mesh_mod
        from computeraytracer_tpu_torch.parallel import render_sharded
        return render_sharded.render_accumulate_sharded(
            scene, w, h, args.spp, mesh_mod.make_mesh(), max_depth=args.depth,
            bvh=bvh, kernel=args.kernel)
    if not args.progressive:
        return api.render_accumulate(scene, w, h, args.spp, args.depth,
                                     kernel=args.kernel, bvh=bvh)
    if args.sharded:
        print("--progressive ignores --sharded (single-host loop)",
              file=sys.stderr)
    # counter-based seeding makes the chunked sum equal to one --spp shot
    accum = None
    done = 0
    while done < args.spp:
        n = min(args.progressive, args.spp - done)
        part = api.render_accumulate(scene, w, h, n, args.depth,
                                     first_sample=done + 1,
                                     kernel=args.kernel, bvh=bvh)
        accum = part if accum is None else accum + part
        done += n
        write_png(args.out, color.xyz_to_srgb(accum / float(done),
                                              args.exposure))
        print(f"progressive: {done}/{args.spp} spp -> {args.out}",
              file=sys.stderr)
    return accum


def cmd_render(args) -> int:
    _require_device(args.device)
    if args.sharded and not args.progressive:
        # the group sets each rank's card before the scene is loaded on it
        with _world(args.device):
            return _render(args)
    return _render(args)


def _render(args) -> int:
    import torch
    import torch.distributed as dist

    from computeraytracer_tpu_torch.ops import color
    from computeraytracer_tpu_torch.utils import profiling
    from computeraytracer_tpu_torch.utils.image import write_png
    from computeraytracer_tpu_torch.utils.metrics import RenderMeter

    lead = not dist.is_initialized() or dist.get_rank() == 0
    scene, w, h = _load(args)
    bvh = _scene_bvh(args, scene)

    tracing = contextlib.nullcontext()
    if args.profile:
        tracing = profiling.trace(args.profile, scene.device)
        print(f"tracing to {args.profile} (a Chrome trace JSON file)",
              file=sys.stderr)
    meter = RenderMeter(jsonl_path=args.metrics if lead else None)
    with tracing:
        meter.start()
        with profiling.annotate("render"):
            accum = _render_accum(args, scene, w, h, bvh)
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
    rec = meter.stop(paths=w * h * args.spp, width=w, height=h,
                     spp=args.spp, kernel=args.kernel,
                     device=str(scene.device))
    if not lead:
        return 0
    print(json.dumps(rec), file=sys.stderr)

    srgb = color.xyz_to_srgb(accum / float(args.spp), args.exposure)
    write_png(args.out, srgb)
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp, "
          f"{rec['mpaths_per_s']} Mpaths/s on {scene.device})")
    return 0


def cmd_train(args) -> int:
    import torch

    from computeraytracer_tpu_torch.train import optimize as opt

    _require_device(args.device)
    scene, w, h = _load(args)
    w, h = min(w, args.max_side), min(h, args.max_side)
    print(f"rendering target at {w}x{h} spp={args.spp} ...", file=sys.stderr)
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, w, h, spp=args.spp,
                                     max_depth=args.depth, kernel=args.kernel)
    # Demo inverse problem: dim one albedo spectrum, recover it.
    spectra = scene.spectra.clone()
    spectra[args.perturb_row] = spectra[args.perturb_row] * 0.3
    perturbed = dataclasses.replace(scene, spectra=spectra)
    _, losses = opt.optimize(
        perturbed, target, w, h, trainable=tuple(args.trainable),
        steps=args.steps, learning_rate=args.lr, spp=args.spp,
        max_depth=args.depth, kernel=args.kernel, backward=args.backward,
        checkpoint_dir=args.checkpoint_dir,
        callback=lambda i, loss, p: print(
            f"step {i:4d}  loss {loss:.6e}", file=sys.stderr))
    print(json.dumps({"initial_loss": losses[0], "final_loss": losses[-1],
                      "steps": len(losses)}))
    return 0 if losses[-1] < losses[0] else 1


def cmd_info(args) -> int:
    scene, w, h = _load(args)
    cats = scene.primitives.category
    print(json.dumps({
        "resolution": [w, h],
        "primitives": int(cats.shape[0]),
        "patches": int((cats == 0).sum()),
        "spheres": int((cats == 1).sum()),
        "triangles": int((cats == 2).sum()),
        "lights": int(scene.lights.prim_index.shape[0]),
        "spectra": int(scene.spectra.shape[0]),
    }, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="computeraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--scene", help="scene JSON (reference schema)")
        p.add_argument("--cie", help="CIE.json (reference schema)")
        p.add_argument("--preset", default="cornell_box",
                       help="preset name when --scene absent")
        p.add_argument("--width", type=int)
        p.add_argument("--height", type=int)
        p.add_argument("--spp", type=int, default=16)
        p.add_argument("--depth", type=int, default=8)

    r = sub.add_parser("render", help="render a scene to PNG")
    common(r)
    r.add_argument("--out", default="out.png")
    r.add_argument("--kernel", choices=["xla", "pallas"], default="pallas")
    r.add_argument("--device", default="cuda",
                   help="torch device of the scene (default: cuda)")
    r.add_argument("--bvh", choices=["auto", "on", "off"], default="auto",
                   help="BVH for --kernel xla (auto: above "
                   f"{BVH_AUTO_MIN} primitives)")
    r.add_argument("--sharded", action="store_true",
                   help="render over a (dp, sp) mesh of the running world "
                   "(torchrun's ranks, else a world of one)")
    r.add_argument("--exposure", type=float, default=2.2)
    r.add_argument("--progressive", type=int, default=0, metavar="N",
                   help="rewrite --out every N samples from the running "
                   "accumulator")
    r.add_argument("--metrics", help="append metrics JSONL here")
    r.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the render under "
                   "DIR")
    r.set_defaults(fn=cmd_render)

    t = sub.add_parser("train", help="gradient-based scene optimization")
    common(t)
    t.add_argument("--kernel", choices=["xla", "pallas"], default="pallas",
                   help="xla: the eager tracer under autograd")
    t.add_argument("--backward", choices=["pallas", "pallas_taped"],
                   default="pallas",
                   help="the kernel path's backward: the retrace kernel or "
                   "the taped forward with the tape-fed kernel")
    t.add_argument("--steps", type=int, default=30)
    t.add_argument("--lr", type=float, default=0.05)
    t.add_argument("--trainable", nargs="+", default=["spectra"])
    t.add_argument("--perturb-row", type=int, default=2)
    t.add_argument("--max-side", type=int, default=128)
    t.add_argument("--checkpoint-dir")
    t.add_argument("--device", default="cuda",
                   help="torch device of the scene (default: cuda)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("info", help="print scene summary")
    common(i)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
