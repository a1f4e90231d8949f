"""Command-line entry points: render / info (port of
computeraytracer_tpu/cli.py).

    python -m computeraytracer_tpu_torch render --preset cornell_box \
        --spp 16 --out cornell.png
    python -m computeraytracer_tpu_torch render --scene my_scene.json \
        --device cpu --spp 4 --out out.png

The flags are the JAX CLI's. ``--sharded``, ``--bvh`` and ``--profile``
are not ported yet and raise when given; ``train`` arrives with the
training slice. ``--device`` (default ``cuda``) picks where the scene
lives: there is no silent move to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

_NOT_PORTED = ("sharded", "bvh", "profile")


def _load(args):
    from computeraytracer_tpu_torch.scene import (load_scene, presets,
                                                  scene_from_dict)

    device = getattr(args, "device", None)
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


def cmd_render(args) -> int:
    import torch

    from computeraytracer_tpu_torch.ops import color
    from computeraytracer_tpu_torch.tracer import kernel as kernel_tracer
    from computeraytracer_tpu_torch.tracer.api import render
    from computeraytracer_tpu_torch.utils.image import write_png
    from computeraytracer_tpu_torch.utils.metrics import RenderMeter

    for flag in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported to computeraytracer_tpu_torch yet")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to render with the plain torch kernels)")
    scene, w, h = _load(args)

    def sync():
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)

    meter = RenderMeter(jsonl_path=args.metrics)
    meter.start()
    if args.progressive:
        # render in --progressive N sample chunks, rewriting --out from the
        # running accumulator after each; counter-based seeding makes the
        # chunked sum equal to one --spp shot
        if args.kernel != "pallas":
            raise NotImplementedError(
                f"--kernel {args.kernel} is not ported yet")
        accum = None
        done = 0
        while done < args.spp:
            n = min(args.progressive, args.spp - done)
            part = kernel_tracer.render_accumulate(
                scene, w, h, spp=n, max_depth=args.depth,
                first_sample=done + 1)
            accum = part if accum is None else accum + part
            done += n
            write_png(args.out, color.xyz_to_srgb(accum / float(done),
                                                  args.exposure))
            print(f"progressive: {done}/{args.spp} spp -> {args.out}",
                  file=sys.stderr)
    else:
        accum = render(scene, width=w, height=h, spp=args.spp,
                       max_depth=args.depth, kernel=args.kernel)["accum_xyz"]
    sync()
    rec = meter.stop(paths=w * h * args.spp, width=w, height=h,
                     spp=args.spp, kernel=args.kernel,
                     device=str(scene.device))
    print(json.dumps(rec), file=sys.stderr)

    srgb = color.xyz_to_srgb(accum / float(args.spp), args.exposure)
    write_png(args.out, srgb)
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp, "
          f"{rec['mpaths_per_s']} Mpaths/s on {scene.device})")
    return 0


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
    r.add_argument("--bvh", choices=["auto", "on", "off"], default=None,
                   help="not ported yet: raises when given")
    r.add_argument("--sharded", action="store_true",
                   help="not ported yet: raises when given")
    r.add_argument("--exposure", type=float, default=2.2)
    r.add_argument("--progressive", type=int, default=0, metavar="N",
                   help="rewrite --out every N samples from the running "
                   "accumulator")
    r.add_argument("--metrics", help="append metrics JSONL here")
    r.add_argument("--profile", help="not ported yet: raises when given")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="print scene summary")
    common(i)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
