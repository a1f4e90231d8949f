#!/usr/bin/env python3
"""Time the Cornell-box kernels of one checkout of the port on a CUDA card.

    python3 scripts/kernel_times.py [ROOT]

ROOT (default: the checkout holding this script) is the root of a
checkout of the repository; its package is imported and its kernels are
built from its own sources. The script prints the card's name and power
limit, each kernel's registers and spills from ``-Xptxas -v``, and one
JSON line with the CUDA-event times (ms per sample, the mean of 10
launches after a warm-up) of the forward, the taped forward, the retrace
backward and the tape-fed backward at Cornell 1024^2, depth 8, sample 1:
the shape of ``chip_smoke.py``'s phases 5, 8 and 10. Compare two
checkouts in turns within one call (parent, change, change, parent):
times taken on different cards or calls differ by a few percent.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

WIDTH = HEIGHT = 1024
MAX_DEPTH = 8
REPS = 10


def main() -> int:
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                        else pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch

    from computeraytracer_tpu_torch.kernels import _build
    from computeraytracer_tpu_torch.kernels import megakernel as mk
    from computeraytracer_tpu_torch.scene import presets, scene_from_dict
    from computeraytracer_tpu_torch.tracer import kernel as kt

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip())
    _build.build_all()
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")
    dev = torch.device("cuda", 0)
    scene, _ = scene_from_dict(presets.cornell_box(WIDTH, HEIGHT), device=dev)
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    args = kt.kernel_inputs(scene, *kt.camera_planes(scene, WIDTH, HEIGHT,
                                                     px, py, 1))
    R = args[1].shape[1]
    dL = torch.randn((4, R), generator=torch.Generator(device=dev)
                     .manual_seed(0), device=dev)
    _, tape_f, tape_i = mk.forward_taped(static, MAX_DEPTH, 1, *args)
    calls = {
        "forward": lambda: mk.forward(static, MAX_DEPTH, 1, *args),
        "forward_taped": lambda: mk.forward_taped(static, MAX_DEPTH, 1,
                                                  *args),
        "backward": lambda: mk.backward(static, MAX_DEPTH, 1, *args, dL),
        "backward_from_tape": lambda: mk.backward_from_tape(
            static, MAX_DEPTH, 1, args[0], args[3], tape_f, tape_i, dL),
    }
    ms = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(stop) / REPS
    print(json.dumps({"root": str(root), "device":
                      torch.cuda.get_device_name(0), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
