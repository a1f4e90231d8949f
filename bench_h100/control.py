"""Read the comparison's numbers for the control or a planted fault on
several seeds in one process, and print each beside the cell's limits.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 \\
        [--mode bf16|unchanged|half_batch|altered]

The benchmark's own runs never run this: it is how the upper readings in
PERF.md were taken (``harness/control.py`` says what each mode is). Needs
a CUDA device; ``--device cpu`` runs it on the CPU at the cell's sizes.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_h100.harness import cells, check, control

    cell = cells.cell(cells.load_benchmark(ROOT / "BENCHMARK.json"),
                      args.workload)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control.readings(cell, seed, dev, args.mode, print)
        ok, shown = check.verdict(cell, numbers)
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, "correct": ok, "checks": shown,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
