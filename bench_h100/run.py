"""Run one cell of the benchmark once and print its result line.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles the mix's
frames or steps and reports the per-layer metrics. Either way the
program's output is then compared with the plain reference, each number
compared is printed beside its limit on the last lines of standard error,
and the last line of standard output is one JSON object. The run needs as
many CUDA devices as the cell asks for; a cell on several cards runs one
process per card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout: the port's
# nvcc build goes to its own kernels/build/; a Triton, extension or
# inductor cache, should the port come to use one, goes here
CACHE = ROOT / ".bench_h100_cache"
CACHE_ENV = {"TRITON_CACHE_DIR": CACHE / "triton",
             "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor"}


def _environment() -> None:
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _emit(result: dict) -> None:
    from bench_h100.harness.runner import log
    log(f"card: {_card_line()}")
    log(f"correct {result['correct']}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)


def run_rank(rank, world, address, name, seed, seconds, trace, device,
             bench_path, overrides, t_process):
    """One rank of a cell on several devices (its own process)."""
    _environment()
    import torch
    from bench_h100.harness import cells, runner
    from computeraytracer_tpu_torch.parallel import distributed
    from computeraytracer_tpu_torch.parallel import mesh as mesh_mod

    cell = cells.cell(cells.load_benchmark(bench_path), name, overrides)
    distributed.initialize(address, world, rank, device_type=device)
    try:
        dev = (torch.device("cuda", rank) if device == "cuda"
               else torch.device("cpu"))
        ctx = runner.Ctx(cell, seed, dev, mesh_mod.make_mesh(), rank, world)
        result = runner.run(ctx, seconds, trace, t_process)
        if rank == 0:
            _emit(result)
    finally:
        distributed.shutdown()


def run_ranks(cell, args, device, bench_path, overrides=None) -> int:
    """Start one process per device of the cell and wait for them all;
    rank 0 prints the result."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(
        r, cell.chips, address, cell.name, args.seed, args.seconds,
        bool(args.trace), device, str(bench_path), overrides, T_PROCESS))
        for r in range(cell.chips)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    return max(abs(p.exitcode or 0) for p in procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench_h100.harness import cells, runner

    bench_path = ROOT / "BENCHMARK.json"
    cell = cells.cell(cells.load_benchmark(bench_path), args.workload)
    if not torch.cuda.is_available():
        runner.log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        runner.log(f"{cell.name} needs {cell.chips} CUDA devices, "
                   f"{torch.cuda.device_count()} found")
        return 2
    try:
        import computeraytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        runner.log(f"the program is not in this checkout: {e}")
        return 3
    if cell.chips > 1:
        return run_ranks(cell, args, "cuda", bench_path)
    ctx = runner.Ctx(cell, args.seed, torch.device("cuda", 0))
    try:
        result = runner.run(ctx, args.seconds, bool(args.trace), T_PROCESS)
    except runner.Refused as e:
        runner.log(str(e))
        return e.code
    _emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
