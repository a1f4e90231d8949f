"""The cell ``rtnw-final-serve4`` end to end at a tiny film on the CPU: the
final scene of *Ray Tracing: The Next Week* (3,407 rows, more than the
kernels' shared tables hold) through the program's plain kernel versions,
compared with the reference, in a process of its own that exits 0."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time, torch
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from bench_h100 import run as bench_run
from bench_h100.harness import cells, runner
c = cells.cell(cells.load_benchmark(), "rtnw-final-serve4", {tiny!r})
ctx = runner.Ctx(c, 2 ** 33 + 9, torch.device("cpu"))
bench_run._emit(runner.run(ctx, 0.2, False, t0))
"""
TINY = {"width": 8, "height": 8, "pixels": 48, "warmup_units": 1}


def test_rtnw_cell_runs_and_is_correct_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), tiny=TINY)],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 1
    assert line["failed"] == 0
    assert {"render_mpaths_per_s", "frame_p95_ms", "setup_s"} <= set(
        line["metrics"])
    assert line["checks"]["bad_pixel_share"]["value"] <= 0.01
    assert "correct True" in out.stderr.splitlines()[-2]
