"""The cell ``rtnw-final-mesh-serve4`` end to end at a tiny film on the CPU:
the final scene of *Ray Tracing: The Next Week* with its ground as one mesh
of 4,800 triangles beside 1,007 unrolled rows (more than the kernels'
shared tables hold) through the program's plain kernel versions, compared
with the reference, in a process of its own that exits 0; and the cell's
roofline reader on records with and without the build's device time."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_h100.harness import cells  # noqa: E402

RUN = """
import json, sys, time, torch
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from bench_h100 import run as bench_run
from bench_h100.harness import cells, runner
c = cells.cell(cells.load_benchmark(), "rtnw-final-mesh-serve4", {tiny!r})
ctx = runner.Ctx(c, 2 ** 33 + 11, torch.device("cpu"))
bench_run._emit(runner.run(ctx, 0.2, False, t0))
"""
TINY = {"width": 8, "height": 8, "pixels": 48, "warmup_units": 1}


def test_rtnw_mesh_cell_runs_and_is_correct_on_the_cpu():
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


def test_mesh_roofline_reads_only_its_build():
    """mesh_forward_roofline.serve divides the least time by the device
    time of refill_fwd_wide_mesh alone, and reads nothing from a trace
    whose device ops lack it (a tree without the build)."""
    read = cells.metric_reader("mesh_forward_roofline.serve")
    ops = [["void (anonymous namespace)::refill_fwd_wide_mesh(float const*)",
            0.2], ["void (anonymous namespace)::refill_fwd_wide<0>(float "
                   "const*)", 0.5], ["hero_gather_kernel", 0.01]]
    rec = {"entry": "render", "units": 10, "least_s": 0.004,
           "device_s": 0.71, "breakdown": {"device_ops": ops}}
    assert read(rec) == pytest.approx(20.0)
    assert read(dict(rec, breakdown={"device_ops": ops[1:]})) is None
    assert read(dict(rec, entry="fit")) is None
