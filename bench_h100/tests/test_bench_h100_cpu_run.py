"""Each cell end to end at a tiny film on the CPU (the program's plain
kernel versions), printing its result line."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_h100 import run as bench_run  # noqa: E402
from bench_h100.harness import cells, runner  # noqa: E402

BENCH = cells.load_benchmark()
TINY = {"width": 8, "height": 8, "pixels": 32, "block_pixels": 32,
        "warmup_units": 1, "profile_units": 2}
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(name):
    return cells.cell(BENCH, name, TINY)


def result_line(capsys, name, trace):
    ctx = runner.Ctx(tiny(name), 2 ** 31 + 5, torch.device("cpu"))
    result = runner.run(ctx, 0.2, trace, time.perf_counter())
    bench_run._emit(result)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    err = out.err.strip().splitlines()
    shown = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in line["checks"].items()]
    assert err[-len(shown):] == shown
    assert err[-len(shown) - 1] == f"correct {line['correct']}"
    return line


@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_the_result_line(capsys, name):
    line = result_line(capsys, name, trace=False)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    assert "setup_s" in line["metrics"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["cornell-serve4", "cornell-fit4"])
def test_traced_cell_reports_host_ops(capsys, name):
    line = result_line(capsys, name, trace=True)
    entry = "serve" if "serve" in name else "fit"
    assert f"host_ops.{entry}" in line["metrics"]
    # no device time on the CPU: the device's readers read nothing
    assert f"idle.{entry}" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure it")
    rc = bench_run.main(["--workload", "cornell-serve4", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


SETUP_ONLY = """
import sys, torch
sys.path.insert(0, {root!r})
from bench_h100.harness import cells, runner
from bench_h100.harness.entries import ENTRIES
c = cells.cell(cells.load_benchmark(), {name!r}, {tiny!r})
e = ENTRIES[c.entry](runner.Ctx(c, 7, torch.device("cpu")))
e.warm()
print(runner.forbidden_modules())
"""


@pytest.mark.parametrize("name", CELLS)
def test_setup_loads_no_jax(name):
    code = SETUP_ONLY.format(root=str(ROOT), name=name, tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "[]"
