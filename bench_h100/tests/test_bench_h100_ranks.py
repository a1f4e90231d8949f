"""A cell on two devices, rehearsed on the CPU: two spawned ranks over
gloo through the port's parallel.distributed, the sharded render and the
sharded training step, rank 0 printing the result line."""

import argparse
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_h100 import run as bench_run  # noqa: E402
from bench_h100.harness import cells  # noqa: E402

TINY = {"width": 8, "height": 8, "pixels": 32, "block_pixels": 32,
        "warmup_units": 1}


@pytest.mark.parametrize("name", ["cornell-serve4", "cornell-fit4"])
def test_two_ranks_over_gloo(tmp_path, capfd, name):
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            w["chips"] = 2
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = cells.cell(bench, name, TINY)
    args = argparse.Namespace(seed=2 ** 31 + 3, seconds=0.2, trace=0)
    rc = bench_run.run_ranks(cell, args, "cpu", path, TINY)
    out = capfd.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert line["correct"] is True and line["device"]["count"] == 2
    assert line["attempted"] >= 1
