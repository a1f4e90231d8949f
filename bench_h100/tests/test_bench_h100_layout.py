"""BENCHMARK.json against the rules its fields follow, and every name in it
resolved to its files."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from bench_h100.harness import cells  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                    assert "\t" not in e[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_configs_resolve_and_reduce_no_width():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_h100/")
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
            assert not any(w in k for w in WIDTH_WORDS)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_workload_resolves(w):
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    c = cells.cell(BENCH, w["name"])
    assert c.config_name == w["config"] and c.mix_name == w["traffic"]
    assert c.mix["entry"] in ("render", "fit")
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    moved = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in moved
        assert callable(cells.metric_reader(m["name"]))
    assert set(c.check["limits"])
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_every_metric_reports_its_moves_in_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell])


def test_readers_read_only_their_entry():
    rec = {"host_ops": 300, "units": 3, "device_s": 0.06, "busy_s": 0.05,
           "wall_s": 0.08, "least_s": 0.0006}
    for m in BENCH["per_layer"]:
        read = cells.metric_reader(m["name"])
        entry = "fit" if m["name"].endswith(".fit") else "render"
        other = "render" if entry == "fit" else "fit"
        assert read(dict(rec, entry=entry)) is not None
        assert read(dict(rec, entry=other)) is None
    roof = cells.metric_reader("kernels_roofline.fit")
    assert roof(dict(rec, entry="fit")) == pytest.approx(3.0)
    assert roof(dict(rec, entry="fit", device_s=0.0)) is None
    idle = cells.metric_reader("idle.serve")
    assert idle(dict(rec, entry="render")) == pytest.approx(0.375)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench_h100" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "computeraytracer_tpu",
                           "computeraytracer_tpu_torch"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench_h100.reference.tracer, bench_h100.reference.fit; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"jax", "computeraytracer_tpu",
                         "computeraytracer_tpu_torch"}


def test_harness_imports_no_jax():
    for path in (ROOT / "bench_h100").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "computeraytracer_tpu"}
