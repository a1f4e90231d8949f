"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the scene, film,
depth and Russian roulette), a traffic mix (``mixes/<traffic>.json``: the
entry and its parameters) and the number of cards; ``checks/<cell>.json``
holds what the comparison that decides ``correct`` samples, and its
limits. Each per-layer metric is read by ``metrics/<metric>.py``. Adding a
cell, a configuration, a mix or a metric adds files; nothing here names
one. A mesh of a scene document may name a generator instead of listing
its vertices and faces: ``scenes/<generator>.py``, whose ``mesh(entry)``
returns the mesh entry with its vertices and faces.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    mix_name: str
    mix: dict
    check: dict
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def entry(self) -> str:
        return self.mix["entry"]

    @property
    def width(self) -> int:
        return int(self.config["width"])

    @property
    def height(self) -> int:
        return int(self.config["height"])


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path=None) -> dict:
    return _json(pathlib.Path(path) if path else ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str, end_to_end: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end


def cell(bench: dict, name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of a parsed BENCHMARK.json. overrides (for tests
    at a small size) replace top-level keys of the configuration, of the
    mix and of the check."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    config = _json(BENCH_DIR / "configs" / f"{w['config']}.json")
    mix = _json(BENCH_DIR / "mixes" / f"{w['traffic']}.json")
    check = _json(BENCH_DIR / "checks" / f"{name}.json")
    for k, v in (overrides or {}).items():
        for d in (config, mix, check):
            if k in d:
                d[k] = v
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, mix_name=w["traffic"], mix=mix, check=check,
                end_to_end=e2e, per_layer=per_layer)


def scene_doc(c: Cell) -> dict:
    """The configuration's scene document, its film set to the cell's
    and each generated mesh made: the input both the program and the
    reference are given."""
    doc = copy.deepcopy(c.config["scene"])
    doc["camera"]["width"], doc["camera"]["height"] = c.width, c.height
    meshes = doc["objects"].get("meshes", [])
    doc["objects"]["meshes"] = [_module("scenes", m["generator"]).mesh(m)
                                if "generator" in m else m for m in meshes]
    return doc


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded by its file name."""
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_{folder}_" + name.replace(".", "_"),
        BENCH_DIR / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(records)`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read
