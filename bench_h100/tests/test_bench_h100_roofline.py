"""The roofline's counts on a tiny Cornell film, checked by hand."""

import math
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from bench_h100.harness import cells, roofline, runner  # noqa: E402
from bench_h100.tests.test_bench_h100_reference import blob_doc  # noqa: E402

BENCH = cells.load_benchmark()


def _cell(**overrides):
    return cells.cell(BENCH, "cornell-serve4",
                      dict({"width": 4, "height": 4}, **overrides))


def test_scan_ops_by_hand():
    doc = cells.scene_doc(_cell())
    # 16 patches and 2 spheres, 35 operations each
    assert roofline.n_prims(doc) == 18
    assert roofline.scan_ops(doc) == 18 * 35
    # 16 patches; 320 triangles: ceil(log2 320) = 9 box tests, a plane and
    # an inside test
    assert roofline.scan_ops(blob_doc(2)) == 16 * 35 + 9 * 24 + 14 + 32
    # 80 triangles stay unrolled rows
    assert roofline.scan_ops(blob_doc(1)) == (16 + 80) * 35


def test_depth_zero_casts_one_scan_per_path():
    """At depth 0 every path casts its camera ray and nothing else (no
    scatter, so no shadow ray): 16 pixels x 4 samples closest scans."""
    c = _cell(max_depth=0)
    counts = runner.reference_counts(c, cells.scene_doc(c), 5,
                                     torch.device("cpu"))
    assert counts == {"closest": 16 * 4, "shadow": 0}
    least = roofline.least("render", counts, cells.scene_doc(c), 4, 4)
    ops = 64 * 18 * 35
    nbytes = (18 * 52 + 6 * 301 * 4 + 3 * 471 * 4) + 3 * (4 * 4 * 3 * 4)
    assert least["ops"] == ops and least["bytes"] == nbytes
    assert least["seconds"] == pytest.approx(max(ops / 67e12,
                                                 nbytes / 3.35e12))
    assert least["bound_by"] == "bytes"


def test_one_bounce_counts_shadow_rays_of_diffuse_hits():
    """At depth 1 a path that hits a surface at depth 0 scatters once (no
    Russian roulette before depth 2) and casts a second closest-hit scan;
    a diffuse scatter casts one shadow ray too, a glass one none."""
    c = _cell(max_depth=1)
    counts = runner.reference_counts(c, cells.scene_doc(c), 5,
                                     torch.device("cpu"))
    scattered = counts["closest"] - 64
    assert 0 < counts["shadow"] <= scattered <= 64
    fit = roofline.least("fit", counts, cells.scene_doc(c), 4, 4,
                         ("spectra", "data1"))
    assert fit["ops"] == 3 * (counts["closest"] + counts["shadow"]) * 630
    film, leaves = 4 * 4 * 3 * 4, 6 * 301 * 4 + 18 * 3 * 4
    assert fit["bytes"] == (18 * 52 + 6 * 301 * 4 + 3 * 471 * 4 + film
                            + 2 * leaves)


def test_stride_scales_the_lattice_to_the_film():
    c = _cell(width=8, height=8, count_stride=2, max_depth=0)
    counts = runner.reference_counts(c, cells.scene_doc(c), 1,
                                     torch.device("cpu"))
    assert counts["closest"] == 64 * 4
    assert math.isclose(counts["shadow"], 0.0)
