"""``harness/spans.py``: the program's ``crt:`` spans summed by name, on a
profiled CPU render of a cell at a tiny film, and its device attribution
on a made-up window of events."""

import pathlib
import sys
from types import SimpleNamespace

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_h100.harness import cells, runner, spans  # noqa: E402
from bench_h100.harness.entries import ENTRIES  # noqa: E402

STAGES = ("crt:ray_setup", "crt:gather", "crt:trace", "crt:xyz")


def test_summary_of_a_profiled_render():
    cell = cells.cell(cells.load_benchmark(), "cornell-serve4",
                      {"width": 8, "height": 8, "warmup_units": 1,
                       "max_depth": 2, "spp": 1})
    entry = ENTRIES["render"](runner.Ctx(cell, 2 ** 31 + 9,
                                         torch.device("cpu")))
    entry.warm()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(2):
            entry.unit(k)
    got = spans.summary(prof.events())
    spp = int(cell.mix["spp"])
    assert {k: v["n"] for k, v in got.items()} == {
        "crt:render": 2, "crt:setup": 2, "crt:finish": 2,
        **{s: 2 * spp for s in STAGES}}
    for v in got.values():
        assert 0 <= v["self_s"] <= v["host_s"]
        assert v["device_s"] == 0.0  # nothing runs on a device
    children = sum(got[k]["host_s"] for k in got if k != "crt:render")
    assert got["crt:render"]["self_s"] == pytest.approx(
        got["crt:render"]["host_s"] - children, abs=1e-9)


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id_=0, parent=None, ua=False):
    return SimpleNamespace(
        name=name, device_type=device, id=id_, cpu_parent=parent,
        is_user_annotation=ua,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_device_time_goes_to_the_spans_around_each_launch():
    """A kernel counts for every span whose interval holds the runtime call
    that launched it, on any thread; a launch outside every span counts for
    none; the profiler's device-side annotations are no device time."""
    step = ev("crt:train.step", 0, 100)
    bwd = ev("crt:train.backward", 40, 90, parent=step)
    # on the autograd thread: no parent on the main thread's tree
    kern = ev("crt:kernel:megakernel_bwd", 50, 60)
    events = [
        step, bwd, kern,
        ev("cudaLaunchKernel", 52, 53, id_=7, parent=kern),
        ev("sweep_kernel", 55, 85, CUDA, id_=7),
        ev("cudaLaunchKernel", 70, 71, id_=8),
        ev("elementwise_kernel", 86, 88, CUDA, id_=8),
        ev("cudaMemcpyAsync", 120, 121, id_=9),
        ev("Memcpy DtoH", 122, 123, CUDA, id_=9),
        ev("crt:train.backward", 40, 90, CUDA, id_=3, ua=True),
    ]
    got = spans.summary(events)
    assert got["crt:kernel:megakernel_bwd"]["device_s"] == pytest.approx(
        30e-6)
    assert got["crt:train.backward"]["device_s"] == pytest.approx(32e-6)
    assert got["crt:train.step"]["device_s"] == pytest.approx(32e-6)
    assert got["crt:train.step"]["self_s"] == pytest.approx(50e-6)
    assert got["crt:train.backward"]["self_s"] == pytest.approx(50e-6)
    assert got["crt:train.backward"]["n"] == 1
