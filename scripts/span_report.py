"""The port's spans in one cell of the benchmark, on the card.

    python3 scripts/span_report.py --workload cornell-serve4 --seed 7

From the root of a checkout. Sets the cell up as ``bench_h100/run.py``
does, profiles the mix's ``profile_units`` frames or steps through the
harness's own ``harness/trace.py`` ``profile`` (so that its records are
the traced run's), and summarises the ``crt:`` spans of the same window
(``harness/spans.py``). It prints, per frame or step:

- ``host_ms``: the host time of the root span (``crt:render`` or
  ``crt:train.step``);
- ``trace_ms``: the device time of the trace kernels (the forward, the
  replay, the sweep: ``TRACE_KERNELS``, by name);
- ``glue_ms``: the device time of every op not named as a kernel of
  ``kernels/csrc`` (torch's elementwise ops, copies, memsets, Adam), with
  its largest ops;
- ``graph_replay_ms``: the device time of ``crt:graph.replay`` (a frame
  replayed from ``render_accumulate``'s CUDA graph, whose kernels run with
  no stage or ``crt:kernel:`` span around them);

then the harness's records (device, busy and wall time, host ops,
launches) and each span's summary; ``--json PATH`` writes all of it, the
breakdown too, as JSON. No reference check is made.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the kernels of the trace launches, by the substring of their names
TRACE_KERNELS = ("refill_fwd_kernel", "refill_fwd_wide", "refill_fwd_xyz",
                 "group_taped_kernel", "sweep_kernel")
CSRC = ROOT / "computeraytracer_tpu_torch" / "kernels" / "csrc"


@functools.lru_cache(maxsize=1)
def _port_kernels():
    """A pattern of the names of the kernels of kernels/csrc (its
    ``__global__`` functions), as a device op's name holds one."""
    decl = re.compile(r"__global__\s+void\s+"
                      r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    names = {n for f in sorted(CSRC.glob("*.cu*"))
             for n in decl.findall(f.read_text())}
    return re.compile(r"(?<!\w)(?:" + "|".join(sorted(names)) + r")(?=[<(])")


def port_kernel(name: str) -> bool:
    """Whether a device op's name is one of the kernels of kernels/csrc."""
    return bool(_port_kernels().search(name))


def _glue_ops(events, spans_mod, top=8):
    """{name: seconds} of the largest device ops not named as a kernel of
    kernels/csrc."""
    out = {}
    for e in events:
        if spans_mod.is_device(e) and not port_kernel(e.name):
            out[e.name] = (out.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e6)
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--json", default=None, help="write the record here")
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cells, runner, spans as spans_mod
    from bench_h100.harness import trace as trace_mod
    from bench_h100.harness.entries import ENTRIES, sync

    cell = cells.cell(cells.load_benchmark(), args.workload)
    dev = torch.device("cuda")
    entry = ENTRIES[cell.entry](runner.Ctx(cell, args.seed, dev))
    entry.warm()
    sync(dev)
    n = int(cell.mix["profile_units"])
    entry.plan(n)

    # the harness's own window, its profiler kept for the events
    kept = []
    real = torch.profiler.profile

    class Kept(real):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    torch.profiler.profile = Kept
    try:
        rec = trace_mod.profile(lambda: [entry.unit(k) for k in range(n)],
                                dev)
    finally:
        torch.profiler.profile = real
    events = kept[0].events()
    spans = spans_mod.summary(events)

    root = "crt:render" if cell.entry == "render" else "crt:train.step"
    def device_s(named):
        return sum(e.time_range.elapsed_us() / 1e6 for e in events
                   if spans_mod.is_device(e) and named(e.name))

    kernel_s = device_s(port_kernel)
    trace_s = device_s(lambda name: any(k in name for k in TRACE_KERNELS))
    annotations = sorted({e.name for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and getattr(e, "is_user_annotation", False)})
    out = {
        "cell": cell.name, "seed": args.seed, "units": n,
        "card": torch.cuda.get_device_name(dev),
        "host_ms": 1e3 * spans.get(root, {}).get("host_s", 0.0) / n,
        "trace_ms": 1e3 * trace_s / n,
        "glue_ms": 1e3 * (rec["device_s"] - kernel_s) / n,
        "root_spans": spans.get(root, {}).get("n", 0),
        "graph_replay_ms": 1e3 * spans.get("crt:graph.replay", {}).get(
            "device_s", 0.0) / n,
        "kernels_device_s": kernel_s,
        "records": {k: v for k, v in rec.items() if k != "breakdown"},
        "breakdown": rec["breakdown"],
        "glue_ops_s": _glue_ops(events, spans_mod),
        "device_user_annotations": annotations,
        "spans": spans,
    }
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("spans", "breakdown")}, indent=1))
    for name, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_s"]):
        print(f"{name:36s} n {v['n']:4d}  host {1e3 * v['host_s'] / n:9.4f}"
              f"  self {1e3 * v['self_s'] / n:9.4f}  device "
              f"{1e3 * v['device_s'] / n:9.4f} ms/unit")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
