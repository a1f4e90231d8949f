"""The traced run's records, from one ``torch.profiler`` window over the
mix's profiled frames or steps.

- Device time: every event the profiler puts on the device (kernels,
  copies, sets), summed; busy time is the union of their intervals.
- Idle share: 1 - busy / the window's host wall.
- Host-issued ops: ``aten::`` ops with no ``aten::`` parent, the ops the
  program's Python issues itself (autograd's included).
- Breakdown: the device ops that took the most time, by name, and the
  longest idle gaps of the device summed by what the host was doing
  (the innermost host op open at the gap's middle, or "python" where
  none was).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100.harness.entries import sync

TOP = 10
# the longest gaps that are labelled and summed by label
LABELLED_GAPS = 256


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gap_labels(cpu_events, gaps) -> dict:
    """{label: summed seconds} of the longest gaps (start, end) in us."""
    starts = np.array([e.time_range.start for e in cpu_events], np.float64)
    ends = np.array([e.time_range.end for e in cpu_events], np.float64)
    out = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        t = (a + b) / 2.0
        open_ = np.nonzero((starts <= t) & (ends >= t))[0]
        label = ("python" if open_.size == 0
                 else cpu_events[open_[np.argmax(starts[open_])]].name)
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def profile(run_units, device: torch.device) -> dict:
    """Run run_units() under the profiler; its records (seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_units()
        sync(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    host_ops = sum(1 for e in cpu if e.name.startswith("aten::")
                   and not (e.cpu_parent is not None
                            and e.cpu_parent.name.startswith("aten::")))
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _merged([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = _gap_labels(cpu, [(a, b) for (_, a), (b, _)
                             in zip(busy, busy[1:])])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "wall_s": wall,
        "device_s": sum(by_name.values()) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "host_ops": host_ops,
        "launches": len(dev),
        "breakdown": {"device_ops": [[n, t / 1e6] for n, t in top],
                      "idle_gaps": [[n, t] for n, t in top_gaps]},
    }
