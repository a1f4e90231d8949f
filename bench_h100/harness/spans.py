"""The program's spans in a profiled window: every event whose name starts
with ``crt:`` (the port's ``utils.profiling.annotate``: a frame, a
training step, their stages, each kernel launch), summed by name.

For each name:
- ``n``: the spans;
- ``host_s``: their summed duration;
- ``self_s``: that less the part their child spans cover (a span's parent
  is the nearest enclosing ``crt:`` span on its thread);
- ``device_s``: the device time of the kernels, copies and sets launched
  inside them, on any thread: a device op counts for every span whose
  interval holds the start of the host call that launched it (the CUDA
  runtime or driver call with the op's correlation id).

Device ops whose launching call the window does not hold count for no
span. Spans the profiler puts on the device (user annotations) are not
device time.
"""

from __future__ import annotations

import numpy as np
import torch

PREFIX = "crt:"


def is_device(e) -> bool:
    """A kernel, copy or set on the card (not a mirrored annotation)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def launch_starts(events, dev) -> np.ndarray:
    """Per device op, the host start (us) of the runtime call that launched
    it, NaN where the window holds none."""
    ids = {e.id for e in dev}
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("cu") and e.id in ids}
    return np.array([calls.get(e.id, np.nan) for e in dev], np.float64)


def _crt_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(PREFIX):
        p = p.cpu_parent
    return p


def summary(events) -> dict:
    """{span name: {n, host_s, self_s, device_s}} of a profiler's events
    (``prof.events()``), in seconds."""
    spans = [e for e in events if e.name.startswith(PREFIX)
             and e.device_type == torch.autograd.DeviceType.CPU]
    dev = [e for e in events if is_device(e)]
    starts = launch_starts(events, dev)
    held = ~np.isnan(starts)
    order = np.argsort(starts[held])
    t = starts[held][order]
    cum = np.concatenate([[0.0], np.cumsum(np.array(
        [e.time_range.elapsed_us() for e in dev], np.float64)[held][order])])
    out = {}
    for e in spans:
        a, b = e.time_range.start, e.time_range.end
        lo = np.searchsorted(t, a, side="left")
        hi = np.searchsorted(t, b, side="right")
        rec = out.setdefault(e.name, {"n": 0, "host_s": 0.0, "self_s": 0.0,
                                      "device_s": 0.0})
        rec["n"] += 1
        rec["host_s"] += (b - a) / 1e6
        rec["self_s"] += (b - a) / 1e6
        rec["device_s"] += (cum[hi] - cum[lo]) / 1e6
    for e in spans:
        p = _crt_parent(e)
        if p is not None:
            out[p.name]["self_s"] -= e.time_range.elapsed_us() / 1e6
    return out
