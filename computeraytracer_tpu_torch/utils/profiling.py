"""Tracing and profiling hooks (port of
computeraytracer_tpu/utils/profiling.py).

- :func:`trace`: a ``torch.profiler`` trace of a code region, written as
  a Chrome trace JSON file under ``logdir`` (open it in Perfetto or
  ``chrome://tracing``); on the card it records every kernel launch with
  its device time.
- :func:`annotate`: a named span ``crt:<name>`` of the port's own work
  (a frame, a training step, their stages, each kernel launch) on the
  host timeline of whatever ``torch.profiler`` is recording; with no
  profiler running it does nothing.
- :func:`measure_mean_depth`: the mean bounce-loop trips per path,
  measured on the eager tracer.

Wall-clock throughput counters (paths/s) live in
``utils.metrics.RenderMeter``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# what annotate returns with no profiler running: one shared, reusable
# context that does nothing
_NO_SPAN = contextlib.nullcontext()
# the span itself: an op-scope record, as torch's compiled kernels make
# theirs. torch.profiler.record_function makes a user annotation, which
# the profiler mirrors on the device timeline as an event of its own
# (device_type CUDA in prof.events()), so that every span would count as
# device time wherever device events are summed.
_span = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Record a torch.profiler trace of the enclosed region into a Chrome
    trace file ``trace.<pid>.<ns>.json`` under ``logdir``.

    Host (CPU) activity always; device (CUDA) activity when ``device`` is
    a CUDA device, or, with device=None, when a card is available.
    Usage::

        with profiling.trace("/tmp/trace", scene.device):
            img = render_sample(scene, ...)

    Kernels launch asynchronously: the region synchronizes the device
    before it ends, so that their device time lands in the trace."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)


def annotate(name: str):
    """The span ``crt:<name>`` around a region of the port's work::

        with profiling.annotate("trace"):
            radiance = ...

    While a ``torch.profiler`` records (``trace``, the CLI's ``render
    --profile``, a benchmark's traced run, anyone's own profiler), the
    span is a host event of the profiler, on the clock of the device's
    activities, and the kernels launched inside it are its children.
    Otherwise it is a shared context that does nothing: no allocation,
    no clock read, no CUDA event."""
    if _autograd_profiler._is_profiler_enabled:
        return _span("crt:" + name)
    return _NO_SPAN


def measure_mean_depth(scene, width: int = 256, height: int = 256,
                       sample: int = 1, max_depth: int = 8,
                       rr_start: int = 1) -> float:
    """Expected bounce-loop trips per path, measured: the eager tracer
    runs bounce by bounce and the live-lane fraction entering each trip
    is summed. On the scene's device."""
    from computeraytracer_tpu_torch.ops import camera as cam_ops
    from computeraytracer_tpu_torch.ops import rng
    from computeraytracer_tpu_torch.ops import spectrum as spec
    from computeraytracer_tpu_torch.tracer import xla as xt

    cam = scene.camera
    with torch.no_grad():
        px, py = xt.tile_coords(width, height, 0, scene.device)
        seed = rng.seed_pixel(px, py, sample)
        o, d, seed = cam_ops.camera_rays(cam.eye, cam.lookat, cam.up,
                                         cam.fov, width, height, px, py,
                                         sample, seed)
        lambdas, seed = spec.sample_wavelengths(seed)
        state = xt.init_state(o, d, seed)
        isect_fn = xt.make_intersector(scene)
        fracs = []
        for depth in range(max_depth + 1):
            fracs.append(state.active.to(torch.float32).mean())
            state = xt.trace_step(scene, lambdas, state, depth, max_depth,
                                  rr_start, isect_fn)
        return float(torch.stack(fracs).sum())
