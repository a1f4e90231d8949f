"""Tracing and profiling hooks (port of
computeraytracer_tpu/utils/profiling.py).

- :func:`trace`: a ``torch.profiler`` trace of a code region, written as
  a Chrome trace JSON file under ``logdir`` (open it in Perfetto or
  ``chrome://tracing``); on the card it records every kernel launch with
  its device time.
- :func:`annotate`: a named region on the host timeline of a trace
  (``torch.profiler.record_function``).
- :func:`roofline`: an analytic cost model of the path-tracing workload
  (FLOPs, device-memory bytes, arithmetic intensity) and the time it
  implies on a card, so that a measured wall time converts to a
  speed-of-light fraction.
- :func:`measure_mean_depth`: the mean bounce-loop trips per path that
  the roofline needs, measured on the eager tracer.

Wall-clock throughput counters (paths/s) live in
``utils.metrics.RenderMeter``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import asdict, dataclass

import torch


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
    """Named region that appears on the host timeline of a trace."""
    return torch.profiler.record_function(name)


# Peak rates of the card: (bf16 dense tensor-core TFLOP/s, f32 TFLOP/s
# outside the tensor cores, device-memory GB/s). H100 SXM5 80GB, NVIDIA
# data sheet at 700 W. Path tracing is scalar f32 work, so the f32 rate
# is its compute ceiling.
CHIP_PEAKS = {
    "h100": (989.0, 67.0, 3350.0),
}


@dataclass
class Roofline:
    flops: float            # total f32 FLOPs of the workload
    hbm_bytes: float        # device-memory traffic (rays in, film out)
    intensity: float        # FLOPs / byte
    sol_compute_s: float    # time if bound by the f32 rate
    sol_memory_s: float     # time if bound by the memory rate
    sol_s: float            # the larger: the speed-of-light time
    bound: str              # "compute" | "memory"

    def fraction(self, measured_s: float) -> float:
        """Speed-of-light fraction achieved by a measured wall time."""
        return self.sol_s / measured_s if measured_s > 0 else 0.0

    def to_dict(self) -> dict:
        return asdict(self)


def roofline(width: int, height: int, spp: int, max_depth: int,
             n_prims: int, mean_depth: float | None = None,
             chip: str = "h100", backward: bool = False) -> Roofline:
    """Analytic cost model of the megakernel workload (the JAX package's,
    term for term).

    Per bounce each live path runs two full primitive scans (closest hit
    and shadow) at about 60 f32 operations per primitive test, plus about
    400 operations of shading (NEE and MIS pdfs, Fresnel, hemisphere
    sampling, RNG), on 4 wavelengths. Russian roulette makes the
    effective depth ``mean_depth`` (about 3 for the Cornell box at
    max_depth 8; see measure_mean_depth); without it max_depth is used.
    The backward (replay and reverse sweep) counts 3x the forward.

    The kernels hold the scene in shared memory, so the device-memory
    traffic is each path's ray, seed and spectra words in and its
    radiance out."""
    paths = width * height * spp
    depth = mean_depth if mean_depth is not None else float(max_depth)
    ops_per_prim_test = 60.0
    ops_shading = 400.0
    flops = paths * depth * (2 * n_prims * ops_per_prim_test + ops_shading)
    flops *= 4.0  # four wavelengths per path
    if backward:
        flops *= 3.0

    # per path (6 ray + 4 seed + 4 + 4 * 8 spectra) f32 words
    hbm_bytes = paths * (6 + 4 + 4 + 4 * 8) * 4.0

    _, f32_tflops, hbm_gbs = CHIP_PEAKS[chip]
    sol_c = flops / (f32_tflops * 1e12)
    sol_m = hbm_bytes / (hbm_gbs * 1e9)
    sol = max(sol_c, sol_m)
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes,
        intensity=flops / hbm_bytes,
        sol_compute_s=sol_c, sol_memory_s=sol_m, sol_s=sol,
        bound="compute" if sol_c >= sol_m else "memory",
    )


def detect_chip() -> str:
    """The CHIP_PEAKS key of card 0: "h100" for an H100. Any other device,
    or none, raises ValueError naming it: a default would put another
    card's peaks under its measurements."""
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: the roofline's peaks are a card's")
    name = torch.cuda.get_device_name(0)
    if "h100" in name.lower():
        return "h100"
    raise ValueError(f"no peak rates for {name!r} (CHIP_PEAKS has "
                     f"{sorted(CHIP_PEAKS)})")


def measure_mean_depth(scene, width: int = 256, height: int = 256,
                       sample: int = 1, max_depth: int = 8,
                       rr_start: int = 1) -> float:
    """Expected bounce-loop trips per path, measured: the eager tracer
    runs bounce by bounce and the live-lane fraction entering each trip
    is summed (the ``mean_depth`` the roofline model takes). On the
    scene's device."""
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
