"""One run of one cell: set-up, the measured window (or the traced one),
then, once the window has closed and the program's state is freed, the
comparison with the reference. ``run`` returns the result line's object
on rank 0 and None on the other ranks.

``setup_s`` is the time from the process's start to the window's: the
program's kernel build, the scene, and the warm-up that runs every shape
of the cell once. The window issues frames or steps back to back and ends
with the first that finishes past ``seconds``; its rates are taken over
all its work and all its time.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from bench_h100.harness import cells, check, roofline
from bench_h100.harness import trace as trace_mod
from bench_h100.harness.entries import ENTRIES, sync
from bench_h100.reference import scene as ref_scene
from bench_h100.reference import tracer as ref_tracer

# top-level module names that may not be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "computeraytracer_tpu")


class Refused(Exception):
    """A run that may print no result; ``code`` is its exit code."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class Ctx:
    cell: cells.Cell
    seed: int
    device: torch.device
    mesh: object = None   # the (dp, sp) DeviceMesh of a cell on several cards
    rank: int = 0
    world: int = 1


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _reduce(ctx: Ctx, value: float, op: str) -> float:
    """value reduced ("max" or "sum") over the ranks; itself on one."""
    if ctx.world == 1:
        return value
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=ctx.device)
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op])
    return float(t.item())


def _window(entry, seconds: float, ctx: Ctx):
    unit_s = []
    t0 = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        entry.unit(k)
        b = time.perf_counter()
        unit_s.append(b - a)
        k += 1
        if _reduce(ctx, float(b - t0 >= seconds), "max"):
            return unit_s, b - t0


def reference_counts(cell, doc, first: int, device) -> dict:
    """Casts of one unit as the reference traces them, over a lattice of
    pixels every ``count_stride`` along both axes, scaled to the film."""
    scene = ref_scene.build(doc, device)
    stride = int(cell.check["count_stride"])
    xs = torch.arange(0, cell.width, stride, device=device)
    ys = torch.arange(0, cell.height, stride, device=device)
    px = xs[None, :].expand(len(ys), len(xs)).reshape(-1)
    py = ys[:, None].expand(len(ys), len(xs)).reshape(-1)
    counts = {"closest": 0, "shadow": 0}
    with torch.no_grad():
        ref_tracer.accumulate(scene, cell.width, cell.height, px, py, first,
                              int(cell.mix["spp"]),
                              int(cell.config["max_depth"]),
                              int(cell.config["rr_start"]), counts)
    scale = cell.width * cell.height / px.numel()
    return {k: v * scale for k, v in counts.items()}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx: Ctx, seconds: float, trace: bool, t_process: float):
    cell, dev = ctx.cell, ctx.device
    entry = ENTRIES[cell.entry](ctx)
    t_built = time.perf_counter()
    entry.warm()
    sync(dev)
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log(f"set-up {setup_s:.3f} s (program's scene and state "
        f"{t_built - t_process:.3f} s, warm-up {t_window - t_built:.3f} s)")

    rec = None
    if trace:
        n = int(cell.mix["profile_units"])
        entry.plan(n)
        rec = trace_mod.profile(lambda: [entry.unit(k) for k in range(n)],
                                dev)
        units = n
        log(f"traced {n} units: wall {rec['wall_s']:.6f} s, device "
            f"{rec['device_s']:.6f} s, busy {rec['busy_s']:.6f} s, "
            f"{rec['launches']} device ops, {rec['host_ops']} host ops")
    else:
        entry.plan(int(0.9 * seconds / max(getattr(entry, "warm_s", 1.0),
                                           1e-3)))
        unit_s, window_s = _window(entry, seconds, ctx)
        units = len(unit_s)
        measured = entry.measured(unit_s, window_s)
        q = np.percentile(unit_s, [50, 95, 100]) * 1e3
        log(f"window {window_s:.6f} s, {units} units; unit ms median "
            f"{q[0]:.4f}, p95 {q[1]:.4f}, max {q[2]:.4f}")
        if units <= 1000:
            log("unit ms: " + " ".join(f"{t * 1e3:.3f}" for t in unit_s))
    peak = 0
    if dev.type == "cuda":
        peak = max(setup_peak, torch.cuda.max_memory_allocated(dev))
    peak = int(_reduce(ctx, peak, "max"))
    busy = None
    if trace:
        busy = _reduce(ctx, rec["busy_s"], "sum") / ctx.world

    found = forbidden_modules()
    if found:
        raise Refused(f"loaded in the process that reports: {found}", 4)

    # what the comparison needs, then the program's state goes
    doc = entry.doc
    failed = getattr(entry, "failed", 0)
    if cell.entry == "render":
        answers = entry.answers(int(cell.check["pixels"]))
    else:
        answers = entry.followed
        target, first = entry.target.detach().cpu(), entry.first
    first_unit = entry.sample_of(0) if cell.entry == "render" else entry.first
    entry.release()
    del entry
    _free(dev)
    if ctx.rank != 0:
        return None

    metrics = {}
    if trace:
        t0 = time.perf_counter()
        counts = reference_counts(cell, doc, first_unit, dev)
        least = roofline.least(cell.entry, counts, doc, cell.width,
                               cell.height, tuple(cell.mix.get("trainable",
                                                               ())))
        log(f"reference counts per unit {counts} -> {least['ops']} "
            f"operations, {least['bytes']} bytes, least "
            f"{least['seconds']:.9f} s ({least['bound_by']}), "
            f"{time.perf_counter() - t0:.1f} s")
        records = dict(rec, entry=cell.entry, units=units,
                       least_s=least["seconds"])
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        measured["setup_s"] = setup_s
        for m in cell.end_to_end:
            # a CPU rehearsal has no device memory to read
            if m["name"] in measured or dev.type == "cuda":
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}

    t0 = time.perf_counter()
    if cell.entry == "render":
        refs = check.serve_reference(cell, doc, answers, dev)
        numbers = check.serve_numbers(cell, answers, refs)
    else:
        want = check.fit_reference(cell, doc, target.to(dev), first, dev)
        numbers = check.fit_numbers(answers, want, log)
        log(f"losses {answers['losses']} reference {want['losses']}")
    correct, shown = check.verdict(cell, numbers)
    log(f"reference check {time.perf_counter() - t0:.1f} s")
    if not correct:
        failed += 1
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": ctx.world, "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=busy, window_s=rec["wall_s"])
        result["breakdown"] = rec["breakdown"]
    result["checks"] = shown
    return result
