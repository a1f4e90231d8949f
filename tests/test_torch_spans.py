"""The port's spans (``utils/profiling.py`` ``annotate``): ``crt:<name>``
events of ``torch.profiler`` around a frame, a training step, their stages
and each kernel launch.

With no profiler running ``annotate`` enters nothing. Under the profiler
a render at spp 1, 2 and 4 shows one ``render``, ``setup`` and ``finish``
and spp each of ``ray_setup``, ``gather``, ``trace`` and ``xyz``, nested
under ``render``; a training step shows ``train.step`` with its loss,
backward and optimizer spans, and the backward's spans (on whichever
thread autograd runs them) inside ``train.backward``'s interval. The
image, the loss and the gradients are bit-equal with the profiler on and
off. On the CPU the kernels' plain versions run and ``_launch`` is never
called, so its span is held with a stand-in entry point. 8x8 films at
depth 2, on a scene of three patches; each profiled run is made once.
"""

import collections
import contextlib
import dataclasses
import json
from typing import NamedTuple

import pytest
import torch

from computeraytracer_tpu_torch import RenderConfig
from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import api
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.train import optimize
from computeraytracer_tpu_torch.utils import profiling

SIDE = 8
DEPTH = 2
STAGES = ("ray_setup", "gather", "trace", "xyz")


class Span(NamedTuple):
    name: str     # without the "crt:" prefix
    start: int    # ns
    end: int
    thread: int
    annotation: bool  # a user annotation, which a card's trace mirrors


@contextlib.contextmanager
def profiled():
    """A CPU profiler; yields a list that holds its crt: spans once closed,
    read from the profiler's raw events (its event tree takes seconds to
    build over the plain trace's tens of thousands of ops)."""
    out = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield out
    out.extend(Span(e.name()[4:], e.start_ns(), e.end_ns(),
                    e.start_thread_id(), e.is_user_annotation())
               for e in prof.profiler.kineto_results.events()
               if e.name().startswith("crt:"))


def counts(spans):
    return collections.Counter(e.name for e in spans)


def inside(e, outer):
    return outer.start <= e.start and e.end <= outer.end


def crt_parent(e, spans):
    """The name of the innermost other span around e on its thread."""
    around = [o for o in spans if o is not e and o.thread == e.thread
              and inside(e, o)]
    return max(around, key=lambda o: (o.start, -o.end)).name if around \
        else None


def by_name(spans):
    out = {e.name: e for e in spans}
    assert len(out) == len(spans), counts(spans)
    return out


@pytest.fixture(scope="module")
def scene():
    return scene_from_dict(presets.unoccluded_scene(SIDE, SIDE),
                           device="cpu")[0]


def render(scene, spp, first_sample=1):
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=spp, max_depth=DEPTH,
                       first_sample=first_sample)
    return api.render(scene, cfg)


def train_step(scene, backward):
    params0, static = optimize.split_scene(scene, ("spectra", "data1"))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = optimize.make_train_step(static, opt, SIDE, SIDE, 1, DEPTH,
                                    backward=backward)
    target = torch.full((SIDE, SIDE, 3), 0.1)
    return step, params, target


def test_annotate_without_profiler_is_one_shared_null_context():
    a, b = profiling.annotate("render"), profiling.annotate("kernel:x")
    assert a is b
    with a:
        with b:  # reusable and reentrant
            pass


@pytest.mark.parametrize("what", ["render", "train_step"])
def test_annotate_without_profiler_enters_nothing(monkeypatch, scene, what):
    def refuse(name, *a, **k):
        raise AssertionError(f"{name} entered with no profiler running")

    real = torch.profiler.record_function
    monkeypatch.setattr(profiling, "_span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", lambda n, *a, **k: (
        refuse(n) if n.startswith("crt:") else real(n, *a, **k)))
    if what == "render":
        assert torch.isfinite(render(scene, 1)["srgb"]).all()
    else:
        step, params, target = train_step(scene, "pallas")
        assert torch.isfinite(step(params, target, 1))


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"spp{n}")
def rendered(request, scene):
    """(spp, the render with the profiler off, with it on, its spans)"""
    spp = request.param
    off = render(scene, spp, first_sample=3)
    with profiled() as spans:
        on = render(scene, spp, first_sample=3)
    return spp, off, on, spans


def test_render_spans_count_and_nest(rendered):
    spp, _, _, spans = rendered
    n = counts(spans)
    assert n == {"render": 1, "setup": 1, "finish": 1,
                 **{s: spp for s in STAGES}}, n
    for e in spans:
        want = None if e.name == "render" else "render"
        assert crt_parent(e, spans) == want, e
        # on a card the profiler would mirror an annotation as a device
        # event, which a trace's device time would count
        assert not e.annotation, e


def test_render_bit_equal_under_profiler(rendered):
    _, off, on, _ = rendered
    for k in ("accum_xyz", "mean_xyz", "srgb"):
        assert torch.equal(off[k], on[k]), k


@pytest.fixture(scope="module", params=["pallas", "pallas_taped"])
def stepped(request, scene):
    """(loss, gradients, leaves after the step) with the profiler off, the
    same with it on, and its spans: one step each from the same start."""
    got = []
    for prof in (False, True):
        step, params, target = train_step(scene, request.param)
        with profiled() if prof else contextlib.nullcontext() as spans:
            loss = step(params, target, 1)
        got.append((loss, {k: v.grad.clone() for k, v in params.items()},
                    {k: v.detach().clone() for k, v in params.items()}))
    return got[0], got[1], spans


def test_train_step_spans(stepped):
    spans = stepped[2]
    by = by_name(spans)
    assert set(by) == {"train.step", "train.loss", "train.backward",
                       "train.optimizer", "setup", "trace.backward",
                       "gather.backward", *STAGES}  # no camera leaf
    for name in ("train.loss", "train.backward", "train.optimizer"):
        assert crt_parent(by[name], spans) == "train.step"
    for name in ("setup", *STAGES):
        assert crt_parent(by[name], spans) == "train.loss"
    for name in ("trace.backward", "gather.backward"):
        assert inside(by[name], by["train.backward"]), name
    assert all(inside(e, by["train.step"]) for e in spans)


def test_train_step_bit_equal_under_profiler(stepped):
    (l0, g0, p0), (l1, g1, p1), _ = stepped
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
        assert torch.equal(p0[k], p1[k]), k


def test_replay_backward_span():
    """A scene with a mesh part differentiates through the guided replay
    (MeshTraceFn), whose backward is a trace.backward span too."""
    mesh = scene_from_dict(presets.tie_mesh_scene(SIDE, SIDE, "edges"),
                           device="cpu")[0]
    assert mk.SceneStatic.from_scene(mesh).mesh_parts
    step, params, target = train_step(mesh, "pallas")
    with profiled() as spans:
        step(params, target, 1)
    by = by_name(spans)
    assert inside(by["trace.backward"], by["train.backward"])


def test_ray_setup_backward_span(scene):
    eye = scene.camera.eye.clone().requires_grad_(True)
    moved = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, eye=eye))
    with profiled() as spans:
        img = kt.render_sample_planar(moved, SIDE, SIDE, 1, DEPTH)
        img.sum().backward()
    n = counts(spans)
    assert n["ray_setup.backward"] == 1 and n["trace.backward"] == 1, n
    assert torch.isfinite(eye.grad).all()


def test_launch_span_wraps_the_entry_point(monkeypatch):
    """_launch puts each launch in a span kernel:<name>, around the entry
    point's call alone, and still raises on its error code."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    called = []

    def entry(*args):
        called.append(args)
        return 0

    with profiled() as spans:
        mk._launch("megakernel_fwd", entry, "cuda", 1, 2)
        mk._launch("hero_gather", entry, "cuda", 3)
    assert called == [(1, 2, 0), (3, 0)]
    assert counts(spans) == {"kernel:megakernel_fwd": 1,
                             "kernel:hero_gather": 1}
    with pytest.raises(RuntimeError, match="walk launch failed"):
        mk._launch("walk", lambda *a: 7, "cuda")


def test_cli_profile_trace_holds_the_spans(tmp_path):
    logdir = tmp_path / "prof"
    rc = cli.main(["render", "--preset", "unoccluded_scene", "--width",
                   str(SIDE), "--height", str(SIDE), "--spp", "2",
                   "--depth", str(DEPTH), "--device", "cpu", "--out",
                   str(tmp_path / "p.png"), "--profile", str(logdir)])
    assert rc == 0
    (path,) = logdir.glob("trace.*.json")
    names = collections.Counter(
        e.get("name") for e in json.loads(path.read_text())["traceEvents"])
    assert names["crt:render"] == 1 and names["crt:trace"] == 2, names
