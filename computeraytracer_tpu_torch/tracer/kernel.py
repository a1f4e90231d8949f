"""Megakernel tracer: the port of computeraytracer_tpu/tracer/pallas.py.

Per render or loss, once: the sample-invariant operands
(``setup_operands``: the pixel coordinates, the primitive table, the
hero-expanded spectra table and CIE window), as the JAX package's jitted
scan over the samples hoists them (tracer/pallas.py:842-855). Per sample:
the ray setup (seeds, camera rays, the hero draw; one kernel,
``kernels.setup.ray_setup``, which computes the camera frame itself, and
whose backward kernel carries the rays' cotangent to the camera), the
hero gather of the spectra and CIE planes in one launch
(``ops.spectrum.HeroGatherFn``, whose backward sums in a fixed order), one
trace kernel call, and the CIE conversion in torch. Every kernel runs on
the card for a scene there; a scene on the CPU runs their plain torch
versions.

One layout is ported: the planar (k, R) path the kernel consumes, with
pixels in ``tile_coords`` row-major order. ``render_sample`` is its
(H, W, 3) transpose; the JAX package documents the two layouts as
bit-identical. ``render_pixels`` (R, 3) is the entry of the visibility
gradients' screen warp (``vis_grads=("screen",)``, ops/warp.py) and of
``stratified=False``: unstratified film coordinates, the warp, the same
trace, then the warp's detJ and zero-primal splat. Mesh scenes keep
row-major order too: the JAX package's
block order (``_block_order``) is a culling order for its per-tile BVH
walk and changes no pixel's value.

Differentiation, by the ``backward`` knob (the JAX package's values):
- ``"pallas"`` (default): ``kernels.megakernel.TraceFn``, whose backward
  is the retrace kernel (replay plus reverse adjoint sweep);
- ``"pallas_taped"``: ``TraceTapedFn``. Under grad the taped forward
  writes every bounce's input carry and the tape-fed kernel sweeps it
  without a replay; with no input needing grad, the untaped forward runs;
- ``"replay"``: ``MeshTraceFn``. Under grad the winner-taped forward
  keeps each bounce's closest-hit and shadow winners, and the backward is
  torch autograd of the guided replay (tracer/replay.py). Scenes with
  mesh parts take this route whatever ``"pallas"`` or ``"pallas_taped"``
  asks for: the backward kernels have no chunk-BVH walk. (The JAX
  package's ``_resolve`` reroutes only ``"pallas"``; its own error text
  says mesh scenes route there automatically.)
- ``"none"``: the forward alone, with no autograd Function;
- ``"xla"``: ``EagerVjpFn``, the JAX package's recompute-vjp
  (tracer/pallas.py:639-661). The forward is the kernel path (as
  ``"none"``); the backward recomputes the pixels through the eager
  tracer (``tracer.xla.render_pixels``) under autograd and hands each
  scene tensor its gradient: the gradient oracle, slower and brute force
  (no BVH) at mesh scale. It needs pixel coordinates, so the planar
  entry points take it and ``trace_radiance`` refuses it.
Autograd carries the cotangents of the primitive table, the spectra
planes and the rays on through ``pack_prims``, the hero gather and the
camera to every scene leaf (geometry, spectra, camera). With the operands
built once per render, the primitive table and the expanded spectra table
feed every sample, and autograd sums their cotangents over the samples
before ``pack_prims``' and the table's backward.

Mesh scenes (mesh parts or triangle rows) render through the forward
kernel's mesh mode, the in-kernel chunk-BVH walk. Triangle rows without a
mesh part keep ``TraceFn`` / ``TraceTapedFn``, whose kernels scan them in
their mesh mode. A mesh part's chunk BVH is packed from a plan fixed on
the initial geometry (``mesh_plans``, as ``kernels/meshpack.py``
``plan_scene_mesh`` makes them), so its boxes follow the live vertices.

``accumulate_pixels`` is the kernel path's one loop over samples: every
render and loss of a pixel set sums its samples there (``tracer.api``
chooses it), ``accumulate_frame``'s frame over the whole film. It adds
each sample into its accumulator in place where no gradient is wanted,
the scene has no mesh part and the backward has a kernel forward: per
sample the ray setup, the hero gather and the forward's XYZ build
(``kernels.megakernel.forward_xyz``), which converts each ray to XYZ as it
retires, three launches in all; the image is the composition's (radiance,
CIE sum, accumulation) bit for bit.

``accumulate_frame`` replays a frame as one CUDA graph where it can:
the frame body of a CUDA scene without mesh parts, traced with no
gradient wanted, is captured the second time a call of the same key
(``frame_graph_key``) comes, with the ray setups reading the sample from
a device scalar (``kernels.setup.ray_setup``'s base), and replayed from
then on (``eager_reasons`` says when it is not). The graph is the eager
body recorded, so its images are the eager frame's bit for bit. It ends at
the planar accumulator: ``render_accumulate`` copies it into a fresh (H,
W, 3) image, ``tracer.api.render`` finishes it in one launch
(``kernels.setup.finish_frame``).

``wavefront=True`` renders scenes with mesh parts through the wavefront
(``wavefront_forward``, the JAX package's ``_wavefront_forward``): one
shade-step launch per bounce (``kernels.megakernel.shade_step``) with the
mesh casts in between done by the binned pipeline of ``kernels.binned``
(candidate and pair kernels, the seeded walk for the rays they leave
unresolved). Its radiance is the in-kernel loop's bit for bit. Under grad it runs taped and differentiates through the same guided
replay (``MeshWavefrontFn``); with ``backward="none"``, or under
no_grad, it runs untaped. ``wavefront=None`` resolves to
``MESH_WAVEFRONT_DEFAULT``; scenes without mesh parts ignore the flag, as
in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch
from torch.autograd.function import once_differentiable

from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.ops import warp
from computeraytracer_tpu_torch.tracer import xla as xla_tracer
from computeraytracer_tpu_torch.utils import profiling

SceneStatic = mk.SceneStatic

# What trace_radiance(wavefront=None) resolves to for mesh scenes. The
# JAX package defaults to its binned wavefront, whose casts the port runs
# on the card too (kernels/binned.py); the port's default stays the
# in-kernel loop, whose radiance the wavefront matches bit for bit, until
# the bench script measures both end to end on the card.
MESH_WAVEFRONT_DEFAULT = False

# A sparse cast is compacted and cast in batches of R // BATCH_FRACTION
# rays; a cast with more than R // THRESHOLD_FRACTION live rays runs in one
# piece (the JAX package's tracer/pallas.py:66-67 and
# kernels/binned.py:1182 mesh_closest_hit_batched).
MESH_CAST_BATCH_FRACTION = 8
MESH_CAST_THRESHOLD_FRACTION = 4

BACKWARDS = ("pallas", "pallas_taped", "none", "xla", "replay")


tile_coords = xla_tracer.tile_coords


def camera_planes(scene, width: int, height: int, px, py, sample,
                  base=None):
    """Per-ray setup for pixels px, py (R,) at a 1-based sample index
    (base + sample where base, an int64 scalar on the scene's device, is
    given): seeds, jittered camera rays and the hero-wavelength draw
    (``kernels.setup.ray_setup``: the ray-setup kernel on the card, its
    plain version on the CPU), differentiable with respect to the
    camera's tensors (``kernels.setup.RaySetupFn``: on the card its
    backward is the ray setup's backward kernel).

    Returns (o (3, R), d (3, R), hero (R,), seed (4, R))."""
    return setup_k.ray_setup(scene.camera, width, height, px, py, sample,
                             base)


@dataclasses.dataclass(frozen=True)
class SetupOperands:
    """The sample-invariant operands of the kernel path (``setup_operands``):
    the pixel coordinates px, py (R,) int64, contiguous, or None where the
    caller gives its own; the kernel's primitive table prims
    (``kernels.megakernel.pack_prims``); the hero-expanded spectra table
    spect_table (S*4, 301) and CIE window cie_table (12, 301)
    (``ops.spectrum.cie_window_exp``). Under autograd, prims and
    spect_table carry the scene leaves' graph into every sample."""
    px: torch.Tensor | None
    py: torch.Tensor | None
    prims: torch.Tensor
    spect_table: torch.Tensor
    cie_table: torch.Tensor


def setup_operands(scene, static: SceneStatic | None = None,
                   backward: str = "pallas", px=None, py=None):
    """The SetupOperands of one render or loss: build them once and pass
    them to every sample's ``render_pixels_planar``,
    ``render_sample_planar``, ``trace_radiance`` or ``kernel_inputs``
    with the same static and backward. prims is the whole table without a
    static (``kernel_inputs``' convention) and for the guided replay
    (backward "replay", which "pallas" and "pallas_taped" take for scenes
    with mesh parts), else the static's unrolled rows. px, py: the pixels
    the samples render (``render_sample_planar`` reads them: the whole
    film there)."""
    whole = static is None or backward == "replay" or bool(
        static.mesh_parts and backward in ("pallas", "pallas_taped"))
    return SetupOperands(
        None if px is None else px.contiguous(),
        None if py is None else py.contiguous(),
        mk.pack_prims(scene, None if whole else static),
        spec.expand_hero_table(scene.spectra).contiguous(),
        spec.cie_window_exp(scene.cie).contiguous())


def _check_setup(setup: SetupOperands, scene, static: SceneStatic | None):
    """Raise unless setup's prims has the rows the trace takes: the whole
    table without a static, else the static's unrolled rows."""
    rows = (scene.primitives.data1.shape[0] if static is None
            else len(static.rows))
    if setup.prims.shape[0] != rows:
        raise ValueError(
            f"setup operands of {setup.prims.shape[0]} primitive rows for a "
            f"trace of {rows}: pass setup_operands(scene, static, backward) "
            "with the call's own static and backward")


def kernel_inputs(scene, o, d, hero, seed, static: SceneStatic | None = None,
                  setup: SetupOperands | None = None):
    """The forward kernel's operands: (prims (P, 12), rays (6, R),
    seeds (4, R), spect (S*4, R)), every spectrum at each ray's hero
    wavelengths; prims holds the static's unrolled rows. setup (built
    with this static) supplies prims and the spectra table; without it
    they are built here."""
    if setup is None:
        prims = mk.pack_prims(scene, static)
        table = spec.expand_hero_table(scene.spectra)
    else:
        _check_setup(setup, scene, static)
        prims, table = setup.prims, setup.spect_table
    return _operands(prims, o, d, seed, spec.gather_hero(table, hero))


def _operands(prims, o, d, seed, spect):
    return (prims, torch.cat([o, d], dim=0).contiguous(), seed.contiguous(),
            spect.contiguous())


def mesh_packs_for(scene, static: SceneStatic, mesh_plans=None):
    """Chunk BVH packing (kernels/meshpack.py) of every mesh part, on the
    scene's device, under mesh_plans (one per part) when given."""
    plans = mesh_plans if mesh_plans is not None else (None,) * len(
        static.mesh_parts)
    return tuple(meshpack.pack_scene_mesh(scene, part, plan)
                 for part, plan in zip(static.mesh_parts, plans))


def wavefront_forward(static: SceneStatic, max_depth: int, rr_start: int,
                      prims, rays, seeds, spect, *mesh_arrays,
                      taped: bool = False, work=None):
    """The wavefront of a scene with mesh parts (the JAX package's
    ``_wavefront_forward``, tracer/pallas.py:210-351): operands as
    ``kernels.megakernel.forward``'s -> radiance (4, R), or with taped
    (L, tape_idx (max_depth+1, R) i32, tape_sh (max_depth+1, n_lights, R)
    i32), the contract of ``forward_winners``.

    Each bounce runs the main cast, one shade step and, per light, a
    shadow cast; the unoccluded contributions are added to L in ascending
    light order. Every cast is binned (``kernels.binned``) over its live
    rays, bounded by the occlusion bound: the main cast by the unrolled
    rows' winner t (the first bounce scans them here, in torch; later
    bounces read the previous shade step's), a shadow cast by the light
    distance t_su. A sparse cast is compacted into batches
    (MESH_CAST_BATCH_FRACTION, MESH_CAST_THRESHOLD_FRACTION) and a cast
    with no live ray launches nothing. Untaped, a shadow cast is the
    any-hit cast (``mesh_occluded_batched``); taped, the closest-hit cast,
    whose winner feeds tape_sh where it occludes ``(i >= 0) & (t <=
    t_su)``. ``work``, ``kernels.binned.new_work``'s counters, gathers the
    counting builds' work of the casts' kernels."""
    R = rays.shape[1]
    D = int(max_depth) + 1
    n_lights = len(static.light_rows)
    dev = rays.device
    i32 = dict(dtype=torch.int32, device=dev)
    carry_f = torch.cat([rays, torch.zeros((4, R), device=dev),
                         torch.ones((6, R), device=dev)])
    carry_u = mk._u32_bits(seeds)
    carry_i = torch.zeros((4, R), **i32)
    carry_i[0] = -1
    carry_i[3] = 1
    if taped:
        tape_idx = torch.empty((D, R), **i32)
        tape_sh = torch.empty((D, n_lights, R), **i32)
    batch = R // MESH_CAST_BATCH_FRACTION
    threshold = R // MESH_CAST_THRESHOLD_FRACTION

    def cast(ray_planes, bound, live, exclude):
        """The gated closest-hit cast (tracer/pallas.py:253-275)."""
        n_live = bn.count_live(live)
        if n_live == 0:
            empty_f = torch.zeros((4, R), device=dev)
            empty_f[0] = math.inf
            return empty_f, torch.full((1, R), -1, **i32)
        return bn.mesh_closest_hit_batched(
            static, mesh_arrays, ray_planes, exclude, bound, active=live,
            batch=batch, threshold=threshold, n_live=n_live, work=work)

    def occluded(ray_planes, t_su, live, exclude):
        """The gated any-hit cast (tracer/pallas.py:326-338)."""
        n_live = bn.count_live(live)
        if n_live == 0:
            return torch.zeros((R,), dtype=torch.bool, device=dev)
        return bn.mesh_occluded_batched(
            static, mesh_arrays, ray_planes, exclude, t_su, active=live,
            batch=batch, threshold=threshold, n_live=n_live, work=work)

    un = ()
    for depth in range(D):
        active = carry_i[3] != 0
        if un:
            bound = un[0][0]
        else:  # the camera rays' unrolled winner (tracer/pallas.py:285-294)
            bound = mk._scan_primitives(static, prims, tuple(carry_f[0:3]),
                                        tuple(carry_f[3:6]), carry_i[0])["t"]
        mesh_f, mesh_i = cast(carry_f[:6], bound, active, carry_i[0])
        (carry_f, carry_u, carry_i, t_idx, sh_f, sh_i,
         *un) = mk.shade_step(static, depth, max_depth, rr_start, prims,
                              carry_f, carry_u, carry_i, spect, mesh_f,
                              mesh_i, *un)
        for l in range(n_lights):
            fb = 3 + 8 * l
            t_su = sh_f[fb + 3]
            lsel = sh_i[2 * l + 1] != 0
            sh_rays = torch.cat([sh_f[0:3], sh_f[fb:fb + 3]])
            if taped:
                sh_t, sh_id = cast(sh_rays, t_su, lsel, t_idx)
                occl = (sh_id[0] >= 0) & (sh_t[0] <= t_su)
                tape_sh[depth, l] = torch.where(occl, sh_id[0], sh_i[2 * l])
            else:
                occl = occluded(sh_rays, t_su, lsel, t_idx)
            carry_f[6:10] += torch.where(occl, 0.0, sh_f[fb + 4:fb + 8])
        if taped:
            tape_idx[depth] = t_idx
    if taped:
        return carry_f[6:10], tape_idx, tape_sh
    return carry_f[6:10]


class MeshWavefrontFn(torch.autograd.Function):
    """``kernels.megakernel.MeshTraceFn`` with the wavefront as its
    forward (the JAX package's ``_mesh_call_wf``, tracer/pallas.py:354-380):
    under grad the taped ``wavefront_forward``, whose winner tapes are
    ``forward_winners``', and the same guided-replay backward; with no
    input needing a gradient, or under no_grad, the untaped wavefront.

        radiance = MeshWavefrontFn.apply(static, max_depth, rr_start,
                                         prims_full, rays, seeds, spect,
                                         cats, *mesh_arrays)
    """

    @classmethod
    def apply(cls, static, max_depth, rr_start, prims_full, rays, seeds,
              spect, cats, *mesh_arrays):
        # grad mode is off inside forward: decide here (MeshTraceFn.apply)
        if not torch.is_grad_enabled():
            return wavefront_forward(static, max_depth, rr_start,
                                     mk._unrolled(static, prims_full), rays,
                                     seeds, spect, *mesh_arrays)
        return super().apply(static, max_depth, rr_start, prims_full, rays,
                             seeds, spect, cats, *mesh_arrays)

    @staticmethod
    def forward(ctx, static, max_depth, rr_start, prims_full, rays, seeds,
                spect, cats, *mesh_arrays):
        return mk._replay_forward(ctx, wavefront_forward, static,
                                  max_depth, rr_start, prims_full, rays,
                                  seeds, spect, cats, mesh_arrays)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return mk._replay_backward(ctx, g)


def _resolve(scene, static, backward, wavefront, mesh_packs, mesh_plans):
    """Resolve the dispatch knobs and the mesh arrays shared by every
    entry point -> (static, backward, wavefront, mesh_arrays)."""
    if backward not in BACKWARDS:
        raise ValueError(f"unknown backward {backward!r}; expected one of "
                         f"{BACKWARDS}")
    if static is None:
        static = SceneStatic.from_scene(scene)
    if wavefront is None:
        wavefront = MESH_WAVEFRONT_DEFAULT
    wavefront = bool(wavefront and static.mesh_parts)
    mesh_arrays = ()
    if static.mesh_parts:
        if mesh_packs is None:
            mesh_packs = mesh_packs_for(scene, static, mesh_plans)
        mesh_arrays = tuple(a for pack in mesh_packs for a in pack.arrays)
        if backward in ("pallas", "pallas_taped"):
            backward = "replay"
    return static, backward, wavefront, mesh_arrays


def _dispatch(static, max_depth, rr_start, backward, wavefront, prims, rays,
              seeds, spect, mesh_arrays, cats):
    """One trace of prepared kernel operands -> radiance (4, R). prims is
    the full table for "replay", else the static's unrolled rows."""
    args = (static, int(max_depth), int(rr_start), prims, rays, seeds, spect)
    if backward == "replay":
        fn = MeshWavefrontFn if wavefront else mk.MeshTraceFn
        return fn.apply(*args, cats, *mesh_arrays)
    if wavefront:  # "none"
        with torch.no_grad():
            return wavefront_forward(*args, *mesh_arrays)
    if backward == "pallas":
        return mk.TraceFn.apply(*args)
    if backward == "pallas_taped":
        return mk.TraceTapedFn.apply(*args)
    with torch.no_grad():  # "none": the forward alone
        return mk.forward(*args, *mesh_arrays)


def trace_radiance(scene, o, d, hero, seed, max_depth: int,
                   rr_start: int = 1, static: SceneStatic | None = None,
                   backward: str = "pallas", mesh_packs=None,
                   wavefront: bool | None = None, mesh_plans=None,
                   setup: SetupOperands | None = None):
    """Planar path trace: o, d (3, R), hero (R,), seed (4, R) ->
    spectral radiance (4, R) at the hero wavelengths; differentiable with
    respect to the scene's geometry and spectra and to o, d. setup:
    ``setup_operands(scene, static, backward)``, built here when None."""
    if backward == "xla":
        raise ValueError(
            "backward='xla' recomputes the eager tracer from pixel "
            "coordinates, which trace_radiance does not take: use "
            "render_pixels_planar or render_sample")
    static, backward, wavefront, mesh_arrays = _resolve(
        scene, static, backward, wavefront, mesh_packs, mesh_plans)
    inputs = kernel_inputs(scene, o, d, hero, seed,
                           None if backward == "replay" else static, setup)
    return _dispatch(static, max_depth, rr_start, backward, wavefront,
                     *inputs, mesh_arrays, scene.primitives.category)


# The floating-point tensors of a Scene, by (sub-dataclass, field): the
# leaves EagerVjpFn differentiates.
SCENE_LEAVES = (("primitives", "data1"), ("primitives", "data2"),
                ("primitives", "data3"), (None, "spectra"), (None, "cie"),
                ("camera", "eye"), ("camera", "lookat"), ("camera", "up"),
                ("camera", "fov"))


def scene_leaves(scene):
    """The scene's SCENE_LEAVES tensors, in order."""
    return [getattr(getattr(scene, part) if part else scene, name)
            for part, name in SCENE_LEAVES]


def with_leaves(scene, leaves):
    """The scene with its SCENE_LEAVES tensors replaced by leaves."""
    top, sub = {}, {}
    for (part, name), leaf in zip(SCENE_LEAVES, leaves):
        if part is None:
            top[name] = leaf
        else:
            sub.setdefault(part, {})[name] = leaf
    for part, fields in sub.items():
        top[part] = dataclasses.replace(getattr(scene, part), **fields)
    return dataclasses.replace(scene, **top)


class EagerVjpFn(torch.autograd.Function):
    """``backward="xla"``: forward ``fwd()``, the kernel path's XYZ
    (3, R); backward recomputes ``recompute(leaves)``, the same XYZ by
    the eager tracer, under autograd from detached copies of the scene
    leaves, and returns each leaf's gradient.

        xyz = EagerVjpFn.apply(fwd, recompute, *scene_leaves(scene))
    """

    @classmethod
    def apply(cls, fwd, recompute, *leaves):
        # grad mode is off inside forward: decide here (needs_input_grad
        # ignores no_grad)
        if not (torch.is_grad_enabled()
                and any(leaf.requires_grad for leaf in leaves)):
            with torch.no_grad():
                return fwd()
        return super().apply(fwd, recompute, *leaves)

    @staticmethod
    def forward(ctx, fwd, recompute, *leaves):
        ctx.recompute = recompute
        ctx.save_for_backward(*leaves)
        return fwd()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        leaves = [leaf.detach().requires_grad_(n)
                  for leaf, n in zip(ctx.saved_tensors, need)]
        wanted = [leaf for leaf, n in zip(leaves, need) if n]
        with torch.enable_grad():
            out = ctx.recompute(leaves)
            grads = iter(torch.autograd.grad(out, wanted, g,
                                             allow_unused=True))
        result = []
        for leaf, n in zip(leaves, need):
            gl = next(grads) if n else None
            if n and gl is None:
                gl = torch.zeros_like(leaf)
            result.append(gl)
        return (None, None, *result)


def render_pixels_planar(scene, width: int, height: int, px, py, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None,
                         backward: str = "pallas", mesh_packs=None,
                         wavefront: bool | None = None, mesh_plans=None,
                         setup: SetupOperands | None = None,
                         sample_base=None):
    """Pixels px, py (R,) at a 1-based sample index -> XYZ (3, R). setup:
    ``setup_operands(scene, static, backward)``, built here when None;
    the spectra and CIE planes are gathered in one launch. sample_base:
    None, or an int64 scalar on the scene's device that the ray setup
    reads and adds to sample (``camera_planes``' base)."""
    if backward == "xla":
        if sample_base is not None:
            raise ValueError("backward='xla' recomputes the eager tracer at "
                             "a host sample: pass the sample, not a base")
        def fwd():
            return render_pixels_planar(
                scene, width, height, px, py, sample, max_depth, rr_start,
                static, "none", mesh_packs, wavefront, mesh_plans, setup)

        def recompute(leaves):
            return xla_tracer.render_pixels(
                with_leaves(scene, leaves), width, height, px, py, sample,
                max_depth, rr_start).T

        return EagerVjpFn.apply(fwd, recompute, *scene_leaves(scene))
    static, backward, wavefront, mesh_arrays = _resolve(
        scene, static, backward, wavefront, mesh_packs, mesh_plans)
    if setup is None:
        setup = setup_operands(scene, static, backward)
    _check_setup(setup, scene, None if backward == "replay" else static)
    with profiling.annotate("ray_setup"):
        o, d, hero, seed = camera_planes(scene, width, height, px, py,
                                         sample, sample_base)
    with profiling.annotate("gather"):
        spect, cie_p = spec.gather_hero_tables(
            (setup.spect_table, setup.cie_table), hero)
    with profiling.annotate("trace"):
        radiance = _dispatch(static, max_depth, rr_start, backward,
                             wavefront,
                             *_operands(setup.prims, o, d, seed, spect),
                             mesh_arrays, scene.primitives.category)
    with profiling.annotate("xyz"):
        return spec.spectral_to_xyz_p(cie_p, radiance)


def render_sample_planar(scene, width: int, height: int, sample,
                         max_depth: int = 8, rr_start: int = 1,
                         static: SceneStatic | None = None,
                         backward: str = "pallas", mesh_packs=None,
                         wavefront: bool | None = None, mesh_plans=None,
                         setup: SetupOperands | None = None,
                         sample_base=None):
    """One sample of the whole film -> XYZ (3, height, width). setup, as
    ``render_pixels_planar``'s, holds the film's pixel coordinates when
    built with them; sample_base as ``render_pixels_planar``'s."""
    if setup is not None and setup.px is not None:
        px, py = setup.px, setup.py
    else:
        px, py = tile_coords(width, height, 0, scene.device)
    xyz = render_pixels_planar(scene, width, height, px, py, sample,
                               max_depth, rr_start, static, backward,
                               mesh_packs, wavefront, mesh_plans, setup,
                               sample_base)
    return xyz.reshape(3, height, width)


def render_pixels(scene, width: int, height: int, px, py, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None,
                  backward: str = "pallas", mesh_packs=None,
                  wavefront: bool | None = None, mesh_plans=None,
                  vis_grads=False, stratified: bool = True):
    """Pixels px, py (R,) at a 1-based sample index -> XYZ (R, 3): the
    analogue of ``tracer.xla.render_pixels`` on the kernel path.

    vis_grads=("screen",) (or "screen") wraps the screen domain's warp
    (ops/warp.py) around the kernel trace: unstratified film coordinates,
    ``warp.screen_warp`` and the camera rays before it; the detJ and the
    zero-primal splat after the CIE conversion. The trace's autograd
    Function hands the ray cotangent d_rays of its backward kernel to the
    warp, which carries the boundary term into the gradient. The warp is
    the identity, so the image is the stratified=False render's bit for
    bit. The "light" and "hemi" domains hook inside the bounce loop:
    they are on the eager tracer (``tracer.xla.render_pixels``) only.
    stratified=False alone renders the same image without the warp.
    Where the jitter is unstratified, sample may also be an (R,) tensor,
    one sample index per ray, so that one call renders several samples;
    with the screen warp the rays are then whole films, film after film,
    each in row-major order."""
    domains = xla_tracer._vis_domains(vis_grads)
    if set(domains) - {"screen"}:
        raise ValueError(
            f"the kernel path supports vis_grads=('screen',); domains "
            f"{sorted(set(domains) - {'screen'})} hook inside the bounce "
            "loop: use tracer.xla.render_pixels(vis_grads=...) for them")
    if domains and px.shape[0] % (width * height):
        raise ValueError(
            "vis_grads 'screen' requires full-film row-major rays (the "
            "splat scatters by py*width + px)")
    if not domains and stratified:
        return render_pixels_planar(scene, width, height, px, py, sample,
                                    max_depth, rr_start, static, backward,
                                    mesh_packs, wavefront, mesh_plans).T
    if backward == "xla":
        raise ValueError(
            "backward='xla' recomputes the eager tracer's stratified render, "
            "so with the screen warp its gradient would drop the boundary "
            "term: use tracer.xla.render_pixels(vis_grads=..., "
            "stratified=...) for the eager gradient")
    seed = rng.seed_pixel_p(px, py, sample)
    cam = scene.camera
    frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up, cam.fov, width,
                               height)
    us, seed = rng.rand_p(seed)
    ut, seed = rng.rand_p(seed)
    s, t = cam_ops._film_st(width, height, px, py, us, ut)
    if domains:
        s, t, detj = warp.screen_warp(scene, width, height, s, t)
    o, d = cam_ops.film_ray(cam.eye, *frame, s, t)
    hero, seed = spec.sample_wavelengths_p(seed)
    radiance = trace_radiance(scene, o.T, d.T, hero, seed, max_depth,
                              rr_start, static, backward, mesh_packs,
                              wavefront, mesh_plans)
    cie_p = spec.gather_hero(spec.cie_window_exp(scene.cie), hero)
    xyz = spec.spectral_to_xyz_p(cie_p, radiance).T
    if domains:
        xyz = xyz * detj[..., None]
        xyz = xyz + xla_tracer._splat_correction(xyz, s, t, width, height)
    return xyz


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None,
                  backward: str = "pallas", mesh_packs=None,
                  wavefront: bool | None = None, mesh_plans=None,
                  vis_grads=False, stratified: bool = True):
    """One sample of the whole film -> XYZ (height, width, 3); vis_grads
    and stratified as ``render_pixels``'."""
    if xla_tracer._vis_domains(vis_grads) or not stratified:
        px, py = tile_coords(width, height, 0, scene.device)
        return render_pixels(scene, width, height, px, py, sample,
                             max_depth, rr_start, static, backward,
                             mesh_packs, wavefront, mesh_plans, vis_grads,
                             stratified).reshape(height, width, 3)
    return render_sample_planar(scene, width, height, sample, max_depth,
                                rr_start, static, backward, mesh_packs,
                                wavefront, mesh_plans).permute(1, 2, 0)


# accumulate_frame's frames by frame_graph_key, the newest last: at most
# GRAPH_ENTRIES, each a key seen once (no graph yet) or a captured graph
# with its private memory pool (~0.4 GB at 1024x1024, spp 4).
GRAPH_ENTRIES = 2
# The backwards whose frames may be graphed: those with a kernel forward.
GRAPH_BACKWARDS = ("pallas", "pallas_taped", "none")
_frame_graphs = collections.OrderedDict()
# accumulate_frame's frames: captured as a graph, replayed from one, and
# run eagerly (every call on the CPU among them).
graph_captures = 0
graph_replays = 0
graph_eager = 0
# The modules whose launch counters (ints named launches*) count a replayed
# frame's launches as its eager run counts them.
_COUNTED = (mk, setup_k, bn)


@dataclasses.dataclass
class FrameGraph:
    """A frame of ``accumulate_frame`` for one ``frame_graph_key``: the
    scene's tensors (held, so that no id in the key is reused while it
    lives) and its static. Once captured: the graph, the device tables its
    launches read (held, whatever the tables' cache drops), the int64
    scalar its ray setups add their sample to, its output (the frame's XYZ
    (3, R), which every replay writes again) and the launch counts of one
    frame."""
    tensors: tuple
    static: SceneStatic
    graph: object = None
    tables: tuple = ()
    base: torch.Tensor | None = None
    out: torch.Tensor | None = None
    launches: dict = dataclasses.field(default_factory=dict)


def _scene_tensors(scene) -> tuple:
    """Every tensor of the scene, in field order."""
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        out.extend(_scene_tensors(v) if dataclasses.is_dataclass(v) else (v,))
    return tuple(out)


def frame_graph_key(scene, width: int, height: int, spp: int,
                    max_depth: int, rr_start: int, backward: str) -> tuple:
    """The key of an ``accumulate_frame`` call's frame (any device): the
    call's shape and knobs, the scene's device, each scene tensor's
    identity and storage (the graph reads them at their addresses, so an
    in-place edit of a spectrum or a vertex shows in the next replay), and
    the version counters of its integer tensors (``SceneStatic.from_scene``
    reads them on the host)."""
    tensors = _scene_tensors(scene)
    return (int(width), int(height), int(spp), int(max_depth),
            int(rr_start), backward, scene.device,
            tuple((id(t), t.data_ptr()) for t in tensors),
            tuple(t._version for t in tensors if not t.is_floating_point()))


def eager_reasons(scene, backward: str) -> tuple:
    """Why ``accumulate_frame`` runs a call's frame eagerly, every reason
    that holds, empty where it may graph it: "device" (the scene is not on
    a CUDA device), "backward" (not one of GRAPH_BACKWARDS), "grad" (grad
    mode is on and a scene leaf requires grad). A scene with mesh parts,
    which its first frame finds, is kept eager too (the mesh paths read ray
    counts back to the host)."""
    out = []
    if scene.device.type != "cuda":
        out.append("device")
    if backward not in GRAPH_BACKWARDS:
        out.append("backward")
    if torch.is_grad_enabled() and any(leaf.requires_grad
                                       for leaf in scene_leaves(scene)):
        out.append("grad")
    return tuple(out)


def _launch_counts() -> dict:
    return {(m, k): v for m in _COUNTED for k, v in vars(m).items()
            if k.startswith("launches") and isinstance(v, int)}


def _add_launches(counts: dict, sign: int) -> None:
    for (m, k), v in counts.items():
        setattr(m, k, getattr(m, k) + sign * v)


def _accumulate_sample(scene, width, height, sample, accum, max_depth,
                       rr_start, static, setup, base, next_ray):
    """One sample of the pixels setup.px, setup.py added into accum (3, R)
    in place: the ray setup, the hero gather and, on the card, the
    forward's XYZ build (``kernels.megakernel.forward_xyz``), which
    converts each ray to XYZ as it retires and adds it in; no radiance
    plane, no CIE sum in torch. On the CPU the forward's plain version,
    then the epilogue's (``xyz_accumulate_reference``). accum ends as
    ``accum + render_pixels_planar(...)``, bit for bit. next_ray: the
    forward's zeroed (1,) ray counter."""
    with profiling.annotate("ray_setup"):
        o, d, hero, seed = camera_planes(scene, width, height, setup.px,
                                         setup.py, sample, base)
    with profiling.annotate("gather"):
        spect, cie_p = spec.gather_hero_tables(
            (setup.spect_table, setup.cie_table), hero)
    args = (static, max_depth, rr_start, setup.prims)
    if accum.is_cuda:
        with profiling.annotate("trace"):
            mk.forward_xyz(*args, o, d, seed, spect, cie_p, accum, next_ray)
        return
    with profiling.annotate("trace"):
        radiance = mk.forward_reference(*args, torch.cat([o, d]), seed, spect)
    with profiling.annotate("xyz"):
        mk.xyz_accumulate_reference(cie_p, radiance, accum)


def accumulate_pixels(scene, width: int, height: int, px, py, first: int,
                      spp: int, max_depth: int = 8, rr_start: int = 1,
                      static: SceneStatic | None = None,
                      backward: str = "pallas", mesh_plans=None, base=None,
                      chunk: int | None = None):
    """The kernel path's sum of samples first .. first+spp-1 (base + first
    .. where base, an int64 scalar on the scene's device, is given) over
    the pixels px, py (R,), the whole film row-major when None -> (static,
    XYZ (3, R)), accumulated in sample order. The static, the mesh packs
    (under mesh_plans, one plan per part) and the setup operands
    (``setup_operands``) are built once. chunk: rays per band, each band's
    samples summed before the next band starts (one band when None).

    A scene without mesh parts, traced with a kernel forward and no
    gradient wanted (``eager_reasons`` gives no reason but the device),
    adds each sample into the accumulator in place
    (``_accumulate_sample``); any other sums ``render_pixels_planar``'s
    images, differentiably. Both give the same image, bit for bit."""
    with profiling.annotate("setup"):
        if static is None:
            static = SceneStatic.from_scene(scene)
        packs = (mesh_packs_for(scene, static, mesh_plans)
                 if static.mesh_parts else None)
        if px is None:
            px, py = tile_coords(width, height, 0, scene.device)
        setup = setup_operands(scene, static, backward, px, py)
        in_place = not static.mesh_parts and set(
            eager_reasons(scene, backward)) <= {"device"}
    bands = []
    for bpx, bpy in xla_tracer.pixel_bands(setup.px, setup.py, chunk):
        band = dataclasses.replace(setup, px=bpx, py=bpy)
        accum = torch.zeros((3, bpx.shape[0]), dtype=torch.float32,
                            device=scene.device)
        if in_place:  # the forward's ray counters, zeroed at once
            counters = torch.zeros((spp, 1), dtype=torch.int64,
                                   device=scene.device)
        for i, s in enumerate(range(first, first + spp)):
            if in_place:
                _accumulate_sample(scene, width, height, s, accum, max_depth,
                                   rr_start, static, band, base, counters[i])
            else:
                accum = accum + render_pixels_planar(
                    scene, width, height, bpx, bpy, s, max_depth, rr_start,
                    static, backward, packs, setup=band, sample_base=base)
        bands.append(accum)
    return static, bands[0] if len(bands) == 1 else torch.cat(bands, dim=1)


def _film(accum, width: int, height: int):
    """A whole film's XYZ (3, R) -> (H, W, 3), contiguous."""
    return accum.view(3, height, width).permute(1, 2, 0).contiguous()


def _capture(entry: FrameGraph, scene, width, height, spp, max_depth,
             rr_start, backward) -> None:
    """Capture the entry's frame, samples base + 0 .. spp-1, on a side
    stream of the scene's device, into a memory pool of its own; the
    capture's launches are not counted. Not ``torch.cuda.graph``, which
    first synchronizes and empties the allocator's cache: that costs the
    capture ~7 ms at 1024x1024, and the next eager frame's allocations
    about as much again."""
    global graph_captures
    dev = scene.device
    with torch.cuda.device(dev):
        entry.tables = mk._tables(entry.static, dev)  # built before capture
        entry.base = torch.zeros((), dtype=torch.int64, device=dev)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with (profiling.annotate("graph.capture"), torch.no_grad(),
              torch.cuda.stream(stream)):
            graph.capture_begin()
            try:
                _, entry.out = accumulate_pixels(
                    scene, width, height, None, None, 0, spp, max_depth,
                    rr_start, entry.static, backward, base=entry.base)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    after = _launch_counts()
    entry.launches = {k: after[k] - v for k, v in before.items()
                      if after[k] != v}
    _add_launches(entry.launches, -1)
    entry.graph = graph
    graph_captures += 1


def _replay(entry: FrameGraph, first_sample: int) -> torch.Tensor:
    """The entry's frame at samples first_sample .. : one replay on the
    current stream -> its output, the graph's own buffer."""
    global graph_replays
    with torch.cuda.device(entry.base.device), \
            profiling.annotate("graph.replay"):
        entry.base.fill_(int(first_sample) & rng.MASK)
        entry.graph.replay()
    _add_launches(entry.launches, 1)
    graph_replays += 1
    return entry.out


def accumulate_frame(scene, width: int, height: int, spp: int,
                     max_depth: int = 8, rr_start: int = 1,
                     first_sample: int = 1, backward: str = "pallas"):
    """Sum of samples first_sample .. first_sample+spp-1 over the whole
    film -> XYZ (3, R), row-major, accumulated in sample order. Mesh packs
    and the setup operands (``setup_operands``) are built once.

    Where ``eager_reasons`` gives none, the frame of a key
    (``frame_graph_key``) seen once before is captured as a CUDA graph of
    this body, which reads the sample from the device, and replayed, then
    replayed on every later call of the key (GRAPH_ENTRIES keys are kept):
    the same launches, the same image bit for bit, and the launch counters
    counting them as an eager frame does. A replayed frame returns the
    graph's own output buffer, which the key's next replay writes again:
    read it on the current stream before then (``render_accumulate`` copies
    it, ``tracer.api.render`` finishes it in one launch). A key first seen
    runs eagerly, and a scene with mesh parts always (no entry is kept for
    it); an eager frame returns a tensor of its own."""
    global graph_eager
    key = None
    if not eager_reasons(scene, backward):
        key = frame_graph_key(scene, width, height, spp, max_depth,
                              rr_start, backward)
        entry = _frame_graphs.get(key)
        if entry is not None:
            _frame_graphs.move_to_end(key)
            if entry.graph is None:
                _capture(entry, scene, width, height, spp, max_depth,
                         rr_start, backward)
            return _replay(entry, first_sample)
    graph_eager += 1
    static, accum = accumulate_pixels(scene, width, height, None, None,
                                      first_sample, spp, max_depth, rr_start,
                                      backward=backward)
    if key is not None and not static.mesh_parts:
        _frame_graphs[key] = FrameGraph(_scene_tensors(scene), static)
        while len(_frame_graphs) > GRAPH_ENTRIES:
            _frame_graphs.popitem(last=False)
    return accum


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, backward: str = "pallas"):
    """``accumulate_frame``'s sum -> XYZ (H, W, 3), a fresh tensor each
    call (a replayed frame's buffer copied once)."""
    return _film(accumulate_frame(scene, width, height, spp, max_depth,
                                  rr_start, first_sample, backward),
                 width, height)
