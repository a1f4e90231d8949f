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


def camera_planes(scene, width: int, height: int, px, py, sample):
    """Per-ray setup for pixels px, py (R,) at a 1-based sample index:
    seeds, jittered camera rays and the hero-wavelength draw
    (``kernels.setup.ray_setup``: the ray-setup kernel on the card, its
    plain version on the CPU), differentiable with respect to the
    camera's tensors (``kernels.setup.RaySetupFn``: on the card its
    backward is the ray setup's backward kernel).

    Returns (o (3, R), d (3, R), hero (R,), seed (4, R))."""
    return setup_k.ray_setup(scene.camera, width, height, px, py, sample)


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
                         setup: SetupOperands | None = None):
    """Pixels px, py (R,) at a 1-based sample index -> XYZ (3, R). setup:
    ``setup_operands(scene, static, backward)``, built here when None;
    the spectra and CIE planes are gathered in one launch."""
    if backward == "xla":
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
                                         sample)
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
                         setup: SetupOperands | None = None):
    """One sample of the whole film -> XYZ (3, height, width). setup, as
    ``render_pixels_planar``'s, holds the film's pixel coordinates when
    built with them."""
    if setup is not None and setup.px is not None:
        px, py = setup.px, setup.py
    else:
        px, py = tile_coords(width, height, 0, scene.device)
    xyz = render_pixels_planar(scene, width, height, px, py, sample,
                               max_depth, rr_start, static, backward,
                               mesh_packs, wavefront, mesh_plans, setup)
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


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, backward: str = "pallas"):
    """Sum of samples first_sample .. first_sample+spp-1 -> XYZ (H, W, 3),
    accumulated in sample order. Mesh packs and the setup operands
    (``setup_operands``) are built once."""
    with profiling.annotate("setup"):
        static = SceneStatic.from_scene(scene)
        packs = mesh_packs_for(scene, static) if static.mesh_parts else None
        setup = setup_operands(scene, static, backward,
                               *tile_coords(width, height, 0, scene.device))
    accum = torch.zeros((3, height, width), dtype=torch.float32,
                        device=scene.device)
    for s in range(first_sample, first_sample + spp):
        accum = accum + render_sample_planar(scene, width, height, s,
                                             max_depth, rr_start, static,
                                             backward, packs, setup=setup)
    return accum.permute(1, 2, 0).contiguous()
