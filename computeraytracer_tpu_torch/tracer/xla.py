"""The eager torch tracer (port of computeraytracer_tpu/tracer/xla.py,
whose name it keeps: ``kernel="xla"`` and ``backward="xla"`` are the
API's values for it).

Vectorized over rays, one Python loop step per bounce, with masked
lanes: each bounce is a sequence of torch ops over (R,) and (R, k)
tensors, on the device of the scene. It serves three roles:
1. the path of ``kernel="xla"``, which ``tracer.api`` chooses for every
   render and loss (``accumulate_pixels``, its one loop over samples),
   brute-force or through a BVH (``bvh/``);
2. the differentiable gradient oracle: torch autograd of the whole
   trace, with detached sampling (the RNG draws are integer state, so
   gradients treat sampling decisions as fixed: common random numbers);
   ``backward="xla"`` in ``tracer.kernel`` recomputes it;
3. the semantic specification of the kernel path: the same pcg4d
   streams in the same draw order.

Estimator: NEE with the power heuristic, cosine-hemisphere diffuse
bounces, Fresnel reflect/refract glass with beta * eta^2 radiance
scaling and Beer-Lambert attenuation through the LAST spectrum, and
Russian roulette on max(beta * eta_scale) for depth > rr_start.

Every row gather is ``ops.intersect.take`` (index_select), whose
backward on the card is index_add_ with atomics: the oracle's gradients
agree across runs within rounding, not bit for bit. Ties in gradients
follow JAX where torch differs: constants are bounded
with ``torch.maximum`` (``ops.intersect.maximum``), never ``clamp``, and
Russian roulette's max is ``torch.amax``, which splits the gradient
among equal channels. ``abs`` at exactly 0 has gradient 0 here and 1 in
JAX (the diffuse bounce's |cos|); the tests' tolerance absorbs it.
``use_remat=True`` (the default) recomputes each bounce in the backward
(``torch.utils.checkpoint``), so autograd keeps only the carries between
bounces.

Visibility gradients (``vis_grads``): the warped-area reparameterization
of ``ops/warp.py`` on the screen domain (around the camera rays, with a
zero-primal splat across pixels), the light-area domain (inside NEE) and
the cosine-hemisphere domain (the diffuse bounce). Every warp is exactly
the identity, so the image of any ``vis_grads`` mode is the
``stratified=False`` render bit for bit; only the gradients gain the
boundary terms of moving silhouettes and shadows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import fresnel as fr
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops import sampling
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.ops import warp
from computeraytracer_tpu_torch.ops.intersect import dot, maximum, take

ETA1, ETA2 = 1.0, 1.5  # glass interface


def _vis_domains(vis_grads):
    """Normalize the vis_grads flag: False -> (), True -> all three
    warped domains, or an explicit subset like ("screen", "light")."""
    if not vis_grads:
        return ()
    if vis_grads is True:
        return ("screen", "light", "hemi")
    if isinstance(vis_grads, str):
        vis_grads = (vis_grads,)
    domains = tuple(vis_grads)
    bad = set(domains) - {"screen", "light", "hemi"}
    if bad:
        raise ValueError(f"unknown vis_grads domains: {sorted(bad)}")
    return domains


class PathState(NamedTuple):
    seed: torch.Tensor        # (R, 4) int64 u32 words
    ray_o: torch.Tensor       # (R, 3)
    ray_d: torch.Tensor       # (R, 3)
    radiance: torch.Tensor    # (R, 4) accumulated spectral radiance
    beta: torch.Tensor        # (R, 4) throughput
    last_pdf: torch.Tensor    # (R,) pdf of the previous BSDF bounce
    eta_scale: torch.Tensor   # (R,)
    exclude: torch.Tensor     # (R,) int64 excluded primitive (-1 none)
    specular: torch.Tensor    # (R,) bool: the last bounce was specular
    in_transmission: torch.Tensor  # (R,) bool: inside glass
    active: torch.Tensor      # (R,) bool: the path is still alive


def init_state(o, d, seed) -> PathState:
    r = o.shape[:-1]
    dev = o.device

    def f(shape, fill):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    return PathState(
        seed=seed,
        ray_o=o,
        ray_d=d,
        radiance=f(r + (4,), 0.0),
        beta=f(r + (4,), 1.0),
        last_pdf=f(r, 1.0),
        eta_scale=f(r, 1.0),
        exclude=torch.full(r, isect.NO_INDEX, dtype=torch.int64, device=dev),
        specular=torch.zeros(r, dtype=torch.bool, device=dev),
        in_transmission=torch.zeros(r, dtype=torch.bool, device=dev),
        active=torch.ones(r, dtype=torch.bool, device=dev),
    )


def _nee(scene, hit, brdf, lambdas, beta, is_diffuse, u_l, u_p, v_p,
         isect_fn, vis_grads=False):
    """Next-event estimation: the MIS-weighted radiance contribution
    (R, 4) of diffuse lanes; with the "light" domain, its light-area
    sample warped and the contribution scaled by the warp's detJ."""
    prims = scene.primitives
    n_lights = scene.lights.count
    li = sampling.pick_light(u_l, n_lights)
    l_prim = take(scene.lights.prim_index, li).long()
    l_origin = take(prims.data1, l_prim)
    l_edge1 = take(prims.data2, l_prim)
    l_edge2 = take(prims.data3, l_prim)
    warped = "light" in _vis_domains(vis_grads)
    if warped:
        u_p, v_p, detj = warp.light_warp(
            scene, hit.position, hit.index, l_origin, l_edge1, l_edge2,
            l_prim, u_p, v_p, is_diffuse)
    p_on_light = sampling.point_on_light(l_origin, l_edge1, l_edge2, u_p,
                                         v_p)
    ldir = isect.safe_normalize(p_on_light - hit.position)
    shadow = isect_fn(hit.position, ldir, hit.index)
    unoccluded = shadow.hit & (shadow.index == l_prim)

    cos_theta = maximum(dot(hit.normal, ldir), 0.0)
    le = spec.sample_spectrum(scene.spectra,
                              take(scene.lights.emission, li),
                              lambdas) * cos_theta[..., None]
    pdf_l = sampling.light_solid_angle_pdf(
        l_edge1, l_edge2, n_lights, shadow.normal, ldir, shadow.position,
        hit.position)
    pdf_b = cos_theta / math.pi
    weight_l = sampling.power_heuristic(1.0, pdf_l, 1.0, pdf_b)
    contrib = le * (weight_l / maximum(pdf_l, 1e-12))[..., None]
    lit = (is_diffuse & unoccluded)[..., None]
    out = torch.where(lit, brdf * contrib * beta, 0.0)
    if warped:
        out = out * detj[..., None]
    return out


def _splat_correction(xyz, s, t, width, height):
    """Zero-primal tent-filter splat of screen-warped samples.

    The screen warp moves a sample's film coordinate with the geometry,
    but the sample stays binned to its pixel, so the flux of radiance
    BETWEEN pixels never reaches autograd. Each sample therefore also
    adds (k - k.detach()) * f to the 2x2 pixels of a unit tent filter at
    the WARPED coordinate: exactly zero in value, while the derivative
    tent-distributes d(film coordinate)/d(theta) to the pixels it
    crosses. Needs whole films' rays, film after film, each in row-major
    order (ray k*W*H + py*W + px is pixel (px, py) of film k)."""
    # pixel px covers s*W in [px, px+1) (center px+.5); row py covers
    # H - t*H in (py-1, py] (center py-.5): the reference's t flip
    gx = s * float(width) - 0.5
    gy = (float(height) - t * float(height)) + 0.5
    x0 = torch.floor(gx.detach())
    y0 = torch.floor(gy.detach())
    f = xyz.detach()
    film = width * height
    base = torch.div(torch.arange(xyz.shape[0], device=xyz.device), film,
                     rounding_mode="floor") * film
    corr = torch.zeros_like(xyz)
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            qx = x0 + dx
            qy = y0 + dy
            kk = (maximum(1.0 - (gx - qx).abs(), 0.0)
                  * maximum(1.0 - (gy - qy).abs(), 0.0))
            w_corr = kk - kk.detach()
            qxi = qx.to(torch.int64).clamp(0, width - 1)
            qyi = qy.to(torch.int64).clamp(0, height - 1)
            lin = base + qyi * width + qxi
            corr = corr.index_add(0, lin, w_corr[..., None] * f)
    return corr


def make_intersector(scene, bvh=None):
    """Closest-hit closure: brute linear scan, or the BVH when given."""
    if bvh is None:
        return lambda o, d, exclude: isect.intersect_brute(
            o, d, exclude, scene.primitives)
    from computeraytracer_tpu_torch.bvh import traverse as bvh_traverse
    return lambda o, d, exclude: bvh_traverse.intersect_bvh(
        o, d, exclude, scene.primitives, bvh)


def trace_step(scene, lambdas, state: PathState, depth: int,
               max_depth: int, rr_start: int,
               isect_fn=None, vis_grads=False) -> PathState:
    """One bounce of the path-trace loop over all lanes."""
    prims = scene.primitives
    if isect_fn is None:
        isect_fn = make_intersector(scene)
    seed = state.seed
    o, d = state.ray_o, state.ray_d
    beta, radiance = state.beta, state.radiance
    active = state.active

    hit = isect_fn(o, d, state.exclude)
    lane_hit = active & hit.hit
    active = active & hit.hit  # a miss ends the path
    exclude = torch.where(lane_hit, hit.index, state.exclude)

    # emissive hit: MIS-weighted radiance, then the path ends
    is_light = lane_hit & (hit.material == C.LIGHT)
    le = spec.sample_spectrum(scene.spectra, hit.emission, lambdas)
    pdf_l_hit = sampling.light_solid_angle_pdf(
        take(prims.data2, hit.index), take(prims.data3, hit.index),
        scene.lights.count,
        hit.normal, d, hit.position, o)
    weight_b = sampling.power_heuristic(1.0, state.last_pdf, 1.0, pdf_l_hit)
    mis_w = torch.where(state.specular | (depth == 0), 1.0, weight_b)
    radiance = radiance + torch.where(
        is_light[..., None], beta * le * mis_w[..., None], 0.0)
    active = active & ~is_light

    # depth cap: the final iteration only harvests light
    scatter = active & lane_hit & ~is_light & (depth < max_depth)
    active = active & scatter

    # Beer-Lambert through the extinction spectrum (the LAST spectra row);
    # NaN-safe distance (missed lanes have position == o)
    delta = hit.position - o
    dist = isect.safe_sqrt(dot(delta, delta))
    ext = take(scene.spectra[-1], lambdas)
    atten = torch.exp(-ext * dist[..., None])
    beta = torch.where((scatter & state.in_transmission)[..., None],
                       beta * atten, beta)

    is_diffuse = scatter & (hit.material == C.DIFFUSE)
    is_glass = scatter & (hit.material == C.GLASS)
    is_mirror = scatter & (hit.material == C.MIRROR)

    # DIFFUSE: 5 draws
    u_l, seed = rng.rand_masked(seed, is_diffuse)
    u_p, seed = rng.rand_masked(seed, is_diffuse)
    v_p, seed = rng.rand_masked(seed, is_diffuse)
    u_h, seed = rng.rand_masked(seed, is_diffuse)
    v_h, seed = rng.rand_masked(seed, is_diffuse)

    brdf = spec.sample_spectrum(scene.spectra, hit.reflectance,
                                lambdas) / math.pi
    radiance = radiance + _nee(scene, hit, brdf, lambdas, beta, is_diffuse,
                               u_l, u_p, v_p, isect_fn, vis_grads)
    warped = "hemi" in _vis_domains(vis_grads)
    if warped:
        u_h, v_h, detj_h = warp.hemisphere_warp(
            scene, hit.position, hit.normal, hit.index, u_h, v_h,
            is_diffuse)
    bounce_dir, bounce_pdf = sampling.cosine_hemisphere(hit.normal, u_h, v_h)
    cos_b = dot(hit.normal, bounce_dir).abs()
    beta_diffuse = beta * brdf * (
        cos_b / maximum(bounce_pdf, 1e-12))[..., None]
    if warped:
        # the hemisphere warp's detJ scales all that the path gathers
        # after this bounce (beta carries it forward)
        beta_diffuse = beta_diffuse * detj_h[..., None]

    # GLASS: 1 draw
    u_g, seed = rng.rand_masked(seed, is_glass)
    cos_in = dot(hit.normal, d)
    reflectance = fr.fresnel_s(d, hit.normal, ETA1, ETA2)
    # eta = eta1/eta2, inverted when hitting the back face
    eta = torch.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    n_glass = torch.where((cos_in > 0.0)[..., None], -hit.normal, hit.normal)
    pr = reflectance
    pt = 1.0 - reflectance
    choose_reflect = u_g < pr / maximum(pr + pt, 1e-12)
    refl_dir = fr.reflect(d, n_glass)
    refr_dir = isect.safe_normalize(fr.refract(d, n_glass, eta))
    glass_dir = torch.where(choose_reflect[..., None], refl_dir, refr_dir)
    eta2v = (eta * eta)[..., None]
    beta_glass = torch.where(choose_reflect[..., None], beta, beta * eta2v)
    eta_scale_glass = torch.where(choose_reflect, state.eta_scale,
                                  state.eta_scale / (eta * eta))
    in_trans_glass = torch.where(choose_reflect, state.in_transmission,
                                 ~state.in_transmission)

    # MIRROR: 0 draws
    mirror_dir = fr.reflect(d, hit.normal)

    # state merge
    new_o = torch.where(scatter[..., None], hit.position, o)
    new_d = torch.where(
        is_diffuse[..., None], bounce_dir,
        torch.where(is_glass[..., None], glass_dir,
                    torch.where(is_mirror[..., None], mirror_dir, d)))
    beta = torch.where(is_diffuse[..., None], beta_diffuse,
                       torch.where(is_glass[..., None], beta_glass, beta))
    last_pdf = torch.where(is_diffuse, bounce_pdf, state.last_pdf)
    specular = (~is_diffuse) & ((is_glass | is_mirror) | state.specular)
    # glass and mirror clear the exclusion so the ray can hit the same
    # primitive again from inside
    exclude = torch.where(is_glass | is_mirror, isect.NO_INDEX, exclude)
    eta_scale = torch.where(is_glass, eta_scale_glass, state.eta_scale)
    in_transmission = torch.where(is_glass, in_trans_glass,
                                  state.in_transmission)

    # Russian roulette on the xyz channels only, as the reference does
    rbeta = beta * eta_scale[..., None]
    max_c = torch.amax(rbeta[..., :3], dim=-1)
    rr = active & (depth > rr_start) & (max_c < 1.0)
    u_r, seed = rng.rand_masked(seed, rr)
    q = maximum(1.0 - max_c, 0.0)
    killed = rr & (u_r < q)
    active = active & ~killed
    beta = torch.where((rr & ~killed)[..., None],
                       beta / maximum(1.0 - q, 1e-12)[..., None], beta)

    return PathState(seed, new_o, new_d, radiance, beta, last_pdf,
                     eta_scale, exclude, specular, in_transmission, active)


def path_trace(scene, o, d, lambdas, seed, max_depth: int,
               rr_start: int = 1, use_remat: bool = True, bvh=None,
               vis_grads=False):
    """Trace rays to completion. Returns (radiance (R, 4), final seed).

    Runs max_depth + 1 iterations: iteration i scatters only while
    i < max_depth; the last one harvests emissive hits. A bounce in which
    no ray is alive is the identity and is skipped. With use_remat and
    grad enabled, each bounce is a ``torch.utils.checkpoint``."""
    state = init_state(o, d, seed)
    isect_fn = make_intersector(scene, bvh)

    def body(depth, *fields):
        return tuple(trace_step(scene, lambdas, PathState(*fields), depth,
                                max_depth, rr_start, isect_fn, vis_grads))

    remat = use_remat and torch.is_grad_enabled()
    for depth in range(int(max_depth) + 1):
        if not bool(state.active.any()):
            break
        if remat:
            state = PathState(*checkpoint(body, depth, *state,
                                          use_reentrant=False,
                                          preserve_rng_state=False))
        else:
            state = PathState(*body(depth, *state))
    return state.radiance, state.seed


def render_pixels(scene, width: int, height: int, px, py, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  use_remat: bool = True, bvh=None,
                  vis_grads=False, stratified: bool = True):
    """Trace one sample for pixel coordinates px, py (R,) -> XYZ (R, 3).

    Seeds derive from the GLOBAL pixel coordinates and the 1-based sample
    counter, so any tiling of the film gives the same values as one
    render. stratified=False draws the sub-pixel jitter unstratified.

    vis_grads (False, True for all three domains, or a subset of
    "screen", "light" and "hemi") turns on the warped-area
    reparameterization of ops/warp.py, so that autograd also captures the
    boundary terms of moving silhouettes and shadows. Every vis_grads
    mode renders unstratified (the shared-stratum jitter is correlated
    along the pixel's diagonal, which biases the warp's 2D boundary
    integral) and its image is the stratified=False render's bit for
    bit. The "screen" domain needs whole films, each in row-major order
    (its splat scatters by py*width + px within each film); "light" and
    "hemi" take any tiling. Where the jitter is unstratified, sample may
    also be an (R,) tensor, one sample index per ray, so that one call
    renders several samples: n films of rays for the screen domain."""
    domains = _vis_domains(vis_grads)
    if "screen" in domains and px.shape[0] % (width * height):
        raise ValueError(
            "vis_grads 'screen' requires full-film rays "
            f"(got {px.shape[0]} rays for {width}x{height}); use the "
            "'light'/'hemi' domains for tiled renders")
    if bvh is not None:
        from computeraytracer_tpu_torch.bvh import builder
        bvh = builder.to_device(bvh, scene.device)
    seed = rng.seed_pixel(px, py, sample)
    cam = scene.camera
    if domains or not stratified:
        frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up, cam.fov,
                                   width, height)
        s, t, seed = cam_ops.film_coords(width, height, px, py, sample, seed,
                                         stratified=False)
        if "screen" in domains:
            s, t, detj = warp.screen_warp(scene, width, height, s, t)
        o, d = cam_ops.film_ray(cam.eye, *frame, s, t)
    else:
        o, d, seed = cam_ops.camera_rays(cam.eye, cam.lookat, cam.up,
                                         cam.fov, width, height, px, py,
                                         sample, seed)
    lambdas, seed = spec.sample_wavelengths(seed)
    radiance, _ = path_trace(scene, o, d, lambdas, seed, max_depth,
                             rr_start, use_remat, bvh=bvh,
                             vis_grads=vis_grads)
    xyz = spec.spectral_to_xyz(scene.cie, radiance, lambdas)
    if "screen" in domains:
        xyz = xyz * detj[..., None]
        xyz = xyz + _splat_correction(xyz, s, t, width, height)
    return xyz


def tile_coords(width: int, tile_h: int, y0: int, device=None):
    """Global pixel coordinates (px, py) of film rows [y0, y0+tile_h),
    row-major, as int64 tensors."""
    ys = y0 + torch.arange(tile_h, dtype=torch.int64, device=device)
    xs = torch.arange(width, dtype=torch.int64, device=device)
    py = ys[:, None].expand(tile_h, width).reshape(-1)
    px = xs[None, :].expand(tile_h, width).reshape(-1)
    return px, py


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  use_remat: bool = True, bvh=None,
                  vis_grads=False, stratified: bool = True):
    """One progressive sample (1-based counter) -> XYZ (H, W, 3);
    differentiable with respect to the scene's tensors."""
    px, py = tile_coords(width, height, 0, scene.device)
    xyz = render_pixels(scene, width, height, px, py, sample, max_depth,
                        rr_start, use_remat, bvh=bvh, vis_grads=vis_grads,
                        stratified=stratified)
    return xyz.reshape(height, width, 3)


def pixel_bands(px, py, chunk: int | None = None):
    """The pixels px, py (R,) in bands of chunk rays, in order: [(px, py)]
    when chunk is None."""
    if not chunk:
        return [(px, py)]
    return [(px[i:i + chunk], py[i:i + chunk])
            for i in range(0, px.shape[0], chunk)]


def accumulate_pixels(scene, width: int, height: int, px, py, first: int,
                      spp: int, max_depth: int = 8, rr_start: int = 1,
                      use_remat: bool = True, bvh=None, vis_grads=False,
                      chunk: int | None = None):
    """The eager tracer's sum of samples first .. first+spp-1 over the
    pixels px, py (R,), the whole film row-major when None -> XYZ (R, 3),
    accumulated in sample order; differentiable with respect to the
    scene's tensors. chunk: rays per band, each band's samples summed
    before the next band starts (one band when None); use_remat, bvh and
    vis_grads as ``render_pixels``'."""
    if bvh is not None:
        from computeraytracer_tpu_torch.bvh import builder
        bvh = builder.to_device(bvh, scene.device)
    if px is None:
        px, py = tile_coords(width, height, 0, scene.device)
    bands = []
    for bpx, bpy in pixel_bands(px, py, chunk):
        accum = torch.zeros((bpx.shape[0], 3), dtype=torch.float32,
                            device=scene.device)
        for s in range(int(first), int(first) + spp):
            accum = accum + render_pixels(scene, width, height, bpx, bpy, s,
                                          max_depth, rr_start, use_remat,
                                          bvh=bvh, vis_grads=vis_grads)
        bands.append(accum)
    return bands[0] if len(bands) == 1 else torch.cat(bands)


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, bvh=None):
    """Sum of samples first_sample .. first_sample+spp-1 -> XYZ (H, W, 3),
    accumulated in sample order."""
    return accumulate_pixels(scene, width, height, None, None, first_sample,
                             spp, max_depth, rr_start,
                             bvh=bvh).reshape(height, width, 3)
