"""The reference path tracer: plain torch, vectorized over rays, one
Python loop step per bounce.

The estimator of the reference renderer: next-event estimation with the
power heuristic, cosine-hemisphere diffuse bounces, Fresnel glass with
beta * eta^2 radiance scaling and Beer-Lambert attenuation through the
last spectrum, and Russian roulette on max(beta * eta_scale) past
rr_start. Sampling decisions are integer RNG state, so gradients by the
scene's tensors treat them as fixed.

The closest hit is a scan over every primitive, done without a graph
over the rays that need one (a long triangle run through boxes of
consecutive triangles, which finds what the linear scan finds); the
winner's distance is then recomputed for the graph alone. ``counts`` (a dict) collects the casts
the trace makes: ``closest``, the rays alive at each bounce, and
``shadow``, the next-event rays after a diffuse scatter.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import ops
from bench_h100.reference.ops import dot, maximum, take

ETA1, ETA2 = 1.0, 1.5
# elements of one (rays x primitives) block of the closest-hit scan
SCAN_BLOCK = {"cuda": 1 << 25, "cpu": 1 << 21}
# a triangle run this long is scanned through boxes of CLUSTER
# consecutive triangles (a generated mesh keeps them close together)
CLUSTERED_MIN = 4096
CLUSTER = 256


class Hit:
    def __init__(self, hit, index, position, normal, emission, reflectance,
                 material):
        self.hit, self.index, self.position = hit, index, position
        self.normal, self.emission = normal, emission
        self.reflectance, self.material = reflectance, material


def _run_scan(cat, o, d, exclude, d1, d2, d3, idx, block):
    """Each ray's winner (row in the run) and distance over every
    primitive of one run: the last row wins exact ties."""
    n = d1.shape[0]
    w_all, t_all = [], []
    rows = max(1, block // n)
    for r0 in range(0, o.shape[0], rows):
        r1 = min(o.shape[0], r0 + rows)
        t, ok = ops.candidates(cat, o[r0:r1, None], d[r0:r1, None],
                               d1, d2, d3)
        t = torch.where(ok & (idx != exclude[r0:r1, None]), t, ops.INF)
        w = (n - 1) - torch.argmin(t.flip(-1), dim=-1)
        w_all.append(w)
        t_all.append(torch.gather(t, -1, w[:, None])[:, 0])
    return torch.cat(w_all), torch.cat(t_all)


def _cluster_scan(o, d, exclude, d1, d2, d3, idx, block):
    """_run_scan of a long triangle run, testing only the clusters of
    CLUSTER consecutive triangles whose box (padded) the ray's line
    meets. No cluster is passed over by distance, so ties resolve as in
    the linear scan: the least distance, then the last row."""
    n, dev = d1.shape[0], o.device
    k = -(-n // CLUSTER)

    def per_cluster(v, reduce):
        v = torch.cat([v, v[-1:].expand(k * CLUSTER - n, 3)])
        return reduce(v.reshape(k, CLUSTER, 3), 1)

    lo = per_cluster(torch.minimum(torch.minimum(d1, d2), d3), torch.amin)
    hi = per_cluster(torch.maximum(torch.maximum(d1, d2), d3), torch.amax)
    margin = 1e-3 * (1.0 + float((hi - lo).abs().max()))
    lo, hi = lo - margin, hi + margin
    safe_d = torch.where(d == 0.0, 1e-30, d)
    pairs = []
    rows = max(1, block // (3 * k))
    for r0 in range(0, o.shape[0], rows):
        t0 = (lo[None] - o[r0:r0 + rows, None]) / safe_d[r0:r0 + rows, None]
        t1 = (hi[None] - o[r0:r0 + rows, None]) / safe_d[r0:r0 + rows, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        r, c = torch.nonzero((far >= near) & (far >= 0.0), as_tuple=True)
        pairs.append((r + r0, c))
    pr = torch.cat([r for r, _ in pairs])
    pc = torch.cat([c for _, c in pairs])
    lanes = torch.arange(CLUSTER, device=dev)
    pair_t, pair_w = [], []
    step = max(1, block // CLUSTER)
    for p0 in range(0, pr.numel(), step):
        r, c = pr[p0:p0 + step], pc[p0:p0 + step]
        slot = c[:, None] * CLUSTER + lanes
        tri = slot.clamp(max=n - 1)
        t, ok = ops.candidates(ops.CAT_TRIANGLE, o[r][:, None], d[r][:, None],
                               d1[tri], d2[tri], d3[tri])
        ok = ok & (slot < n) & (idx[tri] != exclude[r][:, None])
        t = torch.where(ok, t, ops.INF)
        w = (CLUSTER - 1) - torch.argmin(t.flip(-1), dim=-1)
        pair_t.append(torch.gather(t, -1, w[:, None])[:, 0])
        pair_w.append(tri.gather(-1, w[:, None])[:, 0])
    best_t = torch.full((o.shape[0],), ops.INF, dtype=o.dtype, device=dev)
    winner = torch.full((o.shape[0],), n - 1, dtype=torch.int64, device=dev)
    if pair_t:
        pt, pw = torch.cat(pair_t), torch.cat(pair_w)
        best_t = best_t.scatter_reduce(0, pr, pt, "amin")
        tied = torch.where((pt == best_t[pr]) & torch.isfinite(pt), pw, -1)
        last = torch.full_like(winner, -1).scatter_reduce(0, pr, tied, "amax")
        winner = torch.where(last >= 0, last, winner)
    return winner, best_t


def _search(prims, o, d, exclude, clustered_min=None):
    """Winner row and distance of rays o, d (R, 3), no graph: the last
    primitive wins exact ties (the reference's in-order scan). Triangle
    runs of clustered_min or more rows (CLUSTERED_MIN by default) are
    scanned cluster by cluster, with the same result."""
    R = o.shape[0]
    best_t = torch.full((R,), ops.INF, dtype=o.dtype, device=o.device)
    best = torch.zeros((R,), dtype=torch.int64, device=o.device)
    if R == 0:
        return best, best_t
    block = SCAN_BLOCK["cuda" if o.is_cuda else "cpu"]
    clustered_min = CLUSTERED_MIN if clustered_min is None else clustered_min
    for cat, a, b in prims.runs:
        args = (o, d, exclude, prims.data1[a:b], prims.data2[a:b],
                prims.data3[a:b], prims.index[a:b], block)
        if cat == ops.CAT_TRIANGLE and b - a >= clustered_min:
            w, tw = _cluster_scan(*args)
        else:
            w, tw = _run_scan(cat, *args)
        # a later row wins a tie with the best so far
        take_new = tw <= best_t
        best_t = torch.where(take_new, tw, best_t)
        best = torch.where(take_new, w + a, best)
    return best, best_t


def _winner_t(prims, winner, o, d):
    """The winners' distances, recomputed with the scene's graph."""
    cat = take(prims.category, winner)
    d1, d2, d3 = (take(prims.data1, winner), take(prims.data2, winner),
                  take(prims.data3, winner))
    t = torch.zeros_like(o[..., 0])
    for c in {c for c, _, _ in prims.runs}:
        tc, _ = ops.candidates(c, o, d, d1, d2, d3)
        t = torch.where(cat == c, tc, t)
    return t


def closest_hit(scene, o, d, exclude, need, counts=None, key=None):
    """Closest hit of the rays where ``need``; the others miss."""
    prims = scene.prims
    rows = torch.nonzero(need).reshape(-1)
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(rows.numel())
    winner = torch.zeros_like(exclude)
    t_hit = torch.full_like(o[..., 0], ops.INF)
    with torch.no_grad():
        w, t = _search(prims, o.detach()[rows], d.detach()[rows],
                       exclude[rows])
        winner[rows] = w
        t_hit[rows] = t
    hit = torch.isfinite(t_hit)
    if torch.is_grad_enabled() and (o.requires_grad or d.requires_grad
                                    or prims.data1.requires_grad):
        t_hit = _winner_t(prims, winner, o, d)
    t_safe = torch.where(hit, t_hit, 0.0)
    position = o + t_safe[..., None] * d
    return Hit(hit=hit,
               index=torch.where(hit, take(prims.index, winner), ops.NO_INDEX),
               position=position,
               normal=ops.shading_normal(prims, winner, d, position),
               emission=take(prims.emission, winner),
               reflectance=take(prims.reflectance, winner),
               material=take(prims.material, winner))


def _nee(scene, hit, brdf, lambdas, beta, is_diffuse, u_l, u_p, v_p,
         counts):
    prims = scene.prims
    n_lights = scene.light_prims.shape[0]
    li = (u_l * float(n_lights)).to(torch.int64).clamp(0, n_lights - 1)
    l_prim = take(scene.light_prims, li)
    l_origin = take(prims.data1, l_prim)
    l_edge1 = take(prims.data2, l_prim)
    l_edge2 = take(prims.data3, l_prim)
    p_on_light = (l_origin + u_p[..., None] * l_edge1
                  + v_p[..., None] * l_edge2)
    ldir = ops.safe_normalize(p_on_light - hit.position)
    shadow = closest_hit(scene, hit.position, ldir, hit.index, is_diffuse,
                         counts, "shadow")
    unoccluded = shadow.hit & (shadow.index == l_prim)
    cos_theta = maximum(dot(hit.normal, ldir), 0.0)
    le = ops.sample_spectrum(scene.spectra, take(scene.light_emission, li),
                             lambdas) * cos_theta[..., None]
    pdf_l = ops.light_solid_angle_pdf(l_edge1, l_edge2, n_lights,
                                      shadow.normal, ldir, shadow.position,
                                      hit.position)
    weight_l = ops.power_heuristic(pdf_l, cos_theta / math.pi)
    contrib = le * (weight_l / maximum(pdf_l, 1e-12))[..., None]
    lit = (is_diffuse & unoccluded)[..., None]
    return torch.where(lit, brdf * contrib * beta, 0.0)


def _bounce(scene, lambdas, depth, max_depth, rr_start, counts, seed, o, d,
            radiance, beta, last_pdf, eta_scale, exclude, specular,
            in_trans, active):
    prims = scene.prims
    dtype = scene.dtype
    hit = closest_hit(scene, o, d, exclude, active, counts, "closest")
    lane_hit = active & hit.hit
    active = lane_hit
    exclude = torch.where(lane_hit, hit.index, exclude)

    is_light = lane_hit & (hit.material == ops.LIGHT)
    le = ops.sample_spectrum(scene.spectra, hit.emission, lambdas)
    pdf_l_hit = ops.light_solid_angle_pdf(
        take(prims.data2, hit.index), take(prims.data3, hit.index),
        scene.light_prims.shape[0], hit.normal, d, hit.position, o)
    weight_b = ops.power_heuristic(last_pdf, pdf_l_hit)
    mis_w = torch.where(specular | (depth == 0), 1.0, weight_b)
    radiance = radiance + torch.where(is_light[..., None],
                                      beta * le * mis_w[..., None], 0.0)
    active = active & ~is_light
    scatter = active & (depth < max_depth)
    active = active & scatter

    delta = hit.position - o
    dist = ops.safe_sqrt(dot(delta, delta))
    atten = torch.exp(-take(scene.spectra[-1], lambdas) * dist[..., None])
    beta = torch.where((scatter & in_trans)[..., None], beta * atten, beta)

    is_diffuse = scatter & (hit.material == ops.DIFFUSE)
    is_glass = scatter & (hit.material == ops.GLASS)
    is_mirror = scatter & (hit.material == ops.MIRROR)

    draws = []
    for _ in range(5):
        u, seed = ops.rand_masked(seed, is_diffuse, dtype)
        draws.append(u)
    u_l, u_p, v_p, u_h, v_h = draws
    brdf = ops.sample_spectrum(scene.spectra, hit.reflectance,
                               lambdas) / math.pi
    radiance = radiance + _nee(scene, hit, brdf, lambdas, beta, is_diffuse,
                               u_l, u_p, v_p, counts)
    bounce_dir, bounce_pdf = ops.cosine_hemisphere(hit.normal, u_h, v_h)
    cos_b = dot(hit.normal, bounce_dir).abs()
    beta_diffuse = beta * brdf * (cos_b
                                  / maximum(bounce_pdf, 1e-12))[..., None]

    u_g, seed = ops.rand_masked(seed, is_glass, dtype)
    cos_in = dot(hit.normal, d)
    refl = ops.fresnel_s(d, hit.normal, ETA1, ETA2)
    eta = torch.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    n_glass = torch.where((cos_in > 0.0)[..., None], -hit.normal, hit.normal)
    choose_reflect = u_g < refl / maximum(refl + (1.0 - refl), 1e-12)
    glass_dir = torch.where(
        choose_reflect[..., None], ops.reflect(d, n_glass),
        ops.safe_normalize(ops.refract(d, n_glass, eta)))
    beta_glass = torch.where(choose_reflect[..., None], beta,
                             beta * (eta * eta)[..., None])
    eta_scale_glass = torch.where(choose_reflect, eta_scale,
                                  eta_scale / (eta * eta))
    in_trans_glass = torch.where(choose_reflect, in_trans, ~in_trans)
    mirror_dir = ops.reflect(d, hit.normal)

    new_o = torch.where(scatter[..., None], hit.position, o)
    new_d = torch.where(
        is_diffuse[..., None], bounce_dir,
        torch.where(is_glass[..., None], glass_dir,
                    torch.where(is_mirror[..., None], mirror_dir, d)))
    beta = torch.where(is_diffuse[..., None], beta_diffuse,
                       torch.where(is_glass[..., None], beta_glass, beta))
    last_pdf = torch.where(is_diffuse, bounce_pdf, last_pdf)
    specular = (~is_diffuse) & ((is_glass | is_mirror) | specular)
    exclude = torch.where(is_glass | is_mirror, ops.NO_INDEX, exclude)
    eta_scale = torch.where(is_glass, eta_scale_glass, eta_scale)
    in_trans = torch.where(is_glass, in_trans_glass, in_trans)

    max_c = torch.amax((beta * eta_scale[..., None])[..., :3], dim=-1)
    rr = active & (depth > rr_start) & (max_c < 1.0)
    u_r, seed = ops.rand_masked(seed, rr, dtype)
    q = maximum(1.0 - max_c, 0.0)
    killed = rr & (u_r < q)
    active = active & ~killed
    beta = torch.where((rr & ~killed)[..., None],
                       beta / maximum(1.0 - q, 1e-12)[..., None], beta)
    return (seed, new_o, new_d, radiance, beta, last_pdf, eta_scale,
            exclude, specular, in_trans, active)


def render_pixels(scene, width, height, px, py, sample, max_depth,
                  rr_start, counts=None):
    """One sample (1-based index) of pixels px, py (R,) -> XYZ (R, 3),
    with the scene's graph when grad is on (each bounce recomputed in the
    backward)."""
    dtype, dev = scene.dtype, px.device
    seed = ops.seed_pixel(px, py, sample)
    o, d, seed = ops.camera_rays(scene.camera, width, height, px, py,
                                 sample, seed)
    lambdas, seed = ops.sample_wavelengths(seed, dtype)
    R = px.shape[0]

    def f(shape, fill):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    state = (seed, o, d, f((R, 4), 0.0), f((R, 4), 1.0), f((R,), 1.0),
             f((R,), 1.0), torch.full((R,), ops.NO_INDEX, device=dev),
             torch.zeros(R, dtype=torch.bool, device=dev),
             torch.zeros(R, dtype=torch.bool, device=dev),
             torch.ones(R, dtype=torch.bool, device=dev))

    def body(depth, *carry):
        return _bounce(scene, lambdas, depth, max_depth, rr_start, counts,
                       *carry)

    remat = torch.is_grad_enabled() and counts is None
    for depth in range(int(max_depth) + 1):
        if not bool(state[-1].any()):
            break
        if remat:
            state = checkpoint(body, depth, *state, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = body(depth, *state)
    return ops.spectral_to_xyz(scene.cie, state[3], lambdas)


def film_pixels(width, height, device):
    """Every pixel of the film in row-major order -> (px, py)."""
    ys = torch.arange(height, device=device)
    xs = torch.arange(width, device=device)
    return (xs[None, :].expand(height, width).reshape(-1),
            ys[:, None].expand(height, width).reshape(-1))


def accumulate(scene, width, height, px, py, first_sample, spp, max_depth,
               rr_start, counts=None):
    """Sum over samples first_sample .. first_sample + spp - 1 of the
    pixels px, py -> XYZ (R, 3), in sample order."""
    acc = None
    for s in range(int(first_sample), int(first_sample) + int(spp)):
        x = render_pixels(scene, width, height, px, py, s, max_depth,
                          rr_start, counts)
        acc = x if acc is None else acc + x
    return acc
