"""Warped-area reparameterization: visibility and silhouette gradients
(port of computeraytracer_tpu/ops/warp.py, whose header gives the
method and its measured accuracy).

The estimator is discontinuous in its sampling domains: which primitive
a primary ray hits (screen space), whether a shadow ray reaches the
light (light-area space) and what a BSDF bounce ray hits (hemisphere
space) all flip as geometry moves. Interior autograd (detached sampling)
misses the motion of those boundaries. Each 2D domain u gets a warp

    T(u) = u + V(u; theta),   V = F(u; theta) - F(u; theta).detach(),

where F is a smoothed centroid field built from K auxiliary rays on a
fixed ring around the sample. V is exactly zero (x - x.detach() == 0.0
in f32), so the image is bit-identical with the warp on; under autograd
dV/dtheta is the local velocity of the visible geometry. Each warped
sample's contribution is multiplied by

    detJ = 1 + (div_u F - (div_u F).detach()),

exactly 1 too, whose theta-derivative is the divergence of the velocity
field. div_u F comes from two forward-mode derivatives along the domain
axes (``torch.autograd.forward_ad``); their tangents are ordinary
tensors of the reverse graph, so an outer ``backward()`` differentiates
them.

Two details carry the method:

1. Material velocity: an auxiliary hit is re-expressed in its
   primitive's own local coordinates (patch (u, v), triangle
   barycentrics, sphere unit normal), detached, and rebuilt from the
   primitive's attached frame (``material_point``). The hit of a fixed
   ray always lies on that ray and would carry no velocity.
2. Detached auxiliary intersections: the closest hits of the auxiliary
   rays (``_aux_hits``) run under ``torch.no_grad()``. Each auxiliary
   sample is ``u.detach() + offset``, a constant both for theta and for
   the forward-mode tangent, so nothing is lost, and autograd keeps no
   (rays x K x primitives) candidate tensors.

Ties: ``jnp.clip`` is ``maximum`` then ``minimum``, which split the
gradient and the tangent of a tie in half; every clip here is built
from ``torch.maximum`` / ``torch.minimum`` so that both match the JAX
package there (``torch.clamp`` would not split).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops.intersect import (cross, dot, maximum,
                                                      take)

_BIG = 1e8
# Rays per chunk of the auxiliary closest-hit scans (each scan holds a few
# (chunk, primitives) candidate tensors at once).
AUX_CHUNK = 1 << 18


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) for tensor or constant bounds, ties split."""
    lo = x.new_full((), lo) if not torch.is_tensor(lo) else lo
    hi = x.new_full((), hi) if not torch.is_tensor(hi) else hi
    return torch.minimum(torch.maximum(x, lo), hi)


def _ring_offsets_np(k: int):
    """(K, 2) fixed offsets on ONE unit circle: constants, so the
    auxiliary rays consume no RNG draw. With the kernel bandwidth equal
    to the ring radius the field reproduces linear velocity fields with
    unit gain, which makes the divergence estimate exact on smooth
    regions."""
    a = 2 * np.pi * np.arange(k) / k
    return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)


def ring_offsets(k: int = 8, device=None):
    return torch.from_numpy(_ring_offsets_np(k)).to(device)


def _aux_hits(o, d, exclude, prims):
    """Closest hits of the auxiliary rays o, d (..., K, 3) with
    exclude broadcastable to (..., K), under no_grad, in chunks of
    AUX_CHUNK leading rays -> (hit, t, index, position)."""
    lead = d.shape[:-2]
    k = d.shape[-2]
    n = int(np.prod(lead)) if lead else 1
    o = o.expand(d.shape).reshape(n, k, 3)
    d = d.reshape(n, k, 3)
    exclude = exclude.expand(lead + (k,)).reshape(n, k)
    parts = []
    with torch.no_grad():
        for i in range(0, n, AUX_CHUNK):
            h = isect.intersect_brute(o[i:i + AUX_CHUNK], d[i:i + AUX_CHUNK],
                                      exclude[i:i + AUX_CHUNK], prims)
            parts.append((h.hit, h.t, h.index, h.position))
    hit, t, index, position = (torch.cat(p) for p in zip(*parts))
    return (hit.reshape(lead + (k,)), t.reshape(lead + (k,)),
            index.reshape(lead + (k,)), position.reshape(lead + (k, 3)))


def material_point(prims, idx, p):
    """Hit point p of primitive row idx re-expressed in the primitive's
    own local coordinates (detached), with the primitive's geometry
    attached: equal to p up to recompute rounding (which the warp never
    exposes), but its theta-derivative is the surface material velocity
    instead of the slide of the intersection along the ray."""
    d1 = take(prims.data1, idx)
    d2 = take(prims.data2, idx)
    d3 = take(prims.data3, idx)
    d1s, d2s, d3s = d1.detach(), d2.detach(), d3.detach()
    m = p.detach() - d1s

    # patch: p = d1 + u*d2 + v*d3 (data2/3 are edges)
    u_l = dot(m, d2s) / maximum(dot(d2s, d2s), 1e-12)
    v_l = dot(m, d3s) / maximum(dot(d3s, d3s), 1e-12)
    p_patch = d1 + u_l[..., None] * d2 + v_l[..., None] * d3

    # triangle: data1/2/3 are vertices; barycentrics from the edge Gram
    e1s, e2s = d2s - d1s, d3s - d1s
    a11 = dot(e1s, e1s)
    a12 = dot(e1s, e2s)
    a22 = dot(e2s, e2s)
    det = maximum(a11 * a22 - a12 * a12, 1e-12)
    r1 = dot(m, e1s)
    r2 = dot(m, e2s)
    b1 = (a22 * r1 - a12 * r2) / det
    b2 = (a11 * r2 - a12 * r1) / det
    p_tri = d1 + b1[..., None] * (d2 - d1) + b2[..., None] * (d3 - d1)

    # sphere: center data1, radius data2[0]; unit normal detached
    n_hat = isect.safe_normalize(m)
    p_sph = d1 + n_hat * d2[..., 0:1]

    cat = take(prims.category, idx)
    return torch.where((cat == isect.CAT_SPHERE)[..., None], p_sph,
                       torch.where((cat == isect.CAT_TRIANGLE)[..., None],
                                   p_tri, p_patch))


def _edge_taper(uv, margins):
    """Per-axis envelope (..., 2): 1 inside the domain, 0 on the [0, 1]
    borders. env[..., ax] damps only V_ax near the ax-borders, where it
    is the border-normal component: that zeroes the spurious flux at the
    fixed domain border and keeps the flux of a silhouette that crosses
    it. margins: per-axis taper width, or None for a periodic axis."""
    envs = []
    for ax, m in enumerate(margins):
        if m is None:
            envs.append(torch.ones_like(uv[..., ax]))
            continue
        x = _clip(torch.minimum(uv[..., ax], 1.0 - uv[..., ax]) / m,
                  0.0, 1.0)
        envs.append(x * x * (3.0 - 2.0 * x))
    return torch.stack(envs, dim=-1)


def _jvp(field, uv, tangent):
    """(field(uv), d field(uv) . tangent), both attached to the reverse
    graph of whatever field closes over."""
    with fwAD.dual_level():
        out = fwAD.unpack_dual(field(fwAD.make_dual(uv, tangent)))
        return out.primal, out.tangent


def _reparam(field, uv, margins=None):
    """(uv_warped, detj) for a centroid field (..., 2) -> (..., 2).

    uv_warped == uv and detj == 1 exactly; their theta-derivatives are
    the velocity and the velocity divergence of the (border-tapered)
    field. The derivatives along the two domain axes are taken in one
    forward-mode pass over uv stacked twice (field broadcasts over the
    new leading axis): element by element the JAX package's two jvps."""
    if margins is not None:
        raw = field

        def field(q):
            return q + _edge_taper(q, margins) * (raw(q) - q)
    axes = torch.zeros((2,) + uv.shape, dtype=uv.dtype, device=uv.device)
    axes[0, ..., 0] = 1.0
    axes[1, ..., 1] = 1.0
    f2, df = _jvp(field, torch.stack([uv, uv]), axes)
    f = f2[0]
    v = f - f.detach()
    div = df[0, ..., 0] + df[1, ..., 1]
    detj = 1.0 + (div - div.detach())
    return uv + v, detj


def _make_field(a_k, s_k, z_k, idx_k, bandwidth, beta):
    """Bump-modulated velocity field from FIXED auxiliary samples
    (the JAX package's ``_make_field`` documents its derivation).

    a_k: (..., K, 2) auxiliary domain positions (constants); s_k:
    (..., K, 2) their target points (theta-attached: the material
    velocity); z_k: (..., K) detached depths (misses carry _BIG); idx_k:
    (..., K) hit primitive ids (misses -1). F(u') = u' + G(u') (C(u') -
    u') with C the nearest-surface-preferring centroid and G = 4 p (1-p)
    a bump on the analytic straight-edge coverage p of the foreground
    (the rays that hit the nearest auxiliary hit's primitive); rings
    that are all foreground or all background carry exactly zero
    velocity."""
    z_min = torch.amin(z_k, dim=-1, keepdim=True)
    pref = torch.exp(-beta * (z_k - z_min) / maximum(z_min, 1e-6))
    near = torch.argmin(z_k, dim=-1)
    idx_near = torch.gather(idx_k, -1, near[..., None])
    fg = (idx_k == idx_near).to(torch.float32)

    center = torch.mean(a_k, dim=-2)                     # == uv.detach()
    offs = a_k - center[..., None, :]
    R = float(bandwidth)
    p_bar = torch.mean(fg, dim=-1)
    # outward (toward-background) edge normal from the classification
    nvec = -torch.sum(offs * (fg - p_bar[..., None])[..., None], dim=-2)
    nlen = cam_ops.sqrt(maximum(nvec[..., 0] * nvec[..., 0]
                                + nvec[..., 1] * nvec[..., 1], 1e-20))
    n_hat = nvec / maximum(nlen[..., None], 1e-10)
    delta = -R * torch.cos(math.pi * p_bar)
    eps = 1e-3
    # uniform rings (p_bar exactly 0 or 1) are smooth-region samples and
    # carry exactly zero velocity; the arccos clip bounds mixed rings
    mixed = ((p_bar > 0.0) & (p_bar < 1.0)).to(torch.float32)

    def field(uv):
        # analytic coverage: all u'-dependence through the profile
        rel = uv - center
        h = (delta - (rel[..., 0] * n_hat[..., 0]
                      + rel[..., 1] * n_hat[..., 1])) / R
        p = 1.0 - torch.arccos(_clip(h, eps - 1.0, 1.0 - eps)) / math.pi
        g = mixed * 4.0 * p * (1.0 - p)
        diff = uv[..., None, :] - a_k
        d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2
        b = torch.exp(-d2 / (bandwidth * bandwidth))
        w = b * pref
        w_sum = maximum(torch.sum(w, dim=-1, keepdim=True), 1e-12)
        c = torch.sum(w[..., None] * s_k, dim=-2) / w_sum
        return uv + g[..., None] * (c - uv)

    return field


def screen_warp(scene, width, height, s, t, k: int = 8,
                radius_px: float = 1.5, beta: float = 8.0):
    """Warp film coordinates so primary silhouettes move with geometry.

    s, t: (...,) film coordinates of the sample. Returns (s', t', detj)
    with s' == s, t' == t and detj == 1 exactly."""
    cam = scene.camera
    prims = scene.primitives
    dev = s.device
    frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up, cam.fov,
                               width, height)
    scale = torch.tensor([radius_px / width, radius_px / height],
                         dtype=torch.float32, device=dev)
    offs = ring_offsets(k, dev) * scale
    clip_s = 4.0 * radius_px / width
    clip_t = 4.0 * radius_px / height

    uv = torch.stack([s, t], dim=-1)
    a_k = uv.detach()[..., None, :] + offs               # (..., K, 2)
    sk, tk = a_k[..., 0], a_k[..., 1]
    with torch.no_grad():
        o, d = cam_ops.film_ray(cam.eye, *frame, sk, tk)
    ex = torch.full(sk.shape, isect.NO_INDEX, dtype=torch.int64, device=dev)
    hit, hit_t, hit_idx, hit_pos = _aux_hits(o, d, ex, prims)
    p_mat = material_point(prims, hit_idx, hit_pos)
    ps, pt = cam_ops.world_to_film(cam.eye, cam.lookat, cam.up, cam.fov,
                                   width, height, p_mat)
    # silhouette velocities are local: bound the projection near the
    # auxiliary film point (which it equals)
    ps = _clip(ps, sk - clip_s, sk + clip_s)
    pt = _clip(pt, tk - clip_t, tk + clip_t)
    proj = torch.stack([ps, pt], dim=-1)
    s_k = torch.where(hit[..., None], proj, a_k)
    z_k = torch.where(hit, hit_t, _BIG)
    idx_k = torch.where(hit, hit_idx, isect.NO_INDEX)

    # anisotropic domain (s and t pixels differ): the kernel works in
    # pixel units so that its bandwidth is circular in pixels
    pix = torch.tensor([float(width), float(height)], dtype=torch.float32,
                       device=dev)
    field_px = _make_field(a_k * pix, s_k * pix, z_k, idx_k,
                           bandwidth=radius_px, beta=beta)

    def field(q):
        return field_px(q * pix) / pix

    uv_w, detj = _reparam(field, uv, margins=(3.0 / width, 3.0 / height))
    return uv_w[..., 0], uv_w[..., 1], detj


def light_warp(scene, shade_pos, exclude, l_origin, l_e1, l_e2, l_prim,
               u, v, active, k: int = 8, radius: float = 0.15,
               beta: float = 8.0):
    """Warp the light-area sample (u, v) so blocker silhouettes
    (projected from the shade point onto the light plane) move with the
    blockers. Returns (u', v', detj), exactly (u, v, 1)."""
    prims = scene.primitives
    offs = ring_offsets(k, u.device) * radius
    x = shade_pos[..., None, :]
    xs = x.detach()
    o_l = l_origin[..., None, :]
    e1 = l_e1[..., None, :]
    e2 = l_e2[..., None, :]
    n_l = cross(l_e1, l_e2)[..., None, :]

    uv = torch.stack([torch.where(active, u, 0.5),
                      torch.where(active, v, 0.5)], dim=-1)
    a_k = uv.detach()[..., None, :] + offs               # (..., K, 2)
    uk, vk = a_k[..., 0], a_k[..., 1]
    with torch.no_grad():
        p = (o_l.detach() + uk[..., None] * e1.detach()
             + vk[..., None] * e2.detach())
        ldir = isect.safe_normalize(p - xs)
    sh_hit, sh_t, sh_idx, sh_pos = _aux_hits(xs, ldir, exclude[..., None],
                                             prims)
    occluded = sh_hit & (sh_idx != l_prim[..., None])
    y_mat = material_point(prims, sh_idx, sh_pos)
    # project the blocker's material point back onto the (moving) light
    # plane through the (moving) shade point
    dirw = torch.where(occluded[..., None], y_mat - x, ldir)
    denom = dot(dirw, n_l)
    denom = torch.where(denom.abs() < 1e-9,
                        torch.where(denom < 0, -1e-9, 1e-9), denom)
    tau = dot(o_l - x, n_l) / denom
    q = x + tau[..., None] * dirw
    m = q - o_l
    qu = dot(m, e1) / maximum(dot(e1, e1), 1e-12)
    qv = dot(m, e2) / maximum(dot(e2, e2), 1e-12)
    qu = _clip(qu, uk - 4 * radius, uk + 4 * radius)
    qv = _clip(qv, vk - 4 * radius, vk + 4 * radius)
    proj = torch.stack([qu, qv], dim=-1)
    s_k = torch.where(occluded[..., None], proj, a_k)
    z_k = torch.where(occluded, sh_t, _BIG)
    idx_k = torch.where(occluded, sh_idx, isect.NO_INDEX)

    field = _make_field(a_k, s_k, z_k, idx_k, bandwidth=radius, beta=beta)
    uv_w, detj = _reparam(field, uv, margins=(0.5 * radius, 0.5 * radius))
    detj = torch.where(active, detj, 1.0)
    u_w = torch.where(active, uv_w[..., 0], u)
    v_w = torch.where(active, uv_w[..., 1], v)
    return u_w, v_w, detj


def hemisphere_warp(scene, shade_pos, normal, exclude, u, v, active,
                    k: int = 8, radius: float = 0.12, beta: float = 8.0):
    """Warp the cosine-hemisphere sample (u, v) so secondary-hit
    silhouettes (the emitter's own edges among them, the MIS complement
    of NEE) move with the geometry. Returns (u', v', detj)."""
    prims = scene.primitives
    offs = ring_offsets(k, u.device) * radius
    x = shade_pos[..., None, :]
    xs = x.detach()
    n = normal[..., None, :]

    # the tangent frame exactly as sampling.cosine_hemisphere builds it
    z_minor = normal[..., 2].abs() < 0.999
    up = torch.where(z_minor[..., None], normal.new_tensor([0.0, 0.0, 1.0]),
                     normal.new_tensor([1.0, 0.0, 0.0]))
    tangent = isect.safe_normalize(cross(up, normal))[..., None, :]
    bitangent = cross(normal, tangent[..., 0, :])[..., None, :]

    uv = torch.stack([torch.where(active, u, 0.5),
                      torch.where(active, v, 0.5)], dim=-1)
    a_k = uv.detach()[..., None, :] + offs               # (..., K, 2)
    uk = _clip(a_k[..., 0], 1e-4, 1.0 - 1e-4)
    vk = a_k[..., 1]
    with torch.no_grad():
        r = cam_ops.sqrt(uk)
        th = 2.0 * math.pi * vk
        d = (tangent * (r * torch.cos(th))[..., None]
             + bitangent * (r * torch.sin(th))[..., None]
             + n * cam_ops.sqrt(1.0 - uk)[..., None])
    hit, hit_t, hit_idx, hit_pos = _aux_hits(xs, d, exclude[..., None],
                                             prims)
    y_mat = material_point(prims, hit_idx, hit_pos)
    dirh = torch.where(hit[..., None], isect.safe_normalize(y_mat - x), d)
    xl = dot(dirh, tangent)
    yl = dot(dirh, bitangent)
    u_p = xl * xl + yl * yl
    xg = torch.where(u_p < 1e-10, 1.0, xl)
    v_p = torch.atan2(yl, xg) / (2.0 * math.pi)
    # re-center onto the sample's branch of the angular coordinate
    v_p = v_p + torch.round(vk - v_p).detach()
    u_p = _clip(u_p, uk - 4 * radius, uk + 4 * radius)
    v_p = _clip(v_p, vk - 4 * radius, vk + 4 * radius)
    proj = torch.stack([u_p, v_p], dim=-1)
    s_k = torch.where(hit[..., None], proj, a_k)
    z_k = torch.where(hit, hit_t, _BIG)
    idx_k = torch.where(hit, hit_idx, isect.NO_INDEX)

    field = _make_field(a_k, s_k, z_k, idx_k, bandwidth=radius, beta=beta)
    # v is periodic (angular): taper only the radial u axis
    uv_w, detj = _reparam(field, uv, margins=(0.5 * radius, None))
    detj = torch.where(active, detj, 1.0)
    u_w = torch.where(active, uv_w[..., 0], u)
    v_w = torch.where(active, uv_w[..., 1], v)
    return u_w, v_w, detj
