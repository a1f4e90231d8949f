"""Plain torch operations of the reference tracer.

A frozen copy of the eager tracer's arithmetic (the port's ``ops/`` and
``tracer/xla.py`` as of the benchmark's first version), rewritten so that
every float tensor takes the dtype of the scene it is given: float32 for
the reference, a lower precision for the control of the comparison. It
imports neither the JAX package nor the port.

- RNG: the TEA seed of (pixel, sample) and the pcg4d stream, u32 words in
  int64 tensors.
- Camera: the pinhole of the reference renderer, its basis rounded as
  fused multiply-adds (so rays match the port's to the last bit).
- Intersection: patches, spheres and watertight triangles, the closest hit
  by a linear scan in which the last primitive wins exact ties.
- Sampling, Fresnel, hero-wavelength spectra, the CIE conversion and the
  sRGB display transform.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LAMBDA_MIN, LAMBDA_MAX = 400.0, 700.0
N_LAMBDA = 301
N_HERO = 4
CIE_OFFSET = 40
CIE_N = 471
CIE_Y_INTEG = 106.856895
GRID_SIZE = 16
DIFFUSE, LIGHT, GLASS, MIRROR = 0, 1, 2, 3
CAT_PATCH, CAT_SPHERE, CAT_TRIANGLE = 0, 1, 2
T_MIN = 0.001
INF = float("inf")
NO_INDEX = -1

# ---------------------------------------------------------------- RNG

MASK = 0xFFFFFFFF
_TEA_DELTA = 0x9E3779B9
_TEA_K = (0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E)
_PCG_A, _PCG_C = 1664525, 1013904223


def _u32(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK


def tea(v0, v1, rounds: int = 16):
    v0, v1 = _u32(v0), _u32(v1)
    s0 = 0
    k0, k1, k2, k3 = _TEA_K
    for _ in range(rounds):
        s0 = (s0 + _TEA_DELTA) & MASK
        v0 = (v0 + ((((v1 << 4) + k0) ^ (v1 + s0) ^ ((v1 >> 5) + k1))
                    & MASK)) & MASK
        v1 = (v1 + ((((v0 << 4) + k2) ^ (v0 + s0) ^ ((v0 >> 5) + k3))
                    & MASK)) & MASK
    return v0


def seed_pixel(px, py, sample):
    """(R, 4) state (y, x*100, sample, tea(x, y*100))."""
    px = _u32(px)
    py = _u32(py, px.device)
    s = _u32(sample, px.device).expand(px.shape)
    return torch.stack([py, (px * 100) & MASK, s, tea(px, (py * 100) & MASK)],
                       dim=-1)


def pcg4d(seed):
    x, y, z, w = seed.unbind(-1)
    x = (x * _PCG_A + _PCG_C) & MASK
    y = (y * _PCG_A + _PCG_C) & MASK
    z = (z * _PCG_A + _PCG_C) & MASK
    w = (w * _PCG_A + _PCG_C) & MASK
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    return torch.stack([x, y, z, w], dim=-1)


def unit_float(bits, dtype):
    """u32 word -> [0, 1) from its low 24 bits, in dtype."""
    return ((bits & 0x00FFFFFF).to(torch.float32)
            * (1.0 / 0x01000000)).to(dtype)


def rand(seed, dtype):
    seed = pcg4d(seed)
    return unit_float(seed[..., 0], dtype), seed


def rand_masked(seed, mask, dtype):
    new = pcg4d(seed)
    u = unit_float(new[..., 0], dtype)
    return torch.where(mask, u, 0.0), torch.where(mask[..., None], new, seed)


# ---------------------------------------------------------------- vectors


def sqrt(x):
    """Correctly rounded square root (the CPU's root taken in float64)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def maximum(x, c):
    return torch.maximum(x, x.new_full((), c))


def minimum(x, c):
    return torch.minimum(x, x.new_full((), c))


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def safe_normalize(v, eps=1e-20):
    s = dot(v, v)
    s = torch.where(s < eps, 1.0, s)
    return v / sqrt(s)[..., None]


def safe_sqrt(x, eps=0.0):
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), eps)


def take(table, idx):
    """table[idx] along the first axis (negative indices wrap)."""
    idx = idx.long()
    flat = torch.where(idx < 0, idx + table.shape[0], idx).reshape(-1)
    return table.index_select(0, flat).reshape(idx.shape + table.shape[1:])


# ---------------------------------------------------------------- camera


def _fma(a, b, c):
    """a * b + c rounded once to a's dtype (exact product in float64, the
    sum rounded to odd, then to the dtype)."""
    p = a.double() * b.double()
    s = p + c.double()
    with torch.no_grad():
        back = s - p
        err = (p - (s - back)) + (c.double() - back)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
        bump = torch.where((err != 0) & even, torch.nextafter(s, toward) - s,
                           torch.zeros_like(s))
    return (s + bump).to(a.dtype)


def _cross_fma(a, b):
    return torch.stack([_fma(a[1], b[2], -(a[2] * b[1])),
                        _fma(a[2], b[0], -(a[0] * b[2])),
                        _fma(a[0], b[1], -(a[1] * b[0]))])


def _normalize_fma(v):
    return v / sqrt(_fma(v[2], v[2], _fma(v[1], v[1], v[0] * v[0])))


def film_frame(cam, width, height):
    w = _normalize_fma(cam.eye - cam.lookat)
    u = _normalize_fma(_cross_fma(cam.up, w))
    v = _cross_fma(w, u)
    f = dict(dtype=cam.fov.dtype, device=cam.fov.device)
    viewport_h = 2.0 * torch.tan(cam.fov / 2.0)
    viewport_w = (torch.full((), float(width), **f)
                  / torch.full((), float(height), **f)) * viewport_h
    horizontal = viewport_w * u
    vertical = viewport_h * v
    lower_left = cam.eye - horizontal / 2.0 - vertical / 2.0 - w
    return lower_left, horizontal, vertical


def camera_rays(cam, width, height, px, py, sample, seed):
    """Stratified jittered primary rays -> (o, d, seed)."""
    lower_left, horizontal, vertical = film_frame(cam, width, height)
    dtype = cam.fov.dtype
    us, seed = rand(seed, dtype)
    ut, seed = rand(seed, dtype)
    stratum = float(int(sample) % GRID_SIZE)
    js = (stratum + us) * (1.0 / GRID_SIZE)
    jt = (stratum + ut) * (1.0 / GRID_SIZE)
    f = dict(dtype=dtype, device=px.device)
    s = (px.to(dtype) + js) / torch.full((), float(width), **f)
    t = (float(height) - py.to(dtype) + jt) / torch.full((), float(height),
                                                        **f)
    d = (lower_left + s[..., None] * horizontal + t[..., None] * vertical
         - cam.eye)
    d = d / sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                 + d[..., 2] * d[..., 2])[..., None]
    return cam.eye.expand(d.shape), d, seed


# ---------------------------------------------------------------- hits


def patch_candidates(o, d, origin, edge1, edge2):
    n = safe_normalize(cross(edge1, edge2))
    ndotd = dot(n, d)
    n = torch.where(ndotd[..., None] > 0, -n, n)
    ndotd = torch.where(ndotd > 0, -ndotd, ndotd)
    grazing = ndotd.abs() < 1e-4
    t = dot(n, origin - o) / torch.where(grazing, 1.0, ndotd)
    p = o + t[..., None] * d
    m = p - origin
    u = dot(m, edge1) / maximum(dot(edge1, edge1), 1e-12)
    v = dot(m, edge2) / maximum(dot(edge2, edge2), 1e-12)
    valid = (~grazing) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return t, valid


def sphere_candidates(o, d, center, radius, t_min=T_MIN, t_max=INF):
    co = o - center
    a = dot(d, d)
    b = 2.0 * dot(d, co)
    c = dot(co, co) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)
    denom = torch.where(a > 1e-12, 2.0 * a, 1.0)
    t_near = (-b - sq) / denom
    t_far = (-b + sq) / denom
    has_root = (disc > 0.0) & (a > 1e-12)
    near_ok = (t_near >= t_min) & (t_near <= t_max)
    t = torch.where(near_ok, t_near, t_far)
    return t, has_root & (t >= t_min) & (t <= t_max)


def _sel3(k, v):
    return torch.where(k == 0, v[0], torch.where(k == 1, v[1], v[2]))


def _comps(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def triangle_candidates(o, d, v0, v1, v2):
    """Watertight test (Woop, Benthin and Wald 2013, both orientations)
    with t from the triangle's plane; v0, v1, v2 are vertices."""
    o3, d3 = _comps(o), _comps(d)
    v0, v1, v2 = _comps(v0), _comps(v1), _comps(v2)
    e1 = (v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2])
    e2 = (v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2])
    n = (e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0])
    inv = 1.0 / sqrt(torch.clamp(n[0] * n[0] + n[1] * n[1] + n[2] * n[2],
                                 min=1e-30))
    n = (n[0] * inv, n[1] * inv, n[2] * inv)
    ndotd = n[0] * d3[0] + n[1] * d3[1] + n[2] * d3[2]
    grazing = torch.where(ndotd > 0.0, -ndotd, ndotd).abs() < 1e-4
    num = (n[0] * (v0[0] - o3[0]) + n[1] * (v0[1] - o3[1])
           + n[2] * (v0[2] - o3[2]))
    t = num / torch.where(grazing, 1.0, ndotd)
    ax, ay, az = d3[0].abs(), d3[1].abs(), d3[2].abs()
    kz = torch.where((ax >= ay) & (ax >= az), 0, torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    dkz = _sel3(kz, d3)
    safe = torch.where(dkz == 0.0, 1.0, dkz)
    sx, sy = _sel3(kx, d3) / safe, _sel3(ky, d3) / safe
    okx, oky, okz = _sel3(kx, o3), _sel3(ky, o3), _sel3(kz, o3)

    def shear(v):
        pz = _sel3(kz, v) - okz
        return (_sel3(kx, v) - okx) - sx * pz, (_sel3(ky, v) - oky) - sy * pz

    ax_, ay_ = shear(v0)
    bx_, by_ = shear(v1)
    cx_, cy_ = shear(v2)
    u = cx_ * by_ - cy_ * bx_
    v = ax_ * cy_ - ay_ * cx_
    w = bx_ * ay_ - by_ * ax_
    inside = ((((u >= 0.0) & (v >= 0.0) & (w >= 0.0))
               | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0)))
              & (u + v + w != 0.0))
    return t, ~grazing & inside


def candidates(cat, o, d, d1, d2, d3):
    """(t, valid) of rays against primitives of one category, range
    applied, exclusion not."""
    if cat == CAT_PATCH:
        t, ok = patch_candidates(o, d, d1, d2, d3)
    elif cat == CAT_SPHERE:
        t, ok = sphere_candidates(o, d, d1, d2[..., 0])
    else:
        t, ok = triangle_candidates(o, d, d1, d2, d3)
    return t, ok & (t >= T_MIN)


def shading_normal(prims, idx, d, position):
    cat = take(prims.category, idx)
    d1, d2, d3 = (take(prims.data1, idx), take(prims.data2, idx),
                  take(prims.data3, idx))
    is_tri = (cat == CAT_TRIANGLE)[..., None]
    n_flat = cross(torch.where(is_tri, d2 - d1, d2),
                   torch.where(is_tri, d3 - d1, d3))
    n = safe_normalize(torch.where((cat == CAT_SPHERE)[..., None],
                                   position - d1, n_flat))
    flip = (dot(n, d) > 0) & (cat != CAT_SPHERE)
    return torch.where(flip[..., None], -n, n)


# ---------------------------------------------------------------- spectra


def resample_spectrum(wavelengths, values):
    """Sparse (wavelength, value) pairs -> the dense 1 nm table over
    400-700 nm: the first wavelength >= lambda, lerped from the one
    before."""
    wl = np.asarray(wavelengths, np.float64)
    vals = np.asarray(values, np.float64)
    out = np.empty(N_LAMBDA, np.float32)
    for i in range(N_LAMBDA):
        lam = LAMBDA_MIN + i
        idx = int(np.searchsorted(wl, lam, side="left"))
        if idx >= len(wl):
            out[i] = vals[-1]
            continue
        a, b = max(idx - 1, 0), min(idx, len(wl) - 1)
        if wl[a] == wl[b]:
            out[i] = vals[a]
        else:
            out[i] = vals[a] + (lam - wl[a]) / (wl[b] - wl[a]) * (vals[b]
                                                                  - vals[a])
    return out


def _lobe(x, mu, s1, s2):
    sigma = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def cie_1931_tables():
    """(3, 471) CIE 1931 colour matching functions at 1 nm from 360 nm
    (the analytic fit of Wyman, Sloan and Shirley 2013)."""
    lam = 360.0 + np.arange(CIE_N, dtype=np.float64)
    x = (1.056 * _lobe(lam, 599.8, 37.9, 31.0)
         + 0.362 * _lobe(lam, 442.0, 16.0, 26.7)
         - 0.065 * _lobe(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _lobe(lam, 568.8, 46.9, 40.5)
         + 0.286 * _lobe(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _lobe(lam, 437.0, 11.8, 36.0)
         + 0.681 * _lobe(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z]).astype(np.float32)


def sample_wavelengths(seed, dtype):
    """Hero index and its companions at +4, +8, +12 nm (mod 301)."""
    u, seed = rand(seed, dtype)
    # u < 1 in float32; a lower precision may round it up to 1
    hero = (u * float(N_LAMBDA)).to(torch.int64).clamp(max=N_LAMBDA - 1)
    lam = torch.stack([hero, (hero + 4) % N_LAMBDA, (hero + 8) % N_LAMBDA,
                       (hero + 12) % N_LAMBDA], dim=-1)
    return lam, seed


def sample_spectrum(spectra, index, lambdas):
    flat = index.long()[..., None] * spectra.shape[1] + lambdas
    return take(spectra.reshape(-1), flat)


_XYZ_SCALE = (LAMBDA_MAX - LAMBDA_MIN) / (CIE_Y_INTEG * N_HERO)


def spectral_to_xyz(cie, radiance, lambdas):
    bars = cie[:, CIE_OFFSET:CIE_OFFSET + N_LAMBDA][:, lambdas]
    xyz = ((bars[..., 0] * radiance[..., 0] + bars[..., 1] * radiance[..., 1])
           + bars[..., 2] * radiance[..., 2]) + bars[..., 3] * radiance[..., 3]
    return torch.movedim(xyz, 0, -1) * _XYZ_SCALE


_XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
               (-0.9692660, 1.8760108, 0.0415560),
               (0.0556434, -0.2040259, 1.0572252))


def xyz_to_srgb(xyz, exposure: float = 2.2):
    """XYZ -> linear sRGB (D65) -> 1 - exp(-rgb * exposure) -> sRGB
    gamma, clipped to [0, 1]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rgb = torch.stack([(x * a + y * b) + z * c for a, b, c in _XYZ_TO_RGB],
                      dim=-1)
    rgb = 1.0 - torch.exp(-rgb * exposure)
    lo = rgb * 12.92
    hi = 1.055 * torch.pow(torch.clamp(rgb, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.clamp(torch.where(rgb < 0.0031308, lo, hi), 0.0, 1.0)


# ---------------------------------------------------------------- sampling


def power_heuristic(f_pdf, g_pdf):
    r = g_pdf / maximum(f_pdf, 1e-12)
    return 1.0 / (1.0 + r * r)


def cosine_hemisphere(normal, u, v):
    r = safe_sqrt(u)
    theta = 2.0 * math.pi * v
    x, y = r * torch.cos(theta), r * torch.sin(theta)
    z = safe_sqrt(1.0 - u)
    up = torch.where((normal[..., 2].abs() < 0.999)[..., None],
                     normal.new_tensor([0.0, 0.0, 1.0]),
                     normal.new_tensor([1.0, 0.0, 0.0]))
    tangent = safe_normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    direction = (tangent * x[..., None] + bitangent * y[..., None]
                 + normal * z[..., None])
    return direction, z / math.pi


def light_solid_angle_pdf(edge1, edge2, n_lights, normal_at_light,
                          ray_direction, light_position, ray_origin):
    area = safe_sqrt(dot(edge1, edge1)) * safe_sqrt(dot(edge2, edge2))
    abs_cos = maximum(dot(normal_at_light, -ray_direction).abs(), 1e-5)
    delta = light_position - ray_origin
    geometric = abs_cos / maximum(dot(delta, delta), 1e-12)
    pdf = (1.0 / maximum(area, 1e-12)) / geometric / float(n_lights)
    return minimum(maximum(pdf, 0.0), 1e16)


# ---------------------------------------------------------------- Fresnel


def fresnel_s(ray_dir, normal, eta1, eta2):
    cosi = minimum(maximum(dot(ray_dir, normal), -1.0), 1.0)
    eta = torch.where(cosi > 0.0, eta2 / eta1, eta1 / eta2)
    sint2 = eta * eta * (1.0 - cosi * cosi)
    cost = safe_sqrt(1.0 - sint2)
    ci = cosi.abs()
    rs = (eta1 * ci - eta2 * cost) / (eta1 * ci + eta2 * cost)
    rp = (eta2 * ci - eta1 * cost) / (eta2 * ci + eta1 * cost)
    return torch.where(sint2 > 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    ndoti = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    out = eta[..., None] * i - (eta * ndoti + safe_sqrt(k))[..., None] * n
    return torch.where((k < 0.0)[..., None], 0.0, out)
