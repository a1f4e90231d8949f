"""Path-tracing megakernels: plain torch versions and CUDA wrappers.

Port of the plain mode (non-mesh, untaped) of
computeraytracer_tpu/kernels/megakernel.py ``build_forward`` and of
``build_backward``. What lives here:

- ``SceneStatic.from_scene`` (non-mesh scenes) and ``pack_prims``: the
  scene structure and the (P, 12) primitive table the kernel reads.
- ``forward_reference``: the plain torch version. It ports
  ``make_bounce`` and the bounce loop of ``build_forward``, vectorised
  over the ray axis of (k, R) planes with ``torch.where`` masks, in the
  JAX package's op order.
- ``forward``: the wrapper with the TPU kernel's contract
  ``prims (P, 12) f32, rays (6, R) f32, seeds (4, R) u32 values,
  spect (S*4, R) f32 -> radiance (4, R) f32``. CPU tensors run
  ``forward_reference``; CUDA tensors launch the hand-written kernel in
  ``csrc/megakernel_fwd.cu``. There is no other route.
- ``backward_reference``: the plain torch backward, autograd of
  ``forward_reference``; ``backward``: its wrapper, with the contract of
  ``build_backward`` (``... , dL (4, R) -> d_prims (P, 12), d_rays
  (6, R), d_spect (S*4, R)``), launching ``csrc/megakernel_bwd.cu`` for
  CUDA tensors.
- ``TraceFn``: the autograd Function whose forward is ``forward`` and
  whose backward is ``backward`` (the analogue of the JAX package's
  ``tracer/pallas.py`` ``_call_with_vjp``).

Seeds are int64 tensors holding u32 values (ops/rng.py); the kernel gets
an int32 tensor with the same bit pattern.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import _build
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.ops.camera import sqrt

T_MIN = 0.001
ETA1, ETA2 = 1.0, 1.5

# Bounds of the CUDA kernel's shared-memory tables (csrc/megakernel_fwd.cu).
MAX_PRIMS = 256
MAX_LIGHTS = 64
MAX_SPECTRA = 1024

# Kernel launches made by ``forward`` and by ``backward`` (CPU calls do
# not count).
launches = 0
launches_bwd = 0


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Non-differentiable scene structure (hashable).

    rows lists the original primitive id of each packed slot; the other
    tuples are aligned with it (categories: 0 patch, 1 sphere, 2 tri).
    """

    rows: tuple
    categories: tuple
    materials: tuple
    emission_idx: tuple
    reflectance_idx: tuple
    light_rows: tuple
    n_spectra: int
    mesh_parts: tuple = ()

    @classmethod
    def from_scene(cls, scene) -> "SceneStatic":
        """Structure of a non-mesh scene: every row is scanned in order."""
        p = scene.primitives
        cat = p.category.tolist()
        return cls(
            rows=tuple(range(len(cat))),
            categories=tuple(int(c) for c in cat),
            materials=tuple(int(m) for m in p.material.tolist()),
            emission_idx=tuple(int(e) for e in p.emission.tolist()),
            reflectance_idx=tuple(int(r) for r in p.reflectance.tolist()),
            light_rows=tuple(int(x) for x in scene.lights.prim_index.tolist()),
            n_spectra=int(scene.spectra.shape[0]),
        )


def pack_prims(scene) -> torch.Tensor:
    """(P, 12) f32: [origin/center, edge1/radius, edge2, pad]; sphere
    rows carry the radius at column 3."""
    p = scene.primitives
    return torch.cat([p.data1, p.data2, p.data3, torch.zeros_like(p.data1)],
                     dim=-1).contiguous()


# ---------------------------------------------------------------------------
# plain torch version: vec3 = 3-tuple of (R,) planes
# ---------------------------------------------------------------------------


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _vscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _vnormalize(a):
    s = _vdot(a, a)
    s = torch.where(s < 1e-20, 1.0, s)
    return _vscale(1.0 / sqrt(s), a)


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _rand_masked(seed, mask):
    new = rng.pcg4d_words(*seed)
    u = torch.where(mask, rng.to_unit_float(new[0]), 0.0)
    return u, tuple(torch.where(mask, n, o) for n, o in zip(new, seed))


def _patch_frame(row):
    """Per-patch constants of the plane test, in the JAX op order."""
    e1 = (row[3], row[4], row[5])
    e2 = (row[6], row[7], row[8])
    n_raw = _vcross(e1, e2)
    n_len2 = n_raw[0] * n_raw[0] + n_raw[1] * n_raw[1] + n_raw[2] * n_raw[2]
    inv_len = 1.0 / sqrt(torch.clamp(n_len2, min=1e-30))
    n0 = (n_raw[0] * inv_len, n_raw[1] * inv_len, n_raw[2] * inv_len)
    inv_e1 = 1.0 / torch.clamp(
        e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2], min=1e-12)
    inv_e2 = 1.0 / torch.clamp(
        e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2], min=1e-12)
    return e1, e2, n0, inv_e1, inv_e2


def _scan_primitives(static, prims, o, d, exclude):
    """In-order closest-hit scan: ``t <= best`` lets the LAST hit win
    ties (the coplanar ceiling light depends on it)."""
    shape = o[0].shape
    dev = o[0].device
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_t = torch.full(shape, math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full(shape, -1, dtype=torch.int64, device=dev)
    pos = (zero, zero, zero)
    nrm = (zero, zero, zero)
    d_dot_d = _vdot(d, d)
    for slot, (i, cat) in enumerate(zip(static.rows, static.categories)):
        row = prims[slot]
        not_excluded = exclude != i
        if cat == 0:
            p0 = (row[0], row[1], row[2])
            e1, e2, n0, inv_e1, inv_e2 = _patch_frame(row)
            ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
            flip = ndotd > 0.0
            ndotd_f = torch.where(flip, -ndotd, ndotd)
            grazing = torch.abs(ndotd_f) < 1e-4
            num = (n0[0] * (p0[0] - o[0]) + n0[1] * (p0[1] - o[1])
                   + n0[2] * (p0[2] - o[2]))
            t = num / torch.where(grazing, 1.0, ndotd)
            p = _vadd(o, _vscale(t, d))
            m = _vsub(p, p0)
            u = _vdot(m, e1) * inv_e1
            v = _vdot(m, e2) * inv_e2
            inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
            valid = (not_excluded & ~grazing & inside
                     & (t >= T_MIN) & (t <= best_t))
            sgn = torch.where(flip, -1.0, 1.0)
            n_eff = (sgn * n0[0], sgn * n0[1], sgn * n0[2])
        elif cat == 1:
            cx = (row[0], row[1], row[2])
            radius = row[3]
            co = _vsub(o, cx)
            a = d_dot_d
            b = 2.0 * _vdot(d, co)
            c2 = _vdot(co, co) - radius * radius
            disc = b * b - 4.0 * a * c2
            has_root = disc > 0.0
            sq = sqrt(torch.where(has_root, disc, 1.0))
            denom = torch.where(a > 1e-12, 2.0 * a, 1.0)
            t_near = (-b - sq) / denom
            t_far = (-b + sq) / denom
            near_ok = (t_near >= T_MIN) & (t_near <= best_t)
            t = torch.where(near_ok, t_near, t_far)
            valid = (not_excluded & has_root & (a > 1e-12)
                     & (t >= T_MIN) & (t <= best_t))
            p = _vadd(o, _vscale(t, d))
            n_eff = _vnormalize(_vsub(p, cx))
        else:
            raise NotImplementedError(
                "triangle rows arrive with the mesh slice of the port")
        best_t = torch.where(valid, t, best_t)
        best_i = torch.where(valid, i, best_i)
        pos = _vwhere(valid, p, pos)
        nrm = _vwhere(valid, n_eff, nrm)
    return {"t": best_t, "idx": best_i, "pos": pos, "nrm": nrm,
            "hit": best_i >= 0}


def _bounce(static, prims, spect, state, depth, max_depth, rr_start):
    """One bounce of make_bounce over all lanes (JAX op order)."""
    S = static.n_spectra
    n_lights = len(static.light_rows)
    lslot = {lr: static.rows.index(lr) for lr in static.light_rows}
    R = spect.shape[1]

    def gets(r):
        return tuple(spect[r * 4 + j] for j in range(4))

    def light_pdf(l_row, n_at_light, ray_dir, l_pos, r_origin):
        row = prims[lslot[l_row]]
        e1 = (row[3], row[4], row[5])
        e2 = (row[6], row[7], row[8])
        area = sqrt(torch.clamp(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2],
                                min=1e-30)) * sqrt(torch.clamp(
            e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2], min=1e-30))
        abs_cos = torch.clamp(torch.abs(-_vdot(n_at_light, ray_dir)),
                              min=1e-5)
        diff = _vsub(l_pos, r_origin)
        dist2 = _vdot(diff, diff)
        geo = abs_cos / torch.clamp(dist2, min=1e-12)
        pdf = (1.0 / torch.clamp(area, min=1e-12)) / geo / float(n_lights)
        return torch.clamp(pdf, 0.0, 1e16)

    def power_heuristic(f, g):
        r = g / torch.clamp(f, min=1e-12)
        return 1.0 / (1.0 + r * r)

    o, d, L, beta, last_pdf, eta_scale = state["diff"]
    seed, exclude, specular, in_trans, active = state["nondiff"]
    dev = o[0].device
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    inv_pi = 1.0 / math.pi

    hit = _scan_primitives(static, prims, o, d, exclude)
    lane_hit = active & hit["hit"]
    active = lane_hit
    exclude = torch.where(lane_hit, hit["idx"], exclude)
    idx = hit["idx"]

    false = torch.zeros((R,), dtype=torch.bool, device=dev)
    mat_light, mat_diffuse, mat_glass, mat_mirror = false, false, false, false
    for i, m in zip(static.rows, static.materials):
        sel = idx == i
        if m == C.LIGHT:
            mat_light = mat_light | sel
        elif m == C.DIFFUSE:
            mat_diffuse = mat_diffuse | sel
        elif m == C.GLASS:
            mat_glass = mat_glass | sel
        elif m == C.MIRROR:
            mat_mirror = mat_mirror | sel

    # ---- emissive hit
    is_light = lane_hit & mat_light
    le = [zero] * 4
    for i, m, ei in zip(static.rows, static.materials, static.emission_idx):
        if m == C.LIGHT:
            sel = idx == i
            emis = gets(ei)
            le = [torch.where(sel, emis[j], le[j]) for j in range(4)]
    pdf_l_hit = zero
    for lr in static.light_rows:
        sel = idx == lr
        pdf_l_hit = torch.where(
            sel, light_pdf(lr, hit["nrm"], d, hit["pos"], o), pdf_l_hit)
    weight_b = power_heuristic(last_pdf, pdf_l_hit)
    if depth == 0:
        mis_w = torch.ones_like(weight_b)
    else:
        mis_w = torch.where(specular, 1.0, weight_b)
    L = tuple(L[j] + torch.where(is_light, beta[j] * le[j] * mis_w, 0.0)
              for j in range(4))
    active = active & ~is_light

    scatter = active & (depth < max_depth)
    active = scatter

    # ---- Beer-Lambert
    ext = gets(S - 1)
    diffp = _vsub(hit["pos"], o)
    dsq = _vdot(diffp, diffp)
    dist = sqrt(torch.where(dsq > 0, dsq, 1.0)) * (dsq > 0)
    bl = scatter & in_trans
    beta = tuple(torch.where(bl, beta[j] * torch.exp(-ext[j] * dist), beta[j])
                 for j in range(4))

    is_diffuse = scatter & mat_diffuse
    is_glass = scatter & mat_glass
    is_mirror = scatter & mat_mirror

    # ---- DIFFUSE: NEE + cosine bounce (5 draws)
    u_l, seed = _rand_masked(seed, is_diffuse)
    u_p, seed = _rand_masked(seed, is_diffuse)
    v_p, seed = _rand_masked(seed, is_diffuse)
    u_h, seed = _rand_masked(seed, is_diffuse)
    v_h, seed = _rand_masked(seed, is_diffuse)

    brdf = [zero] * 4
    for i, m, ri in zip(static.rows, static.materials, static.reflectance_idx):
        if m == C.DIFFUSE:
            sel = idx == i
            refl = gets(ri)
            brdf = [torch.where(sel, refl[j], brdf[j]) for j in range(4)]
    brdf = [b * inv_pi for b in brdf]

    li = torch.clamp((u_l * float(n_lights)).to(torch.int64), 0, n_lights - 1)
    nee = [zero] * 4
    for l_i, lr in enumerate(static.light_rows):
        lsel = is_diffuse & (li == l_i)
        row = prims[lslot[lr]]
        l_o = (row[0], row[1], row[2])
        l_e1 = (row[3], row[4], row[5])
        l_e2 = (row[6], row[7], row[8])
        p_l = tuple(l_o[c] + u_p * l_e1[c] + v_p * l_e2[c] for c in range(3))
        ldir = _vnormalize(_vsub(p_l, hit["pos"]))
        sh = _scan_primitives(static, prims, hit["pos"], ldir, hit["idx"])
        unocc = sh["hit"] & (sh["idx"] == lr)
        cos_t = torch.clamp(_vdot(hit["nrm"], ldir), min=0.0)
        pdf_l = light_pdf(lr, sh["nrm"], ldir, sh["pos"], hit["pos"])
        pdf_b = cos_t * inv_pi
        w_l = power_heuristic(pdf_l, pdf_b)
        scale = torch.where(lsel & unocc,
                            cos_t * w_l / torch.clamp(pdf_l, min=1e-12), 0.0)
        l_emis = gets(static.emission_idx[lslot[lr]])
        nee = [nee[j] + l_emis[j] * scale for j in range(4)]
    L = tuple(L[j] + brdf[j] * nee[j] * beta[j] for j in range(4))

    # cosine hemisphere
    r_h = sqrt(torch.clamp(u_h, min=0.0))
    th = (2.0 * math.pi) * v_h
    xh = r_h * torch.cos(th)
    yh = r_h * torch.sin(th)
    zh = sqrt(torch.clamp(1.0 - u_h, min=0.0))
    n = hit["nrm"]
    z_minor = torch.abs(n[2]) < 0.999
    up = (torch.where(z_minor, 0.0, 1.0), zero, torch.where(z_minor, 1.0, 0.0))
    tangent = _vnormalize(_vcross(up, n))
    bitangent = _vcross(n, tangent)
    bounce_d = tuple(tangent[c] * xh + bitangent[c] * yh + n[c] * zh
                     for c in range(3))
    bounce_pdf = zh * inv_pi
    cos_b = torch.abs(_vdot(n, bounce_d))
    bfac = cos_b / torch.clamp(bounce_pdf, min=1e-12)
    beta_diffuse = tuple(beta[j] * brdf[j] * bfac for j in range(4))

    # ---- GLASS (1 draw)
    u_g, seed = _rand_masked(seed, is_glass)
    cos_in = _vdot(n, d)
    cosi = torch.clamp(cos_in, -1.0, 1.0)
    fe = torch.where(cosi > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    sint2 = fe * fe * (1.0 - cosi * cosi)
    tir = sint2 > 1.0
    cost = sqrt(torch.where(tir, 1.0, 1.0 - sint2))
    ci = torch.abs(cosi)
    rs = (ETA1 * ci - ETA2 * cost) / (ETA1 * ci + ETA2 * cost)
    rp = (ETA2 * ci - ETA1 * cost) / (ETA2 * ci + ETA1 * cost)
    reflectance = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    eta = torch.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    flip_n = cos_in > 0.0
    ng = _vwhere(flip_n, tuple(-c for c in n), n)
    nd2 = 2.0 * _vdot(ng, d)
    refl_dir = _vsub(d, _vscale(nd2, ng))
    ndoti = _vdot(ng, d)
    kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    ktir = kk < 0.0
    sqk = sqrt(torch.where(ktir, 1.0, kk))
    rft = _vsub(_vscale(eta, d), _vscale(eta * ndoti + sqk, ng))
    rft = _vwhere(ktir, (zero, zero, zero), rft)
    refr_dir = _vnormalize(rft)
    pr = reflectance
    choose_refl = u_g < pr / torch.clamp(pr + (1.0 - pr), min=1e-12)
    glass_dir = _vwhere(choose_refl, refl_dir, refr_dir)
    eta2v = eta * eta
    beta_glass = tuple(torch.where(choose_refl, beta[j], beta[j] * eta2v)
                       for j in range(4))
    eta_scale_glass = torch.where(choose_refl, eta_scale, eta_scale / eta2v)
    toggle_trans = is_glass & ~choose_refl

    # ---- MIRROR
    nd2m = 2.0 * _vdot(n, d)
    mirror_dir = _vsub(d, _vscale(nd2m, n))

    # ---- merge
    o = _vwhere(scatter, hit["pos"], o)
    d = _vwhere(is_diffuse, bounce_d,
                _vwhere(is_glass, glass_dir,
                        _vwhere(is_mirror, mirror_dir, d)))
    beta = tuple(torch.where(is_diffuse, beta_diffuse[j],
                             torch.where(is_glass, beta_glass[j], beta[j]))
                 for j in range(4))
    last_pdf = torch.where(is_diffuse, bounce_pdf, last_pdf)
    is_spec_bounce = is_glass | is_mirror
    specular = is_spec_bounce | (specular & ~(is_diffuse | is_spec_bounce))
    exclude = torch.where(is_spec_bounce, -1, exclude)
    eta_scale = torch.where(is_glass, eta_scale_glass, eta_scale)
    in_trans = in_trans ^ toggle_trans

    # ---- Russian roulette
    r0 = beta[0] * eta_scale
    r1 = beta[1] * eta_scale
    r2 = beta[2] * eta_scale
    max_c = torch.maximum(r0, torch.maximum(r1, r2))
    rr = active & (max_c < 1.0) if depth > rr_start else false
    u_r, seed = _rand_masked(seed, rr)
    q = torch.clamp(1.0 - max_c, min=0.0)
    killed = rr & (u_r < q)
    active = active & ~killed
    surv = rr & ~killed
    inv1q = 1.0 / torch.clamp(1.0 - q, min=1e-12)
    beta = tuple(torch.where(surv, beta[j] * inv1q, beta[j])
                 for j in range(4))

    return {"diff": (o, d, L, beta, last_pdf, eta_scale),
            "nondiff": (seed, exclude, specular, in_trans, active)}


def forward_reference(static: SceneStatic, max_depth: int, rr_start: int,
                      prims: torch.Tensor, rays: torch.Tensor,
                      seeds: torch.Tensor, spect: torch.Tensor
                      ) -> torch.Tensor:
    """Plain torch forward: (4, R) radiance, on the inputs' device.

    A bounce over all-dead rays is the identity (every update is masked
    by ``active``), so the loop stops once no ray is alive."""
    R = rays.shape[1]
    dev = rays.device
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    state = {
        "diff": ((rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5]),
                 (zero,) * 4, (one,) * 4, one, one),
        "nondiff": (tuple(seeds.unbind(0)),
                    torch.full((R,), -1, dtype=torch.int64, device=dev),
                    torch.zeros((R,), dtype=torch.bool, device=dev),
                    torch.zeros((R,), dtype=torch.bool, device=dev),
                    torch.ones((R,), dtype=torch.bool, device=dev)),
    }
    for depth in range(max_depth + 1):
        if not bool(state["nondiff"][4].any()):
            break
        state = _bounce(static, prims, spect, state, depth, max_depth,
                        rr_start)
    return torch.stack(state["diff"][2])


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def _check(static: SceneStatic, prims, rays, seeds, spect, mesh_arrays):
    if static.mesh_parts or mesh_arrays:
        raise NotImplementedError(
            "mesh parts arrive with the mesh slice of the port")
    if 2 in static.categories:
        raise NotImplementedError(
            "triangle rows (category 2) arrive with the mesh slice of the "
            "port")
    P = len(static.rows)
    S = static.n_spectra
    if not static.light_rows:
        raise ValueError("scene has no lights")
    if P > MAX_PRIMS or len(static.light_rows) > MAX_LIGHTS \
            or S > MAX_SPECTRA:
        raise ValueError(
            f"kernel bounds: at most {MAX_PRIMS} primitives, {MAX_LIGHTS} "
            f"lights, {MAX_SPECTRA} spectra (got {P}, "
            f"{len(static.light_rows)}, {S})")
    R = rays.shape[-1] if rays.dim() == 2 else -1
    for name, t, shape, dtype in (
            ("prims", prims, (P, 12), torch.float32),
            ("rays", rays, (6, R), torch.float32),
            ("seeds", seeds, (4, R), torch.int64),
            ("spect", spect, (S * 4, R), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != rays.device:
            raise ValueError(f"{name} is on {t.device}, rays on "
                             f"{rays.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=16)
def _tables(static: SceneStatic, device: torch.device):
    """int32 kernel tables: per slot (row, category, material, emission,
    reflectance), per light (row, slot)."""
    meta = torch.tensor(
        list(zip(static.rows, static.categories, static.materials,
                 static.emission_idx, static.reflectance_idx)),
        dtype=torch.int32).reshape(-1, 5)
    lights = torch.tensor(
        [(lr, static.rows.index(lr)) for lr in static.light_rows],
        dtype=torch.int32).reshape(-1, 2)
    return meta.to(device), lights.to(device)


def _signature(lib):
    fn = lib.megakernel_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, p, p, i, p, ctypes.c_longlong, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _signature_bwd(lib):
    fn = lib.megakernel_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, p, p, i, p, p, p, p, p, p, p,
                   ctypes.c_longlong, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _seeds32(seeds):
    """int64 u32 values -> int32 tensor with the same bit pattern."""
    return torch.where(seeds >= 2 ** 31, seeds - 2 ** 32, seeds).to(
        torch.int32)


def forward(static: SceneStatic, max_depth: int, rr_start: int,
            prims: torch.Tensor, rays: torch.Tensor, seeds: torch.Tensor,
            spect: torch.Tensor, *mesh_arrays) -> torch.Tensor:
    """Forward megakernel -> radiance (4, R) f32.

    CPU tensors run ``forward_reference``. CUDA tensors launch the CUDA
    kernel, built from csrc/megakernel_fwd.cu at first use; a failed
    build or launch raises."""
    global launches
    _check(static, prims, rays, seeds, spect, mesh_arrays)
    if rays.device.type == "cpu":
        return forward_reference(static, max_depth, rr_start, prims, rays,
                                 seeds, spect)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    fn = _signature(_build.library("megakernel_fwd"))
    meta, lights = _tables(static, rays.device)
    seeds32 = _seeds32(seeds)
    R = rays.shape[1]
    out = torch.empty((4, R), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(prims.data_ptr(), meta.data_ptr(), meta.shape[0],
                lights.data_ptr(), lights.shape[0], rays.data_ptr(),
                seeds32.data_ptr(), spect.data_ptr(), static.n_spectra,
                out.data_ptr(), R, int(max_depth), int(rr_start), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def backward_reference(static: SceneStatic, max_depth: int, rr_start: int,
                       prims: torch.Tensor, rays: torch.Tensor,
                       seeds: torch.Tensor, spect: torch.Tensor,
                       dL: torch.Tensor, ray_chunk: int | None = None):
    """Plain torch backward: autograd of ``forward_reference`` with
    respect to (prims, rays, spect) for the radiance cotangent dL (4, R).

    ray_chunk splits the rays into bands of at most that many rays and
    sums d_prims over the bands in order, so that the autograd graph
    (some 10^4 saved (R,) tensors per band at depth 8) stays bounded.
    Returns (d_prims (P, 12), d_rays (6, R), d_spect (S*4, R))."""
    R = rays.shape[1]
    step = R if not ray_chunk else int(ray_chunk)
    d_prims = torch.zeros_like(prims)
    d_rays, d_spect = [], []
    for a in range(0, R, step):
        b = min(R, a + step)
        p = prims.detach().requires_grad_(True)
        r = rays[:, a:b].detach().requires_grad_(True)
        sp = spect[:, a:b].detach().requires_grad_(True)
        with torch.enable_grad():
            out = forward_reference(static, max_depth, rr_start, p, r,
                                    seeds[:, a:b], sp)
            grads = torch.autograd.grad(out, (p, r, sp),
                                        grad_outputs=dL[:, a:b],
                                        allow_unused=True)
        gp, gr, gs = (torch.zeros_like(x) if g is None else g
                      for g, x in zip(grads, (p, r, sp)))
        d_prims = d_prims + gp
        d_rays.append(gr)
        d_spect.append(gs)
    return d_prims, torch.cat(d_rays, dim=1), torch.cat(d_spect, dim=1)


def backward(static: SceneStatic, max_depth: int, rr_start: int,
             prims: torch.Tensor, rays: torch.Tensor, seeds: torch.Tensor,
             spect: torch.Tensor, dL: torch.Tensor):
    """Backward megakernel -> (d_prims (P, 12), d_rays (6, R),
    d_spect (S*4, R)) for the radiance cotangent dL (4, R).

    CPU tensors run ``backward_reference``. CUDA tensors launch the CUDA
    kernel built from csrc/megakernel_bwd.cu; a failed build or launch
    raises. d_prims is summed in a fixed order, so two calls on the same
    inputs give bit-equal results."""
    global launches_bwd
    _check(static, prims, rays, seeds, spect, ())
    R = rays.shape[1]
    if tuple(dL.shape) != (4, R) or dL.dtype != torch.float32:
        raise ValueError(f"dL: expected {(4, R)} {torch.float32}, got "
                         f"{tuple(dL.shape)} {dL.dtype}")
    if dL.device != rays.device:
        raise ValueError(f"dL is on {dL.device}, rays on {rays.device}")
    if not dL.is_contiguous():
        raise ValueError("dL must be contiguous")
    if rays.device.type == "cpu":
        return backward_reference(static, max_depth, rr_start, prims, rays,
                                  seeds, spect, dL)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    fn = _signature_bwd(_build.library("megakernel_bwd"))
    meta, lights = _tables(static, rays.device)
    dev = rays.device
    P = prims.shape[0]
    D = int(max_depth) + 1
    f32 = dict(dtype=torch.float32, device=dev)
    d_prims = torch.empty((P, 12), **f32)
    d_rays = torch.empty((6, R), **f32)
    d_spect = torch.empty(tuple(spect.shape), **f32)
    if R == 0:
        return d_prims.zero_(), d_rays, d_spect
    partial = torch.empty(((R + 127) // 128, P * 12), **f32)
    tape_f = torch.empty((D * 16, R), **f32)
    tape_i = torch.empty((D * 8, R), dtype=torch.int32, device=dev)
    seeds32 = _seeds32(seeds)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(prims.data_ptr(), meta.data_ptr(), meta.shape[0],
                lights.data_ptr(), lights.shape[0], rays.data_ptr(),
                seeds32.data_ptr(), spect.data_ptr(), static.n_spectra,
                dL.data_ptr(), d_prims.data_ptr(), partial.data_ptr(),
                d_rays.data_ptr(), d_spect.data_ptr(), tape_f.data_ptr(),
                tape_i.data_ptr(), R, int(max_depth), int(rr_start), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel_bwd launch failed: CUDA error {rc}")
    launches_bwd += 1
    return d_prims, d_rays, d_spect


class TraceFn(torch.autograd.Function):
    """Differentiable trace: forward is ``forward``, backward is
    ``backward`` (the CUDA backward kernel for CUDA tensors). Seeds get
    no gradient.

        radiance = TraceFn.apply(static, max_depth, rr_start, prims, rays,
                                 seeds, spect)
    """

    @staticmethod
    def forward(ctx, static, max_depth, rr_start, prims, rays, seeds, spect):
        ctx.static = static
        ctx.max_depth = int(max_depth)
        ctx.rr_start = int(rr_start)
        ctx.save_for_backward(prims, rays, seeds, spect)
        return forward(static, max_depth, rr_start, prims, rays, seeds,
                       spect)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        prims, rays, seeds, spect = ctx.saved_tensors
        d_prims, d_rays, d_spect = backward(
            ctx.static, ctx.max_depth, ctx.rr_start, prims, rays, seeds,
            spect, g.contiguous())
        return None, None, None, d_prims, d_rays, None, d_spect
