"""The per-sample setup's kernels (csrc/setup.cu), each with its plain
torch version beside it.

- ``ray_setup``: the seeds, jittered camera rays and hero draw of every
  ray at one stratified sample (the JAX package's
  tracer/pallas.py:708-712: ``rng.seed_pixel_p`` ->
  ``camera.camera_rays_p`` -> ``spectrum.sample_wavelengths_p``), bit for
  bit; ``ray_setup_reference`` is that composition in torch. The kernel
  reads the camera's own tensors and computes the camera frame itself.
  ``RaySetupFn`` differentiates it with respect to the camera.
- ``ray_setup_bwd``: its backward to eye, lookat, up and fov (the JAX
  kernel path's XLA AD of ``camera_rays_p``, tracer/pallas.py:709-711):
  twelve sums over the rays of the cotangents g_o, g_d, in float64 in a
  fixed order without atomics (within each block of ``BWD_BLOCK``
  consecutive rays a shuffle tree per warp of 32, then the warps in order;
  then the blocks in ``BWD_GROUPS`` groups of consecutive blocks, each in
  block order; then the groups in order) and rounded once to f32, then
  the VJP of the camera frame (``film_frame_vjp``).
  ``ray_setup_bwd_reference`` is the same in torch, its sums bit-equal to
  the kernel's on the card.
- ``hero_gather_tables``: the column gathers ``table[:, hero]`` of one or
  two hero-expanded tables in one launch (the JAX package gathers the
  spectra and CIE tables together, tracer/pallas.py:726-731, with
  ``gather_hero_planar``, ops/spectrum.py:121); ``hero_gather`` for one.
- ``hero_column_sums``: its backward, the column sums of a cotangent g
  (K, R) by hero, in a fixed order without float atomics: within each
  block of ``HERO_BLOCK`` consecutive rays in ray order, then the blocks'
  partials in ``HERO_GROUPS`` groups of consecutive blocks, each in block
  order, then the groups in order (the JAX ``take_cols`` VJP,
  ops/spectrum.py:246, is a one-hot contraction in blocks of rays,
  ``_chunked``). Two runs give bit-equal sums.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, built at first use by
``kernels._build``; a failed build or launch raises. Each launch adds one
to its counter. ``ops/spectrum.py`` ``HeroGatherFn`` puts the gather and
its backward together, ``RaySetupFn`` the ray setup and its backward, and
``tracer/kernel.py`` ``camera_planes`` runs ``ray_setup``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import rng
from computeraytracer_tpu_torch.scene.data import CameraSpec
from computeraytracer_tpu_torch.utils import profiling

# Rays per block of the backward's first level (csrc/setup.cu HERO_BLOCK),
# the groups of blocks of its second (GROUPS), the most table columns the
# backward kernel takes (MAX_COLS) and the ints of its sort scratch a block
# (SORT_WORDS).
HERO_BLOCK = 2048
HERO_GROUPS = 8
MAX_COLS = 512
SORT_WORDS = 1540
# The ray setup's backward (csrc/setup.cu): rays per block of its first
# pass (THREADS), lanes per warp of its shuffle tree, its second pass's
# groups of blocks (BWD_GROUPS) and its ray sums (BWD_SUMS).
BWD_BLOCK = 256
BWD_WARP = 32
BWD_GROUPS = 64
BWD_SUMS = 12

# Kernel launches, counted by each wrapper where it launches its kernel
# (CPU calls launch nothing and do not count).
launches_ray_setup = 0
launches_gather = 0
launches_gather_bwd = 0
launches_ray_setup_bwd = 0


def hero_index(u: torch.Tensor) -> torch.Tensor:
    """The hero wavelength index int(u * 301) of uniforms u in [0, 1)."""
    return (u * float(C.N_LAMBDA)).to(torch.int64)


def ray_setup_reference(camera, width: int, height: int, px, py, sample):
    """The plain per-ray setup: seeds, stratified camera rays and the hero
    draw for pixels px, py (R,) at a 1-based sample index -> (o (3, R),
    d (3, R), hero (R,) int64, seed (4, R) int64 u32 words)."""
    seed = rng.seed_pixel_p(px, py, sample)
    o, d, seed = cam_ops.camera_rays_p(camera.eye, camera.lookat, camera.up,
                                       camera.fov, width, height, px, py,
                                       sample, seed)
    u, seed = rng.rand_p(seed)
    return o, d, hero_index(u), seed


def ray_setup(camera, width: int, height: int, px, py, sample):
    """``ray_setup_reference``'s outputs: its plain version for pixels on
    the CPU; on a CUDA device one launch of the ray-setup kernel
    (``ray_setup_launch``) on the camera's own tensors, whose outputs are
    the plain version's bit for bit (o contiguous, not an expanded view).
    Differentiable with respect to the camera's tensors (``RaySetupFn``)."""
    return RaySetupFn.apply(camera.eye, camera.lookat, camera.up, camera.fov,
                            width, height, px, py, sample)


def _ray_setup(eye, lookat, up, fov, width, height, px, py, sample):
    if px.device.type == "cpu":
        return ray_setup_reference(CameraSpec(eye, lookat, up, fov), width,
                                   height, px, py, sample)
    return ray_setup_launch(eye, lookat, up, fov, width, height, px, py,
                            sample)


class RaySetupFn(torch.autograd.Function):
    """The ray setup (``ray_setup``) with its backward to the camera: the
    JAX kernel path's XLA AD of ``camera_rays_p``. Forward is the ray-setup
    kernel (the plain version on the CPU); backward ``ray_setup_bwd`` of
    the cotangents of o and d, the backward kernel on the card, and a
    gradient for each camera tensor that needs one. hero and seed are not
    differentiable; the pixels, sample and film size get no gradient. With
    no gradient wanted (grad mode off, or no camera tensor that needs one)
    it records nothing and is one launch of the forward kernel.

        o, d, hero, seed = RaySetupFn.apply(eye, lookat, up, fov, width,
                                            height, px, py, sample)
    """

    @classmethod
    def apply(cls, eye, lookat, up, fov, width, height, px, py, sample):
        # needs_input_grad ignores no_grad: decide here
        if not (torch.is_grad_enabled()
                and any(x.requires_grad for x in (eye, lookat, up, fov))):
            return _ray_setup(eye, lookat, up, fov, width, height, px, py,
                              sample)
        return super().apply(eye, lookat, up, fov, width, height, px, py,
                             sample)

    @staticmethod
    def forward(ctx, eye, lookat, up, fov, width, height, px, py, sample):
        ctx.film = (int(width), int(height))
        ctx.sample = sample
        ctx.save_for_backward(eye, lookat, up, fov, px, py)
        o, d, hero, seed = _ray_setup(eye, lookat, up, fov, width, height,
                                      px, py, sample)
        ctx.mark_non_differentiable(hero, seed)
        # the plain version's o is a view of eye
        return o.contiguous(), d, hero, seed

    @staticmethod
    @once_differentiable
    def backward(ctx, g_o, g_d, _hero, _seed):
        eye, lookat, up, fov, px, py = ctx.saved_tensors
        with profiling.annotate("ray_setup.backward"):
            grads = ray_setup_bwd(CameraSpec(eye, lookat, up, fov),
                                  *ctx.film, px, py, ctx.sample, g_o, g_d)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad[:4])),
                None, None, None, None, None)


def ray_setup_launch(eye, lookat, up, fov, width: int, height: int, px, py,
                     sample):
    """One launch of the ray-setup kernel for pixels px, py (R,) int64 on
    their CUDA device, with the camera's eye, lookat, up (3,) and fov ()
    f32 contiguous tensors there (checked, never copied) ->
    ``ray_setup``'s outputs. The kernel computes the camera frame
    (``ops/camera.py`` ``film_frame``) itself."""
    global launches_ray_setup
    dev = px.device
    mk._require_cuda(dev)
    R = px.shape[0] if px.dim() == 1 else -1
    px, py = px.contiguous(), py.contiguous()
    mk._check_tensor("px", px, (R,), torch.int64, dev)
    mk._check_tensor("py", py, (R,), torch.int64, dev)
    for name, t, shape in (("eye", eye, (3,)), ("lookat", lookat, (3,)),
                           ("up", up, (3,)), ("fov", fov, ())):
        mk._check_tensor(f"camera {name}", t, shape, torch.float32, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    o, d = torch.empty((3, R), **f32), torch.empty((3, R), **f32)
    hero, seed = torch.empty((R,), **i64), torch.empty((4, R), **i64)
    mk._launch("ray_setup", mk._fn("setup", "ray_setup"), dev, px.data_ptr(),
               py.data_ptr(), eye.data_ptr(), lookat.data_ptr(),
               up.data_ptr(), fov.data_ptr(), int(sample) & rng.MASK,
               int(width), int(height), o.data_ptr(), d.data_ptr(),
               hero.data_ptr(), seed.data_ptr(), R)
    launches_ray_setup += 1
    return o, d, hero, seed


def ray_setup_bwd_terms(camera, width: int, height: int, px, py, sample,
                        g_o, g_d) -> torch.Tensor:
    """The twelve per-ray terms of the ray setup's backward for pixels px,
    py (R,) and the cotangents g_o, g_d (3, R) of o and d -> (12, R): g_o,
    g_u, s g_u and t g_u, with (s, t) each ray's film point, u = lower_left
    + s*horizontal + t*vertical - eye as ``ray_setup_reference`` computes
    it, d = u / |u| and g_u = (g_d - d (d . g_d)) / |u|, in the kernel's
    operation order."""
    seed = rng.seed_pixel_p(px, py, sample)
    lower_left, horizontal, vertical = cam_ops.film_frame(
        camera.eye, camera.lookat, camera.up, camera.fov, width, height)
    us, seed = rng.rand_p(seed)
    ut, seed = rng.rand_p(seed)
    js, jt = cam_ops._jitter(sample, us, ut, True)
    s, t = cam_ops._film_st(width, height, px, py, js, jt)
    u = (lower_left[:, None] + s[None, :] * horizontal[:, None]
         + t[None, :] * vertical[:, None] - camera.eye[:, None])
    norm = cam_ops.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    d = u / norm
    dg = (d[0] * g_d[0] + d[1] * g_d[1]) + d[2] * g_d[2]
    g_u = (g_d - d * dg) / norm
    return torch.cat([g_o, g_u, s * g_u, t * g_u])


def ray_setup_bwd_sums_reference(terms: torch.Tensor) -> torch.Tensor:
    """(K, R) f32 terms -> (K,) f32 sums in the backward kernel's order, in
    float64, each rounded once to f32 at the end: within each block of
    BWD_BLOCK consecutive rays (rays past R are zeros), a tree in each warp
    of BWD_WARP lanes (lane i adds lane i + h for h = 16, 8, 4, 2, 1), then
    the warps in order; the blocks' partials in BWD_GROUPS groups of
    ceil(n_blocks / BWD_GROUPS) consecutive blocks, each in block order;
    then the groups in order. Every sum starts from 0.0."""
    K, R = terms.shape
    n_blocks = -(-R // BWD_BLOCK)
    lanes = terms.new_zeros((K, n_blocks * BWD_BLOCK), dtype=torch.float64)
    lanes[:, :R] = terms
    lanes = lanes.reshape(K, n_blocks, BWD_BLOCK // BWD_WARP, BWD_WARP)
    h = BWD_WARP // 2
    while h:
        lanes = lanes[..., :h] + lanes[..., h:2 * h]
        h //= 2
    partial = lanes.new_zeros((K, n_blocks))
    for w in range(BWD_BLOCK // BWD_WARP):
        partial = partial + lanes[:, :, w, 0]
    per = -(-n_blocks // BWD_GROUPS)
    padded = lanes.new_zeros((K, BWD_GROUPS * per))
    padded[:, :n_blocks] = partial
    padded = padded.reshape(K, BWD_GROUPS, per)
    groups = lanes.new_zeros((K, BWD_GROUPS))
    for b in range(per):
        groups = groups + padded[:, :, b]
    out = lanes.new_zeros((K,))
    for g in range(BWD_GROUPS):
        out = out + groups[:, g]
    return out.float()


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def film_frame_vjp(eye, lookat, up, fov, width: int, height: int, sums):
    """The VJP of the ray setup to the camera from its twelve ray sums
    (``ray_setup_bwd_sums_reference``: sum g_o, sum g_u, sum s g_u, sum t
    g_u) -> the gradients of (eye (3,), lookat (3,), up (3,), fov ()). The
    rays give eye sum g_o - sum g_u, lower_left sum g_u, horizontal sum s
    g_u and vertical sum t g_u; the rest is the VJP of ``ops/camera.py``
    ``film_frame``, its basis recomputed as it computes it (its crosses
    and norms with fused multiply-adds, as the VJP's crosses). The same
    operations in the same order as the kernel's (csrc/setup.cu
    film_frame_vjp); every division is by a tensor."""
    go, gu, gs, gt = sums[0:3], sums[3:6], sums[6:9], sums[9:12]
    e = eye - lookat
    ne = cam_ops._norm(e)
    w = e / ne
    c = cam_ops._cross(up, w)
    nc = cam_ops._norm(c)
    u = c / nc
    v = cam_ops._cross(w, u)
    th = torch.tan(fov * 0.5)
    vh = 2.0 * th
    aspect = cam_ops._aspect(width, height, fov.device)
    vw = aspect * vh
    g_eye = (go - gu) + gu
    g_hor = gs - gu * 0.5
    g_ver = gt - gu * 0.5
    g_u = vw * g_hor
    g_v = vh * g_ver
    g_vh = _dot(g_ver, v) + aspect * _dot(g_hor, u)
    g_fov = (2.0 * g_vh) * (1.0 + th * th) * 0.5
    g_w = -gu + cam_ops._cross(u, g_v)
    g_u = g_u + cam_ops._cross(g_v, w)
    g_c = (g_u - u * _dot(u, g_u)) / nc
    g_up = cam_ops._cross(w, g_c)
    g_w = g_w + cam_ops._cross(g_c, up)
    g_e = (g_w - w * _dot(w, g_w)) / ne
    return g_eye + g_e, -g_e, g_up, g_fov


def ray_setup_bwd_reference(camera, width: int, height: int, px, py, sample,
                            g_o, g_d):
    """The plain backward of ``ray_setup_reference`` to the camera for the
    cotangents g_o, g_d (3, R) of o and d -> the gradients of (eye, lookat,
    up, fov): ``film_frame_vjp`` of the terms' fixed-order sums."""
    sums = ray_setup_bwd_sums_reference(ray_setup_bwd_terms(
        camera, width, height, px, py, sample, g_o, g_d))
    return film_frame_vjp(camera.eye, camera.lookat, camera.up, camera.fov,
                          width, height, sums)


def ray_setup_bwd(camera, width: int, height: int, px, py, sample, g_o,
                  g_d):
    """``ray_setup_bwd_reference``'s gradients: the plain version for
    pixels on the CPU, the backward kernel (``ray_setup_bwd_launch``) on a
    CUDA device."""
    if px.device.type == "cpu":
        return ray_setup_bwd_reference(camera, width, height, px, py, sample,
                                       g_o, g_d)
    return ray_setup_bwd_launch(camera.eye, camera.lookat, camera.up,
                                camera.fov, width, height, px, py, sample,
                                g_o, g_d)[0]


def ray_setup_bwd_launch(eye, lookat, up, fov, width: int, height: int, px,
                         py, sample, g_o, g_d):
    """One call of the ray setup's backward kernels (two launches) for
    ``ray_setup_launch``'s arguments and the cotangents g_o, g_d (3, R) f32
    on their CUDA device -> ((d eye, d lookat, d up, d fov), the twelve
    sums (12,)), the sums bit-equal to ``ray_setup_bwd_sums_reference``'s
    of ``ray_setup_bwd_terms``."""
    global launches_ray_setup_bwd
    dev = px.device
    mk._require_cuda(dev)
    R = px.shape[0] if px.dim() == 1 else -1
    px, py = px.contiguous(), py.contiguous()
    g_o, g_d = g_o.contiguous(), g_d.contiguous()
    mk._check_tensor("px", px, (R,), torch.int64, dev)
    mk._check_tensor("py", py, (R,), torch.int64, dev)
    mk._check_tensor("g_o", g_o, (3, R), torch.float32, dev)
    mk._check_tensor("g_d", g_d, (3, R), torch.float32, dev)
    for name, t, shape in (("eye", eye, (3,)), ("lookat", lookat, (3,)),
                           ("up", up, (3,)), ("fov", fov, ())):
        mk._check_tensor(f"camera {name}", t, shape, torch.float32, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((-(-R // BWD_BLOCK), BWD_SUMS),
                          dtype=torch.float64, device=dev)
    out = torch.empty((BWD_SUMS + 10,), **f32)
    mk._launch("ray_setup_bwd", mk._fn("setup", "ray_setup_bwd"), dev,
               px.data_ptr(), py.data_ptr(), eye.data_ptr(),
               lookat.data_ptr(), up.data_ptr(), fov.data_ptr(),
               int(sample) & rng.MASK, int(width), int(height),
               g_o.data_ptr(), g_d.data_ptr(), partial.data_ptr(),
               out.data_ptr(), R)
    launches_ray_setup_bwd += 1
    g = out[BWD_SUMS:]
    return (g[0:3], g[3:6], g[6:9], g[9]), out[:BWD_SUMS]


def _gather_operands(name, t, hero):
    """A kernel's 2-D f32 operand t and hero (R,) int64 on a CUDA device,
    checked and made contiguous -> (t, hero, R)."""
    mk._require_cuda(hero.device)
    R = hero.shape[0] if hero.dim() == 1 else -1
    t, hero = t.contiguous(), hero.contiguous()
    mk._check_tensor("hero", hero, (R,), torch.int64, hero.device)
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got "
                         f"{tuple(t.shape)}")
    mk._check_tensor(name, t, tuple(t.shape), torch.float32, hero.device)
    return t, hero, R


def hero_gather_reference(table: torch.Tensor,
                          hero: torch.Tensor) -> torch.Tensor:
    """(K, L) table, hero (R,) in [0, L) -> (K, R), table[:, hero]."""
    return table[:, hero]


def hero_gather(table: torch.Tensor, hero: torch.Tensor) -> torch.Tensor:
    """``hero_gather_reference``: ``hero_gather_tables`` of one table."""
    return hero_gather_tables((table,), hero)[0]


def hero_gather_tables(tables, hero: torch.Tensor) -> tuple:
    """One or two (K_i, L) tables, hero (R,) -> (table[:, hero] for each
    table): the plain version on the CPU, one launch of the gather kernel
    on a CUDA device (bit-equal; a hero outside [0, L) gives NaN there
    where the plain version raises)."""
    global launches_gather
    if hero.device.type == "cpu":
        return tuple(hero_gather_reference(t, hero) for t in tables)
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"the gather kernel takes one or two tables, got "
                         f"{len(tables)}")
    checked = []
    for k, table in enumerate(tables):
        table, hero, R = _gather_operands(f"table {k}", table, hero)
        if table.shape[1] != tables[0].shape[1]:
            raise ValueError(f"tables of {tables[0].shape[1]} and "
                             f"{table.shape[1]} columns")
        checked.append(table)
    outs = tuple(torch.empty((t.shape[0], R), dtype=torch.float32,
                             device=hero.device) for t in checked)
    t0, out0 = checked[0], outs[0]
    t1, out1 = (checked[1], outs[1]) if len(checked) == 2 else (t0, out0)
    mk._launch("hero_gather", mk._fn("setup", "hero_gather"), hero.device,
               t0.data_ptr(), t1.data_ptr(), hero.data_ptr(),
               out0.data_ptr(), out1.data_ptr(), t0.shape[0],
               t1.shape[0] if len(checked) == 2 else 0, t0.shape[1], R)
    launches_gather += 1
    return outs


def hero_column_sums_reference(g: torch.Tensor, hero: torch.Tensor,
                               n_cols: int,
                               block: int = HERO_BLOCK) -> torch.Tensor:
    """g (K, R), hero (R,) -> (K, n_cols): column l sums g[:, r] over the
    rays with hero[r] == l (a hero outside [0, n_cols) is skipped): within
    each block of ``block`` consecutive rays in ray order; then the
    blocks' partials in HERO_GROUPS groups of ceil(n_blocks / HERO_GROUPS)
    consecutive blocks, each in block order; then the groups in order.
    Every sum starts from 0.0. A stable sort groups each block's rays by
    column and a segment sum adds them in ray order."""
    K, R = g.shape
    n_blocks = -(-R // block)
    per = -(-n_blocks // HERO_GROUPS)
    valid = (hero >= 0) & (hero < n_cols)
    blk = torch.arange(R, device=g.device) // block
    key = (blk * n_cols + hero)[valid]
    order = torch.argsort(key, stable=True)
    keys, lengths = torch.unique_consecutive(key[order], return_counts=True)
    partial = g.new_zeros((HERO_GROUPS * per * n_cols, K))
    if keys.numel():
        partial[keys] = torch.segment_reduce(g.T[valid][order], "sum",
                                             lengths=lengths, axis=0)
    partial = partial.reshape(HERO_GROUPS, per, n_cols, K)
    groups = g.new_zeros((HERO_GROUPS, n_cols, K))
    for b in range(per):
        groups = groups + partial[:, b]
    out = g.new_zeros((n_cols, K))
    for w in range(HERO_GROUPS):
        out = out + groups[w]
    return out.T.contiguous()


def hero_column_sums(g: torch.Tensor, hero: torch.Tensor,
                     n_cols: int) -> torch.Tensor:
    """``hero_column_sums_reference`` in blocks of HERO_BLOCK rays: the
    plain version on the CPU, the column-sum kernels' three launches
    (sort, sums, reduce) on a CUDA device (the same order, bit for bit;
    no float atomics)."""
    global launches_gather_bwd
    if hero.device.type == "cpu":
        return hero_column_sums_reference(g, hero, n_cols, HERO_BLOCK)
    g, hero, R = _gather_operands("g", g, hero)
    K = g.shape[0]
    mk._check_tensor("g", g, (K, R), torch.float32, hero.device)
    if not 1 <= n_cols <= MAX_COLS or R < 1 or not 1 <= K <= 65535:
        raise ValueError(f"hero_column_sums takes 1..{MAX_COLS} columns, "
                         f"rays and 1..65535 rows (got {n_cols}, {R}, {K})")
    fn = mk._fn("setup", "hero_column_sums")
    f32 = dict(dtype=torch.float32, device=hero.device)
    # the kernel refuses a block size other than its own (csrc/setup.cu
    # HERO_BLOCK), which sizes the scratch
    n_blocks = -(-R // HERO_BLOCK)
    sort = torch.empty((n_blocks, SORT_WORDS), dtype=torch.int32,
                       device=hero.device)
    partial = torch.empty((n_blocks, K, n_cols), **f32)
    out = torch.empty((K, n_cols), **f32)
    mk._launch("hero_column_sums", fn, hero.device, g.data_ptr(),
               hero.data_ptr(), sort.data_ptr(), partial.data_ptr(),
               out.data_ptr(), K, n_cols, R, HERO_BLOCK)
    launches_gather_bwd += 1
    return out
