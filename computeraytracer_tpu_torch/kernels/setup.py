"""The per-sample setup's kernels (csrc/setup.cu), each with its plain
torch version beside it.

- ``ray_setup``: the seeds, jittered camera rays and hero draw of every
  ray at one stratified sample (the JAX package's
  tracer/pallas.py:708-712: ``rng.seed_pixel_p`` ->
  ``camera.camera_rays_p`` -> ``spectrum.sample_wavelengths_p``), bit for
  bit; ``ray_setup_reference`` is that composition in torch. The kernel
  reads the camera's own tensors and computes the camera frame itself.
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
its backward together, and ``tracer/kernel.py`` ``camera_planes`` runs
``ray_setup``.
"""

from __future__ import annotations

import torch

from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import rng

# Rays per block of the backward's first level (csrc/setup.cu HERO_BLOCK),
# the groups of blocks of its second (GROUPS), the most table columns the
# backward kernel takes (MAX_COLS) and the ints of its sort scratch a block
# (SORT_WORDS).
HERO_BLOCK = 2048
HERO_GROUPS = 8
MAX_COLS = 512
SORT_WORDS = 1540

# Kernel launches, counted by each wrapper where it launches its kernel
# (CPU calls launch nothing and do not count).
launches_ray_setup = 0
launches_gather = 0
launches_gather_bwd = 0


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
    The kernel has no backward, so it raises where a camera tensor needs a
    gradient."""
    if px.device.type == "cpu":
        return ray_setup_reference(camera, width, height, px, py, sample)
    leaves = (camera.eye, camera.lookat, camera.up, camera.fov)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        raise ValueError(
            "the ray-setup kernel has no backward: camera gradients on the "
            "card go through tracer.kernel.render_pixels(stratified=False) "
            "or backward='xla'")
    return ray_setup_launch(*leaves, width, height, px, py, sample)


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
