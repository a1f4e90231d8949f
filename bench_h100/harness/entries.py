"""The two entries a mix can name, driving the program through its public
entry points.

- ``render``: ``tracer.api.render`` with the forward kernel path, frames
  back to back from one caller, each frame the next ``spp`` samples
  (progressive refinement from a first sample drawn from the seed); on
  several cards ``parallel.render_sharded.render_accumulate_sharded``.
- ``fit``: ``train.optimize.make_train_step`` with ``torch.optim.Adam``
  on the mix's trainable leaves, against a target XYZ image drawn from
  the seed, the same samples every step (``optimize``'s default), the loss
  read back every step as ``optimize`` does; on several cards the same
  step with ``mesh``.

An entry builds everything at set-up (``warm`` runs its shapes once), and
``unit`` runs one frame or step, synchronised. What the comparison needs
is kept: a few frames' images (``answers``), or the first steps' losses,
first gradient and leaves (``followed``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_h100.harness import cells


def seeded(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_sample(cell, seed: int, warm: int) -> int:
    """The window's first sample index (1-based), drawn from the seed past
    the warm-up's samples."""
    spp = int(cell.mix["spp"])
    slots = int(cell.mix["sample_range"]) // spp
    return 1 + spp * (warm + int(seeded(seed).integers(0, slots)))


def target_image(cell, seed: int, device) -> torch.Tensor:
    """The fit's target XYZ image (H, W, 3), uniform in the mix's range,
    drawn on the device from the seed."""
    lo, hi = cell.mix["target"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((cell.height, cell.width, 3), generator=g, device=device)
    return u * float(hi - lo) + float(lo)


class Serve:
    def __init__(self, ctx):
        from computeraytracer_tpu_torch import RenderConfig, scene_from_dict

        c = ctx.cell
        self.ctx, self.cell = ctx, c
        self.spp = int(c.mix["spp"])
        self.n_warm = int(c.mix["warmup_units"])
        self.first = first_sample(c, ctx.seed, self.n_warm)
        self.doc = cells.scene_doc(c)
        self.scene, _ = scene_from_dict(self.doc, device=ctx.device)
        self.cfg = RenderConfig(width=c.width, height=c.height, spp=self.spp,
                                max_depth=int(c.config["max_depth"]),
                                rr_start=int(c.config["rr_start"]),
                                kernel="pallas")
        self.paths_per_unit = c.width * c.height * self.spp
        self.keep = {0}
        self.kept = {}
        self.last = None

    def sample_of(self, k: int) -> int:
        return self.first + k * self.spp

    def _call(self, sample: int) -> dict:
        if self.ctx.mesh is None:
            from computeraytracer_tpu_torch.tracer import api
            out = api.render(self.scene, self.cfg, first_sample=sample)
            return {"accum": out["accum_xyz"], "srgb": out["srgb"],
                    "samples": out["samples"], "first_sample": sample}
        from computeraytracer_tpu_torch.parallel import render_sharded
        accum = render_sharded.render_accumulate_sharded(
            self.scene, self.cell.width, self.cell.height, self.spp,
            self.ctx.mesh, self.cfg.max_depth, self.cfg.rr_start, sample)
        return {"accum": accum, "srgb": None, "samples": None,
                "first_sample": sample}

    def warm(self) -> None:
        """Frames of samples before the window's; warm_s times the last."""
        for i in range(self.n_warm):
            t0 = time.perf_counter()
            self._call(1 + self.spp * i)
            sync(self.ctx.device)
            self.warm_s = time.perf_counter() - t0

    def plan(self, expected_units: int) -> None:
        """Keep the window's first frame, its last, and one drawn from the
        seed among those it is expected to complete."""
        n = max(1, expected_units)
        self.keep = {0, int(seeded(self.ctx.seed, 1).integers(0, n))}

    def unit(self, k: int) -> None:
        out = self._call(self.sample_of(k))
        sync(self.ctx.device)
        if k in self.keep:
            self.kept[k] = out
        self.last = (k, out)

    def answers(self, n_pixels: int) -> list:
        """The kept frames, each at n_pixels pixels drawn from the seed:
        [{first_sample, samples, idx, accum (n, 3), srgb (n, 3) | None}]."""
        frames = dict(self.kept)
        frames[self.last[0]] = self.last[1]
        out = []
        n_film = self.cell.width * self.cell.height
        for j, k in enumerate(sorted(frames)):
            f = frames[k]
            idx = np.sort(seeded(self.ctx.seed, 10 + j).choice(
                n_film, size=min(n_pixels, n_film), replace=False))
            ti = torch.from_numpy(idx).to(f["accum"].device)

            def pick(img):
                return None if img is None else (
                    img.reshape(-1, 3).index_select(0, ti).detach().cpu())

            out.append({"frame": k, "first_sample": f["first_sample"],
                        "samples": f["samples"], "idx": idx,
                        "accum": pick(f["accum"]), "srgb": pick(f["srgb"])})
        return out

    def measured(self, unit_s: list, window_s: float) -> dict:
        return {"render_mpaths_per_s":
                self.paths_per_unit * len(unit_s) / window_s / 1e6,
                "frame_p95_ms": float(np.percentile(unit_s, 95)) * 1e3}

    def release(self) -> None:
        self.scene = self.kept = self.last = None


class Fit:
    def __init__(self, ctx):
        from computeraytracer_tpu_torch import scene_from_dict
        from computeraytracer_tpu_torch.train import optimize

        c = ctx.cell
        self.ctx, self.cell = ctx, c
        mix = c.mix
        self.spp = int(mix["spp"])
        self.first = first_sample(c, ctx.seed, 0)
        self.doc = cells.scene_doc(c)
        scene, _ = scene_from_dict(self.doc, device=ctx.device)
        params0, static = optimize.split_scene(scene, tuple(mix["trainable"]))
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params0.items()}
        self.opt = torch.optim.Adam(list(self.params.values()),
                                    lr=float(mix["learning_rate"]))
        self.step = optimize.make_train_step(
            static, self.opt, c.width, c.height, self.spp,
            int(c.config["max_depth"]), int(c.config["rr_start"]),
            mesh=ctx.mesh, backward=mix["backward"])
        self.target = target_image(c, ctx.seed, ctx.device)
        self.paths_per_unit = c.width * c.height * self.spp
        self.failed = 0
        self.followed = None

    def _step(self) -> float:
        return float(self.step(self.params, self.target, self.first))

    def warm(self) -> None:
        """The first steps, which the reference follows: their losses, the
        first gradient as Adam holds it after one step, and the leaves as
        the next step receives them."""
        n = int(self.cell.mix["followed_steps"])
        theta0 = {k: v.detach().clone() for k, v in self.params.items()}
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses, first_grad = [], None
        for i in range(n):
            losses.append(self._step())
            if i == 0:
                # a step that left Adam's state unchanged holds no gradient
                first_grad = {
                    k: (self.opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                        ).detach().clone()
                    for k, p in self.params.items()}
        self.followed = {
            "losses": losses, "first_grad": first_grad, "theta0": theta0,
            "theta": {k: v.detach().clone() for k, v in self.params.items()}}
        sync(self.ctx.device)

    def plan(self, expected_units: int) -> None:
        pass

    def unit(self, k: int) -> None:
        if not math.isfinite(self._step()):
            self.failed += 1

    def measured(self, unit_s: list, window_s: float) -> dict:
        out = {"fit_mpaths_per_s":
               self.paths_per_unit * len(unit_s) / window_s / 1e6}
        if self.ctx.device.type == "cuda":
            out["fit_peak_gib"] = (torch.cuda.max_memory_allocated(
                self.ctx.device) / 2 ** 30)
        return out

    def release(self) -> None:
        self.params = self.opt = self.step = None


ENTRIES = {"render": Serve, "fit": Fit}
