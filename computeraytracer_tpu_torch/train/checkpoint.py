"""Checkpoint / resume (port of computeraytracer_tpu/train/checkpoint.py).

A checkpoint is one ``torch.save`` file per step: the params, the
optimizer's state (``state_dict``s), ``extra``, the step and the
geometry layout version. Rendering is a pure fold over samples and the
RNG is counter-based, so a resumed run repeats the uninterrupted one bit
for bit on the same device.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import torch

# Geometry layout version persisted with every checkpoint. Version 2 =
# triangle rows (category 2) store ABSOLUTE VERTICES in data2/data3;
# version 1 stored edge vectors. A version-1 checkpoint containing
# triangles would restore cleanly but be silently reinterpreted as
# vertices: fail loudly instead.
LAYOUT_VERSION = 2


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


class Checkpointer:
    """Minimal step-indexed checkpointer: ``step_XXXXXXXX.pt`` files in
    one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Any = None):
        payload = {"params": _detached(params), "opt_state": opt_state,
                   "extra": extra, "step": int(step),
                   "layout_version": LAYOUT_VERSION}
        path = self._path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".pt"):
                try:
                    steps.append(int(name[len("step_"):-len(".pt")]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, map_location=None) -> dict:
        """The saved payload of `step`; raises ValueError for a file with
        no layout_version (pre-versioning or corrupt) or another one."""
        path = self._path(step)
        try:
            payload = torch.load(path, map_location=map_location,
                                 weights_only=True)
        except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
            raise ValueError(f"checkpoint {path} is not readable (corrupt, "
                             "or not written by this package)") from e
        v = payload.get("layout_version") if isinstance(payload, dict) \
            else None
        if v is None:
            raise ValueError(
                f"checkpoint {path} has no layout_version (pre-"
                f"v{LAYOUT_VERSION} geometry layout, or corrupt); re-create "
                "it from current scene data")
        if int(v) != LAYOUT_VERSION:
            raise ValueError(
                f"checkpoint {path} uses geometry layout v{int(v)}, this "
                f"build expects v{LAYOUT_VERSION} (triangle rows: absolute "
                "vertices in data2/data3)")
        return payload

    def restore_latest(self, map_location=None):
        """Returns (params, opt_state, step) or None if nothing saved."""
        step = self.latest_step()
        if step is None:
            return None
        r = self.restore(step, map_location)
        return r["params"], r["opt_state"], int(r["step"])


def save_render_state(directory: str, accum_xyz, sample_count: int):
    """Persist the progressive-render state (accumulator + counter); the
    checkpoint step IS the sample counter."""
    Checkpointer(directory).save(int(sample_count), {"accum_xyz": accum_xyz})


def load_render_state(directory: str, map_location=None):
    """Returns (accum_xyz, sample_count) or None."""
    ck = Checkpointer(directory)
    step = ck.latest_step()
    if step is None:
        return None
    r = ck.restore(step, map_location)
    return r["params"]["accum_xyz"], step
