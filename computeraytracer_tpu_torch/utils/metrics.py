"""Structured per-step render metrics (port of
computeraytracer_tpu/utils/metrics.py).

Every render loop can report throughput (paths/s), progress and extra
fields as records that print and append to JSONL. Host-side timestamps
only: the caller synchronizes the device before ``stop``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RenderMeter:
    """Accumulates path counts and wall time across steps.

    One "path" = one camera sample; each path casts about 2 rays per
    bounce (closest-hit + shadow), so rays/s ~ 2 * mean_depth * paths/s.
    """

    jsonl_path: Optional[str] = None
    total_paths: int = 0
    total_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, paths: int, **extra) -> dict:
        dt = time.perf_counter() - self._t0
        self.total_paths += paths
        self.total_seconds += dt
        rec = {
            "paths": paths,
            "seconds": round(dt, 6),
            "mpaths_per_s": round(paths / dt / 1e6, 4) if dt > 0 else None,
            **extra,
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @property
    def mpaths_per_s(self) -> float:
        if self.total_seconds == 0:
            return 0.0
        return self.total_paths / self.total_seconds / 1e6
