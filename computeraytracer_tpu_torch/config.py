"""Typed render configuration (port of computeraytracer_tpu/config.py).

Material enums and spectral constants are the JAX package's, value for
value. ``TrainConfig`` arrives with the training slice.
"""

from __future__ import annotations

import dataclasses

# Material enums (the reference's typeIndexPairs).
DIFFUSE = 0
LIGHT = 1
GLASS = 2
MIRROR = 3  # extension: perfect specular reflector

# Spectral constants.
LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0
N_LAMBDA = 301  # 1nm resampling, 400..700 inclusive
N_HERO = 4  # hero-wavelength: 4 wavelengths per path
CIE_OFFSET = 40  # CIE tables start at 360nm; index 40 == 400nm
CIE_N = 471  # 360..830nm at 1nm
CIE_Y_INTEG = 106.856895  # normalization constant

# Sub-pixel jitter strata.
GRID_SIZE = 16


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render.

    Same fields as the JAX package's RenderConfig, except that ``kernel``
    defaults to "pallas" (the hand-written forward kernel): the eager
    "xla" tracer is not ported yet, so it is the only kernel that runs.
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 8
    # Russian roulette from depth > rr_start.
    rr_start: int = 1
    # "pallas": the forward megakernel (CUDA on the card, its plain torch
    # version for CPU tensors). "xla" raises until the eager tracer lands.
    kernel: str = "pallas"
    # Ray-batch chunk for memory control (0 = whole image at once).
    ray_chunk: int = 0
    # Starting sample index (progressive rendering / resume).
    first_sample: int = 1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
