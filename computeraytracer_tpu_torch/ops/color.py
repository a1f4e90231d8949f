"""XYZ -> sRGB display pipeline (port of computeraytracer_tpu/ops/color.py).

XYZ -> linear sRGB (D65) 3x3, exponential tone map 1 - exp(-rgb *
exposure), and sRGB gamma with the standard 12.92 linear segment (the
reference's green-branch gamma bug is not reproduced).
"""

from __future__ import annotations

import torch

# Standard XYZ -> linear sRGB (D65) matrix.
XYZ_TO_RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)

DEFAULT_EXPOSURE = 2.2


def xyz_to_linear_rgb(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) XYZ -> (..., 3) linear sRGB, as elementwise products
    summed left to right (no matmul library, so no TF32 on the card)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([(x * a + y * b) + z * c for a, b, c in XYZ_TO_RGB],
                       dim=-1)


def tone_map(rgb: torch.Tensor, exposure: float = DEFAULT_EXPOSURE):
    """Exponential tone map: 1 - exp(-rgb * exposure)."""
    return 1.0 - torch.exp(-rgb * exposure)


def gamma_encode(rgb: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma (piecewise)."""
    lo = rgb * 12.92
    hi = 1.055 * torch.pow(torch.clamp(rgb, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(rgb < 0.0031308, lo, hi)


def xyz_to_srgb(xyz: torch.Tensor, exposure: float = DEFAULT_EXPOSURE):
    """Full display transform: XYZ -> tonemapped sRGB in [0, 1]."""
    return torch.clamp(
        gamma_encode(tone_map(xyz_to_linear_rgb(xyz), exposure)), 0.0, 1.0)
