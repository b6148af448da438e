"""Sampling warps and the piecewise-constant 1D distribution.

The port's copy of the parts of the JAX package's ``ops/sampling.py`` the
slice uses (reference src/core/sampling.rs)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PI = np.float32(np.pi)


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """(..., 2) uniform -> (..., 2) point on the unit disk."""
    offset = 2.0 * u - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(
        use_x,
        float(PI / 4.0) * (oy / safe_ox),
        float(PI / 2.0) - float(PI / 4.0) * (ox / safe_oy),
    )
    out = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, out)


def power_heuristic(f_pdf, g_pdf):
    """beta = 2 MIS weight with one sample each (sampling.rs:229)."""
    denom = f_pdf * f_pdf + g_pdf * g_pdf
    return torch.where(denom > 0.0, (f_pdf * f_pdf) / torch.clamp(denom, min=1e-30), 0.0)


class Distribution1D(NamedTuple):
    func: torch.Tensor  # (n,)
    cdf: torch.Tensor  # (n+1,)
    func_int: torch.Tensor  # ()


def make_distribution_1d(func: torch.Tensor) -> Distribution1D:
    """Piecewise-constant distribution (sampling.rs:17); an all-zero
    function falls back to the uniform one, as the reference does."""
    func = func.to(torch.float32).abs()
    n = func.shape[-1]
    cdf = torch.cat([func.new_zeros(1), torch.cumsum(func / n, 0)])
    func_int = cdf[-1]
    if func_int > 0.0:
        cdf = cdf / func_int
    else:
        cdf = torch.arange(n + 1, dtype=torch.float32, device=func.device) / n
    return Distribution1D(func, cdf, func_int)
