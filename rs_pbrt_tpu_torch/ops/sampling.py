"""Sampling warps and the piecewise-constant 1D distribution.

The port's copy of the parts of the JAX package's ``ops/sampling.py`` the
ported paths use (reference src/core/sampling.rs).  The CDF lookups index
the tables directly where the TPU needed one-hot reductions."""

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


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


UNIFORM_SPHERE_PDF = float(1.0 / (4.0 * PI))


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * float(1.0 / PI)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * np.pi * (1.0 - cos_theta_max))


def uniform_sample_cone(u: torch.Tensor, cos_theta_max) -> torch.Tensor:
    """(..., 2) uniform -> a direction in the cone of cos_theta_max about +z."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[..., 1] * 2.0 * float(PI)
    return torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], -1)


def uniform_sample_triangle(u: torch.Tensor) -> torch.Tensor:
    """(..., 2) uniform -> barycentrics (b0, b1)."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], -1)


def power_heuristic(f_pdf, g_pdf):
    """beta = 2 MIS weight with one sample each (sampling.rs:229)."""
    denom = f_pdf * f_pdf + g_pdf * g_pdf
    return torch.where(denom > 0.0, (f_pdf * f_pdf) / torch.clamp(denom, min=1e-30), 0.0)


class Distribution1D(NamedTuple):
    """A piecewise-constant distribution: func (n,), cdf (n+1,) and func_int
    () shared by every lane, or one row a lane: (N, n), (N, n+1) and (N,)
    (the spatial light distribution's per-lane lookup)."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor


def make_distribution_1d(func: torch.Tensor) -> Distribution1D:
    """Piecewise-constant distribution over the last axis of func
    (sampling.rs:17); an all-zero row falls back to the uniform one, as the
    reference does."""
    func = func.to(torch.float32).abs()
    n = func.shape[-1]
    cdf = torch.cat([func.new_zeros(func.shape[:-1] + (1,)), torch.cumsum(func / n, -1)], -1)
    func_int = cdf[..., -1]
    uniform = torch.arange(n + 1, dtype=torch.float32, device=func.device) / n
    safe = func_int[..., None] > 0.0
    cdf = torch.where(safe, cdf / torch.where(safe, func_int[..., None], 1.0), uniform)
    return Distribution1D(func, cdf, func_int)


def find_interval(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Largest i with cdf[..., i] <= u, clamped to [0, n-2] (pbrt.rs:214
    find_interval): the comparison count.  cdf (..., n) broadcasts against
    u (...)."""
    n = cdf.shape[-1]
    return torch.clamp((cdf <= u[..., None]).sum(-1) - 1, 0, n - 2)


def _read_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., idx] per lane: table is (n,), shared, or (N, n), one row a
    lane."""
    full = table.expand(idx.shape + table.shape[-1:])
    return full.gather(-1, idx.long()[..., None])[..., 0]


def bracket_cdf(cdf: torch.Tensor, u: torch.Tensor):
    """(offset, cdf[offset], cdf[offset+1]) per lane; cdf is (N, n) or (n,)."""
    o = find_interval(cdf, u)
    return o, _read_at(cdf, o), _read_at(cdf, o + 1)


def sample_distribution_1d_discrete(dist: Distribution1D, u: torch.Tensor):
    """-> (offset, pdf, remapped u) (sampling.rs:105)."""
    n = dist.func.shape[-1]
    o, c0, c1 = bracket_cdf(dist.cdf, u)
    f = _read_at(dist.func, o)
    pdf = torch.where(dist.func_int > 0.0, f / torch.clamp(dist.func_int * n, min=1e-30), 0.0)
    u_remapped = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-30), 0.0)
    return o, pdf, u_remapped


def distribution_1d_discrete_pdf(dist: Distribution1D, index: torch.Tensor) -> torch.Tensor:
    """The probability of picking entry `index` (sampling.rs:105 pdf)."""
    n = dist.func.shape[-1]
    return _read_at(dist.func, index) / torch.clamp(dist.func_int * n, min=1e-30)
