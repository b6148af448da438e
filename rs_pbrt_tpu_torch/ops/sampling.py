"""Sampling warps and the piecewise-constant 1D and 2D distributions.

The port's copy of the parts of the JAX package's ``ops/sampling.py`` the
ported paths use (reference src/core/sampling.rs).  The CDF lookups index
the tables directly where the TPU needed one-hot reductions.  The 2D
distribution (an environment map's importance) searches its shared tables
without a per-lane copy of a row: the marginal, like every cdf shared by
all lanes, by ``torch.searchsorted`` in ``find_interval``, the conditional
row by a fixed bisection that gathers from the flat (nv, nu+1) table
(``find_interval_rows``); both give the index of the JAX package's
``find_interval``."""

from __future__ import annotations

import math
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


def uniform_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """(..., 2) uniform -> a direction on the +z hemisphere, by area."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * float(PI) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


UNIFORM_HEMISPHERE_PDF = float(1.0 / (2.0 * PI))


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
    find_interval).  One cdf (n,) shared by every lane of u is searched by
    bisection of the sorted table, so no (N, n) comparison is made; rows
    (..., n) that broadcast against u (...) by the comparison count."""
    n = cdf.shape[-1]
    if cdf.dim() == 1:
        below = torch.searchsorted(cdf, u.contiguous(), right=True)
    else:
        below = (cdf <= u[..., None]).sum(-1)
    return torch.clamp(below - 1, 0, n - 2)


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


def find_interval_rows(table: torch.Tensor, row: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """find_interval in row `row` (N,) of table (R, n), each lane its own
    row: a bisection of ceil(log2(n - 1)) steps, each one gather from the
    flat table, so no lane's row is copied.  Each row must be
    non-decreasing, with cdf[0] <= u < cdf[n-1] (a CDF's rows)."""
    n = table.shape[-1]
    flat = table.reshape(-1)
    base = row.long() * n
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, n - 1)
    for _ in range(max(1, math.ceil(math.log2(max(n - 1, 1))))):
        mid = (lo + hi) // 2
        below = flat[base + mid] <= u
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return torch.clamp(lo, 0, n - 2)


def sample_distribution_1d_continuous(dist: Distribution1D, u: torch.Tensor):
    """-> (value in [0, 1), pdf, offset) (sampling.rs:69) of a distribution
    shared by every lane."""
    n = dist.func.shape[-1]
    o = find_interval(dist.cdf, u)
    c0, c1 = dist.cdf[o], dist.cdf[o + 1]
    denom = c1 - c0
    du = torch.where(denom > 0.0, (u - c0) / torch.where(denom > 0.0, denom, 1.0), u - c0)
    pdf = torch.where(dist.func_int > 0.0, dist.func[o] / torch.clamp(dist.func_int, min=1e-30),
                      0.0)
    return (o.to(torch.float32) + du) / n, pdf, o


class Distribution2D(NamedTuple):
    """A 2D piecewise-constant distribution (sampling.rs:150): one
    conditional distribution over u a row (stacked) and the marginal over
    the rows."""

    cond_func: torch.Tensor  # (nv, nu)
    cond_cdf: torch.Tensor  # (nv, nu+1)
    cond_func_int: torch.Tensor  # (nv,)
    marg_func: torch.Tensor  # (nv,)
    marg_cdf: torch.Tensor  # (nv+1,)
    marg_func_int: torch.Tensor  # ()


def make_distribution_2d(func: torch.Tensor) -> Distribution2D:
    """The distribution of func (nv, nu), its rows the conditionals."""
    cond = make_distribution_1d(func)
    marg = make_distribution_1d(cond.func_int)
    return Distribution2D(cond.func, cond.cdf, cond.func_int, marg.func, marg.cdf,
                          marg.func_int)


def sample_distribution_2d(dist: Distribution2D, u: torch.Tensor):
    """u (N, 2) -> (a point (N, 2) in [0, 1)^2, its pdf (N,)): the row from
    the marginal by u[:, 1], then the column from that row by u[:, 0]."""
    nu = dist.cond_func.shape[1]
    marg = Distribution1D(dist.marg_func, dist.marg_cdf, dist.marg_func_int)
    d1, pdf1, v_idx = sample_distribution_1d_continuous(marg, u[:, 1])
    u0 = u[:, 0]
    o = find_interval_rows(dist.cond_cdf, v_idx, u0)
    at = v_idx * (nu + 1) + o
    cdf = dist.cond_cdf.reshape(-1)
    c0, c1 = cdf[at], cdf[at + 1]
    denom = c1 - c0
    du = torch.where(denom > 0.0, (u0 - c0) / torch.where(denom > 0.0, denom, 1.0), 0.0)
    f = dist.cond_func.reshape(-1)[v_idx * nu + o]
    cond_int = dist.cond_func_int[v_idx]
    pdf0 = torch.where(cond_int > 0.0, f / torch.clamp(cond_int, min=1e-30), 0.0)
    d0 = (o.to(torch.float32) + du) / nu
    return torch.stack([d0, d1], -1), pdf0 * pdf1


def distribution_2d_pdf(dist: Distribution2D, p: torch.Tensor) -> torch.Tensor:
    """The pdf of points p (N, 2) in [0, 1)^2 (Distribution2D::pdf)."""
    nv, nu = dist.cond_func.shape
    iu = torch.clamp((p[:, 0] * nu).to(torch.int32), 0, nu - 1).long()
    iv = torch.clamp((p[:, 1] * nv).to(torch.int32), 0, nv - 1).long()
    return dist.cond_func[iv, iu] / torch.clamp(dist.marg_func_int, min=1e-30)
