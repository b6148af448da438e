"""Participating media: the Henyey-Greenstein phase function, homogeneous
transmittance and distance sampling, and the density grid's lookup.

The port of the JAX package's ``ops/medium.py`` (reference
src/core/medium.rs HenyeyGreenstein :297-330 and phase_hg :389,
src/media/homogeneous.rs :33-90, src/media/grid.rs density).  The grid
media's tracking loops are ``ops/medium_kernel.py``'s M1 and M2; the JAX
module's own bounded loops (``grid_sample_distance``, ``grid_tr``) are not
ported, since nothing calls them (the JAX volpath tracks with its own
``_delta_track`` and ``_ratio_track_tr``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import transform as tr
from ..utils import vecmath as vm

INV_4_PI = 1.0 / (4.0 * np.pi)


def phase_hg(cos_theta, g):
    """medium.rs:389."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def hg_sample_phase(wo, u, g):
    """A direction from the HG phase function around wo (medium.rs sample_p
    :313-330): (wi, the phase value, which is its pdf)."""
    small = g.abs() < 1e-3
    safe_g = torch.where(small, 1e-3, g)
    sqr = (1.0 - g * g) / (1.0 + safe_g - 2.0 * safe_g * u[..., 0])
    cos_theta_g = -(1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_theta = torch.where(small, 1.0 - 2.0 * u[..., 0], cos_theta_g)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * np.pi * u[..., 1]
    v1, v2 = vm.coordinate_system(wo)
    wi = ((sin_theta * torch.cos(phi))[..., None] * v1
          + (sin_theta * torch.sin(phi))[..., None] * v2 + cos_theta[..., None] * wo)
    return wi, phase_hg(cos_theta, g)


def homogeneous_tr(sigma_t, dist):
    """Beer-Lambert transmittance (homogeneous.rs:33): sigma_t (N, 3),
    dist (N,)."""
    return torch.exp(-torch.clamp(sigma_t * dist[..., None], 0.0, 80.0))


class MediumSample(NamedTuple):
    sampled: torch.Tensor  # (N,) bool: the ray scattered in the medium
    t: torch.Tensor  # (N,) the distance reached
    weight: torch.Tensor  # (N, 3) the beta factor (Tr and the pdf folded in)


def homogeneous_sample(sigma_a, sigma_s, u_channel, u_dist, t_max) -> MediumSample:
    """Distance sampling through one channel picked at random
    (homogeneous.rs:37-90).  sigma_a, sigma_s (N, 3); u_channel, u_dist,
    t_max (N,)."""
    sigma_t = sigma_a + sigma_s
    channel = torch.clamp((u_channel * 3.0).to(torch.int64), 0, 2)
    sig_c = torch.clamp(torch.gather(sigma_t, 1, channel[:, None])[:, 0], min=1e-12)
    dist = -torch.log(torch.clamp(1.0 - u_dist, min=1e-12)) / sig_c
    t = torch.minimum(dist, t_max)
    sampled = dist < t_max
    tr_ = homogeneous_tr(sigma_t, t)
    density = torch.where(sampled[:, None], sigma_t * tr_, tr_)
    pdf = torch.clamp((density[:, 0] + density[:, 1] + density[:, 2]) / 3.0, min=1e-12)
    weight = torch.where(sampled[:, None], tr_ * sigma_s / pdf[:, None], tr_ / pdf[:, None])
    return MediumSample(sampled, t, weight)


def _tap(x, n: int):
    """Voxel coordinates (float) -> int64 indices clamped to [0, n-1]; a NaN
    coordinate (a point the inside test rejects) reads voxel 0."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, n - 1).to(torch.int64)


def grid_density(grid, w2m, p, mid=None):
    """Trilinear density (grid.rs density, d) at world points p (N, 3), 0
    outside the unit medium cube.  grid (D, H, W) with w2m (4, 4) or (N, 4,
    4), as the JAX function takes them; or the scene's stacked grids (K, D,
    H, W) and w2m (K, 4, 4) with each lane's medium mid (N,), which reads
    the lane's own grid (the JAX volpath computes every grid and selects).
    The taps are summed dz, dy, dx, as the JAX function sums them."""
    D, H, W = grid.shape[-3:]
    flat = grid.reshape(-1)
    if mid is None:
        m = w2m
        base = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    else:
        mid = mid.long()
        m = w2m[mid]
        base = mid * (D * H * W)
    pm = tr.xform_point(m, p)
    gx = pm[..., 0] * W - 0.5
    gy = pm[..., 1] * H - 0.5
    gz = pm[..., 2] * D - 0.5
    inside = ((pm[..., 0] >= 0) & (pm[..., 0] < 1) & (pm[..., 1] >= 0) & (pm[..., 1] < 1)
              & (pm[..., 2] >= 0) & (pm[..., 2] < 1))
    x0, y0, z0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - x0, gy - y0, gz - z0
    acc = torch.zeros_like(gx)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = base + (_tap(z0 + dz, D) * H + _tap(y0 + dy, H)) * W + _tap(x0 + dx, W)
                wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz)
                acc = acc + wgt * flat[idx]
    return torch.where(inside, acc, 0.0)
