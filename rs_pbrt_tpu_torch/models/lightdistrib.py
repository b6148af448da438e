"""Spatial light selection: a light distribution for each voxel of the scene.

The port of the JAX package's ``models/lightdistrib.py`` (reference
src/core/lightdistrib.rs).  The reference fills a hash table of per-voxel
distributions lazily; here, as in the JAX package, every voxel's
distribution is estimated up front in one pass on the scene's device
(``build_spatial``, plain PyTorch through ``lights.sample_li``), and a
lookup indexes the voxel's rows (``lookup``), which the batched
``ops/sampling`` functions take.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lowdiscrepancy as ld
from ..ops import sampling as smp
from ..scene import arrays as sa
from . import lights as lt

# the reference's per-voxel estimate: this many points a voxel
# (lightdistrib.rs:169-239), on at most this many voxels along the longest axis
N_SAMPLES = 128
MAX_VOXELS = 64


class SpatialDistrib(NamedTuple):
    func: torch.Tensor  # (V, L) per-voxel light weights
    cdf: torch.Tensor  # (V, L+1)
    func_int: torch.Tensor  # (V,)
    bounds_min: torch.Tensor  # (3,)
    inv_extent: torch.Tensor  # (3,)
    n_voxels: tuple  # (nx, ny, nz)


def scene_aabb(scene: sa.Scene):
    """The world AABB (lo, hi) of the triangles, quadrics and curve
    segments, as float32 numpy; a quadric's radius is scaled by the
    Frobenius norm of its object-to-world 3x3, a bound the JAX package
    uses."""
    pts = []
    if scene.n_tris:
        pts.append(scene.tri_attr[:scene.n_tris, sa.TA_P0:sa.TA_P0 + 9].cpu().numpy()
                   .reshape(-1, 3))
    if scene.n_spheres:
        sph = scene.sph_attr[:scene.n_spheres].cpu().numpy()
        o2w = sph[:, sa.SP_O2W:sa.SP_O2W + 16].reshape(-1, 4, 4)
        c = o2w[:, :3, 3]
        r = (sph[:, sa.SP_PARAMS] * np.linalg.norm(o2w[:, :3, :3], axis=(1, 2)))[:, None]
        pts += [c - r, c + r]
    if scene.n_curve_segs:
        from ..ops import curves as cv

        pts += list(cv.segment_boxes(scene.crv_attr.cpu().numpy()))
    if not pts:
        return np.zeros(3, np.float32), np.ones(3, np.float32)
    allp = np.concatenate(pts, 0)
    return allp.min(0).astype(np.float32), allp.max(0).astype(np.float32)


def _voxel_contrib(scene: sa.Scene, p0: torch.Tensor, p1: torch.Tensor,
                   n_samples: int) -> torch.Tensor:
    """(V, L) contribution of each light to voxels p0..p1 (V, 3): the sum of
    luminance / pdf of one light sample at each of n_samples Halton points of
    the voxel (lightdistrib.rs:169-239)."""
    V, dev = p0.shape[0], p0.device
    idx = torch.arange(n_samples, dtype=torch.int64, device=dev)
    hp = torch.stack([ld.radical_inverse(k, idx) for k in range(3)], -1)  # (S, 3)
    u2 = torch.stack([ld.radical_inverse(k, idx) for k in (3, 4)], -1)  # (S, 2)
    po = (p0[:, None, :] + hp[None, :, :] * (p1 - p0)[:, None, :]).reshape(-1, 3)
    u = u2.repeat(V, 1)
    contrib = []
    for j in range(scene.n_lights):
        ls = lt.sample_li(scene, torch.full((po.shape[0],), j, dtype=torch.int64, device=dev),
                          po, u)
        y = 0.212671 * ls.li[:, 0] + 0.715160 * ls.li[:, 1] + 0.072169 * ls.li[:, 2]
        w = torch.where(ls.pdf > 0.0, y / torch.clamp(ls.pdf, min=1e-20), 0.0)
        contrib.append(w.reshape(V, n_samples).sum(1))
    return torch.stack(contrib, -1)


def build_spatial(scene: sa.Scene, max_voxels: int = MAX_VOXELS, n_samples: int = N_SAMPLES,
                  voxel_chunk: int = 4096) -> SpatialDistrib:
    """Every voxel's light distribution, on the scene's device: the scene's
    AABB split into up to max_voxels along its longest axis, voxel_chunk
    voxels at a time, each light's weight clamped below at 1e-3 of the
    voxel's mean (lightdistrib.rs:246-263)."""
    lo, hi = scene_aabb(scene)
    diag = np.maximum(hi - lo, 1e-6)
    nv = np.maximum(1, np.round(diag / diag.max() * max_voxels)).astype(np.int64)
    nx, ny, nz = (int(v) for v in nv)
    ii = np.arange(nx * ny * nz)
    iz, iy, ix = ii % nz, (ii // nz) % ny, ii // (nz * ny)
    f0 = np.stack([ix / nx, iy / ny, iz / nz], -1).astype(np.float32)
    f1 = np.stack([(ix + 1) / nx, (iy + 1) / ny, (iz + 1) / nz], -1).astype(np.float32)
    dev = scene.device
    p0 = torch.as_tensor(lo + f0 * diag, device=dev)
    p1 = torch.as_tensor(lo + f1 * diag, device=dev)
    func = torch.cat([_voxel_contrib(scene, p0[s:s + voxel_chunk], p1[s:s + voxel_chunk],
                                     n_samples) for s in range(0, ii.shape[0], voxel_chunk)], 0)
    avg = func.sum(-1, keepdim=True) / (n_samples * scene.n_lights)
    func = torch.maximum(func, torch.where(avg > 0.0, 1e-3 * avg, 1.0))
    dist = smp.make_distribution_1d(func)
    return SpatialDistrib(dist.func, dist.cdf, dist.func_int, torch.as_tensor(lo, device=dev),
                          torch.as_tensor(1.0 / diag, device=dev), (nx, ny, nz))


def lookup(sd: SpatialDistrib, p: torch.Tensor) -> smp.Distribution1D:
    """The distribution of the voxel that holds each point p (N, 3), one row
    a lane; points outside the AABB take the nearest voxel.  A coordinate
    converts as the JAX package's saturating float-to-int does (NaN to 0)."""
    f = (p - sd.bounds_min) * sd.inv_extent
    ix, iy, iz = (torch.nan_to_num(f[:, k] * n, nan=0.0).clamp(0, n - 1).to(torch.int64)
                  for k, n in enumerate(sd.n_voxels))
    _, ny, nz = sd.n_voxels
    vox = (ix * ny + iy) * nz + iz
    return smp.Distribution1D(sd.func[vox], sd.cdf[vox], sd.func_int[vox])
