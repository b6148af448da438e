"""Ray-primitive hit records and the analytic quadric tests.

The port of the JAX package's ``ops/intersect.py`` for what the ported
paths use (reference src/shapes/sphere.rs, cylinder.rs, disk.rs): the
partial sphere, cylinder and disk (annulus) in object space, each hit
point reprojected onto its surface.  The triangle tests live in
``ops/watertight.py`` and the kernels of ``ops/intersect_kernel.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import vecmath as vm

BIG_T = np.float32(1e30)  # "no quadric hit yet" distance


class TriHit(NamedTuple):
    valid: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) t of the hit, t_max where none
    tri: torch.Tensor  # (R,) int32 triangle index or -1
    b0: torch.Tensor  # (R,) barycentric of p0
    b1: torch.Tensor  # (R,)


class QuadricHit(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    p_obj: torch.Tensor  # (..., 3) object-space hit point, reprojected
    phi: torch.Tensor


def _sphere_quadratic(o, d, radius):
    a = vm.dot(d, d)
    b = 2.0 * vm.dot(o, d)
    c = vm.dot(o, o) - radius * radius
    return vm.quadratic(a, b, c)


def intersect_sphere(o, d, t_max, radius, z_min, z_max, phi_max) -> QuadricHit:
    """Object-space partial-sphere test (sphere.rs): the nearer root that
    lies in (0, t_max) and inside the z and phi clip.  o, d: (..., 3);
    the rest broadcast against (...)."""

    def reproject(t):
        p = o + t[..., None] * d
        # back onto the surface, against accumulated error (sphere.rs)
        p = p * (radius / torch.clamp(vm.length(p), min=1e-20))[..., None]
        # away from the phi singularity at the poles
        px = torch.where((p[..., 0] == 0.0) & (p[..., 1] == 0.0), 1e-5 * radius, p[..., 0])
        return torch.stack([px, p[..., 1], p[..., 2]], -1)

    def shape_test(p):
        phi = torch.atan2(p[..., 1], p[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * np.pi, phi)
        return (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max), phi

    has, t0, t1 = _sphere_quadratic(o, d, radius)
    p0 = reproject(t0)
    ok0, phi0 = shape_test(p0)
    ok0 = ok0 & has & (t0 > 0.0) & (t0 < t_max)
    p1 = reproject(t1)
    ok1, phi1 = shape_test(p1)
    ok1 = ok1 & has & (t1 > 0.0) & (t1 < t_max)
    valid = ok0 | ok1
    t = torch.where(ok0, t0, t1)
    p = torch.where(ok0[..., None], p0, p1)
    phi = torch.where(ok0, phi0, phi1)
    return QuadricHit(valid, torch.where(valid, t, t_max), p, phi)



def _phi(p):
    phi = torch.atan2(p[..., 1], p[..., 0])
    return torch.where(phi < 0.0, phi + 2.0 * np.pi, phi)


def intersect_cylinder(o, d, t_max, radius, z_min, z_max, phi_max) -> QuadricHit:
    """Object-space cylinder test (cylinder.rs): the quadratic in x and y,
    the nearer root in (0, t_max) inside the z and phi clip, its point
    reprojected radially onto the cylinder."""
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - radius * radius
    has, t0, t1 = vm.quadratic(a, b, c)

    def at(t):
        p = o + t[..., None] * d
        scale = radius / torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 1] ** 2, min=1e-20))
        p = torch.stack([p[..., 0] * scale, p[..., 1] * scale, p[..., 2]], -1)
        phi = _phi(p)
        return p, phi, (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)

    p0, phi0, ok0 = at(t0)
    ok0 = ok0 & has & (t0 > 0.0) & (t0 < t_max)
    p1, phi1, ok1 = at(t1)
    ok1 = ok1 & has & (t1 > 0.0) & (t1 < t_max)
    valid = ok0 | ok1
    t = torch.where(ok0, t0, t1)
    p = torch.where(ok0[..., None], p0, p1)
    phi = torch.where(ok0, phi0, phi1)
    return QuadricHit(valid, torch.where(valid, t, t_max), p, phi)


def intersect_disk(o, d, t_max, height, radius, inner_radius, phi_max) -> QuadricHit:
    """Object-space disk test (disk.rs): the plane z = height, inside the
    annulus and the phi clip.  The hit point lies exactly on the plane (a
    point off it by an ulp lets shadow rays from it hit the disk again)."""
    dz = d[..., 2]
    t = (height - o[..., 2]) / torch.where(dz == 0.0, 1.0, dz)
    p = o + t[..., None] * d
    p = torch.stack([p[..., 0], p[..., 1], torch.zeros_like(t) + height], -1)
    dist2 = p[..., 0] ** 2 + p[..., 1] ** 2
    phi = _phi(p)
    valid = ((dz != 0.0) & (t > 0.0) & (t < t_max) & (dist2 <= radius * radius)
             & (dist2 >= inner_radius * inner_radius) & (phi <= phi_max))
    return QuadricHit(valid, torch.where(valid, t, t_max), p, phi)
