"""Vector math on torch tensors with a trailing xyz axis.

The port's copy of the JAX package's ``utils/vecmath.py`` for the parts the
slice uses (reference src/core/geometry.rs, pbrt.rs, interaction.rs)."""

from __future__ import annotations

import numpy as np
import torch

ONE_MINUS_EPSILON = np.float32(1.0 - np.finfo(np.float32).eps / 2)
MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps / 2)
DENORM_MIN = np.float32(1e-45)  # smallest positive f32 (0x00000001)
INFINITY = np.float32(np.finfo(np.float32).max)  # "no limit" ray length
INV_PI = np.float32(1.0 / np.pi)


def gamma(n):
    """FP error bound (reference pbrt.rs:94), evaluated in f32."""
    return (n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)


def dot(a, b):
    return (a * b).sum(-1)


def absdot(a, b):
    return dot(a, b).abs()


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=1e-30))


def normalize(v):
    return v / torch.clamp(length(v), min=1e-20)[..., None]


def face_forward(n, v):
    """Flip n into the hemisphere of v (geometry.rs)."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def quadratic(a, b, c):
    """Stable quadratic solve -> (has_solution, t0, t1), t0 <= t1.  f32
    with the b/2 form, as the JAX package computes it (the reference's
    discriminant is f64, pbrt.rs:250)."""
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1.0, a)
    t1 = c / torch.where(q == 0.0, 1.0, q)
    return has, torch.minimum(t0, t1), torch.maximum(t0, t1)


def coordinate_system(v1):
    """Orthonormal frame around unit v1 (geometry.rs branch on |x| > |y|)."""
    x, y, z = v1.unbind(-1)
    inv_a = 1.0 / torch.sqrt(torch.clamp(x * x + z * z, min=1e-20))
    inv_b = 1.0 / torch.sqrt(torch.clamp(y * y + z * z, min=1e-20))
    zero = torch.zeros_like(x)
    v2a = torch.stack([-z * inv_a, zero, x * inv_a], -1)
    v2b = torch.stack([zero, z * inv_b, -y * inv_b], -1)
    v2 = torch.where((x.abs() > y.abs())[..., None], v2a, v2b)
    return v2, cross(v1, v2)


def next_float_up(x):
    """Next f32 toward +inf (pbrt.rs:61)."""
    xi = x.view(torch.int32)
    out = torch.where(x >= 0.0, xi + 1, xi - 1).view(torch.float32)
    out = torch.where(x == 0.0, torch.full_like(x, DENORM_MIN), out)
    return torch.where(torch.isinf(x) & (x > 0), x, out)


def next_float_down(x):
    xi = x.view(torch.int32)
    out = torch.where(x > 0.0, xi - 1, xi + 1).view(torch.float32)
    out = torch.where(x == 0.0, torch.full_like(x, -DENORM_MIN), out)
    return torch.where(torch.isinf(x) & (x < 0), x, out)


def offset_ray_origin(p, p_error, n, w):
    """Robust ray-origin offset (interaction.rs:62-95)."""
    d = dot(n.abs(), p_error)
    offset = d[..., None] * n
    offset = torch.where((dot(w, n) < 0.0)[..., None], -offset, offset)
    po = p + offset
    return torch.where(
        offset > 0.0, next_float_up(po),
        torch.where(offset < 0.0, next_float_down(po), po),
    )
