"""4x4 transforms.

Construction is host-side numpy (a scene or camera is assembled on the host
and handed to the device once); application works on torch tensors with
leading batch dims.  The port's copy of the JAX package's
``utils/transform.py`` (reference src/core/transform.rs)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .vecmath import gamma


class Transform(NamedTuple):
    m: np.ndarray  # (4,4) f32 forward
    m_inv: np.ndarray  # (4,4) f32 inverse


def identity() -> Transform:
    return Transform(np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))


def from_matrix(m) -> Transform:
    m64 = np.asarray(m, np.float64)
    return Transform(m64.astype(np.float32), np.linalg.inv(m64).astype(np.float32))


def inverse(t: Transform) -> Transform:
    return Transform(t.m_inv, t.m)


def compose(a: Transform, b: Transform) -> Transform:
    """a ∘ b (apply b first)."""
    return Transform(a.m @ b.m, b.m_inv @ a.m_inv)


def translate(delta) -> Transform:
    d = np.asarray(delta, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -d
    return Transform(m, mi)


def scale(sx, sy, sz) -> Transform:
    m = np.diag(np.array([sx, sy, sz, 1.0], np.float32))
    mi = np.diag(np.array([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0], np.float32))
    return Transform(m, mi)


def rotate_x(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return Transform(m, m.T.copy())


def rotate_y(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return Transform(m, m.T.copy())


def rotate_z(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return Transform(m, m.T.copy())


def rotate(deg, axis) -> Transform:
    """Rotation by deg degrees about an arbitrary axis (transform.rs rotate),
    built in f64 and rounded to f32."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    m = m.astype(np.float32)
    return Transform(m, m.T.copy())


def look_at(eye, look, up) -> Transform:
    """Camera-to-world (transform.rs look_at)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    rn = np.linalg.norm(right)
    if rn < 1e-9:
        raise ValueError("look_at: up and viewing direction are parallel")
    right /= rn
    new_up = np.cross(d, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = d
    c2w[:3, 3] = eye
    c2w = c2w.astype(np.float32)
    return Transform(c2w, np.linalg.inv(c2w.astype(np.float64)).astype(np.float32))


def perspective(fov_deg, znear, zfar) -> Transform:
    """Perspective projection (transform.rs perspective)."""
    persp = np.zeros((4, 4), np.float32)
    persp[0, 0] = persp[1, 1] = 1.0
    persp[2, 2] = zfar / (zfar - znear)
    persp[2, 3] = -zfar * znear / (zfar - znear)
    persp[3, 2] = 1.0
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return compose(scale(inv_tan, inv_tan, 1.0), from_matrix(persp))


def orthographic(znear, zfar) -> Transform:
    """Orthographic projection (transform.rs orthographic)."""
    return compose(scale(1.0, 1.0, 1.0 / (zfar - znear)), translate([0.0, 0.0, -znear]))


def _rows(m: torch.Tensor, v: torch.Tensor, n_rows: int) -> list:
    """m[..., i, :3] . v for rows i < n_rows, as elementwise sums (no BLAS,
    so the card and the CPU add in the same order).  m: (..., 4, 4),
    broadcast against v's leading dims."""
    x, y, z = v.unbind(-1)
    return [m[..., i, 0] * x + m[..., i, 1] * y + m[..., i, 2] * z for i in range(n_rows)]


def xform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) matrices to (..., 3) points, with the homogeneous
    divide."""
    r = _rows(m, p, 4)
    w = r[3] + m[..., 3, 3]
    return torch.stack([(r[i] + m[..., i, 3]) / w for i in range(3)], -1)


def xform_point_with_error(m: torch.Tensor, p: torch.Tensor):
    """Point transform and its absolute error bound (transform.rs:662-700)."""
    am = m.abs()
    rows = _rows(am, p.abs(), 3)
    err = torch.stack([rows[i] + am[..., i, 3] for i in range(3)], -1)
    return xform_point(m, p), float(gamma(3.0)) * err


def xform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rows(m, v, 3), -1)


def xform_normal(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals transform by the inverse transpose: m_inv[..., :3, :3]^T n."""
    x, y, z = n.unbind(-1)
    return torch.stack([m_inv[..., 0, i] * x + m_inv[..., 1, i] * y + m_inv[..., 2, i] * z
                        for i in range(3)], -1)


def swaps_handedness(m: torch.Tensor) -> torch.Tensor:
    """det of the upper 3x3 < 0 (transform.rs), by cofactors."""
    a = m[..., :3, :3]
    det = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
           - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
           + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))
    return det < 0.0
