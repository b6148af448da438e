"""4x4 transforms.

Construction is host-side numpy (a scene or camera is assembled on the host
and handed to the device once); application works on torch tensors with
leading batch dims.  The port's copy of the JAX package's
``utils/transform.py`` (reference src/core/transform.rs)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    m: np.ndarray  # (4,4) f32 forward
    m_inv: np.ndarray  # (4,4) f32 inverse


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


def _rows(m: torch.Tensor, v: torch.Tensor, n_rows: int) -> list:
    """m[i, :3] . v for rows i < n_rows, as elementwise sums (no BLAS, so
    the card and the CPU add in the same order)."""
    x, y, z = v.unbind(-1)
    return [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z for i in range(n_rows)]


def xform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) matrix to (..., 3) points, with the homogeneous divide."""
    r = _rows(m, p, 4)
    w = r[3] + m[3, 3]
    return torch.stack([(r[i] + m[i, 3]) / w for i in range(3)], -1)


def xform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rows(m, v, 3), -1)
