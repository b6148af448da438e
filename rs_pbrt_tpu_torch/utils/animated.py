"""The animated transform (reference src/core/transform.rs:894-2281
AnimatedTransform), for camera motion and animated triangle meshes.

The port's copy of the JAX package's ``utils/animated.py``: ``decompose``
(host numpy, float64) splits each shutter end's matrix into a translation,
a rotation quaternion and a scale matrix; ``interpolate`` recomposes the
matrix at each lane's time (per-lane lerp of the translation and the
scale, slerp of the quaternion); ``motion_bounds`` (host numpy) bounds a
mesh's points over the whole shutter for the world bound; and
``inverse_affine`` inverts the interpolated matrices per lane, which
carries rays into a moving mesh's object space.  ``interpolate`` and
``inverse_affine`` spell out every sum term by term, left to right, as the
moving-mesh kernel V1 (``csrc/motion.cu``) computes them.
"""

from __future__ import annotations

import numpy as np
import torch


def _quat_from_matrix(m):
    """Rotation matrix (3,3) -> quaternion (x,y,z,w) (quaternion.rs)."""
    tr = np.trace(m)
    if tr > 0.0:
        s = np.sqrt(tr + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array(
            [(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s, w]
        )
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - (m[j, j] + m[k, k]) + 1.0, 1e-12))
    q = np.zeros(4)
    q[i] = s * 0.5
    s = 0.5 / s
    q[3] = (m[k, j] - m[j, k]) * s
    q[j] = (m[j, i] + m[i, j]) * s
    q[k] = (m[k, i] + m[i, k]) * s
    return q


def decompose(m):
    """(4,4) -> (T (3,), quat (4,), S (3,3)) f32 (transform.rs:2032-2100):
    polar decomposition by iterated averaging with the inverse transpose,
    in float64."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        R_next = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(R_next - R).max() < 1e-10:
            R = R_next
            break
        R = R_next
    q = _quat_from_matrix(R)
    S = np.linalg.inv(R) @ M
    return T.astype(np.float32), q.astype(np.float32), S.astype(np.float32)


def _dot4(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
            + a[..., 3] * b[..., 3])


def interpolate(t: torch.Tensor, T0, q0, S0, T1, q1, S1) -> torch.Tensor:
    """Matrices (..., 4, 4) at times t (...,), clipped to [0, 1]
    (transform.rs:2104-2204).  The six parts are f32 tensors on t's device
    that broadcast against t: T (..., 3), q (..., 4) as (x, y, z, w), S
    (..., 3, 3); a camera's are one set (shapes (3,), (4,), (3, 3)), a
    moving mesh's one set a group."""
    t = torch.clamp(t.to(torch.float32), 0.0, 1.0)
    T = (1.0 - t)[..., None] * T0 + t[..., None] * T1
    # slerp (quaternion.rs slerp), negated for the shorter arc
    cos_t = _dot4(q0, q1)[..., None]
    q1 = torch.where(cos_t < 0.0, -q1, q1)
    cos_t = cos_t.abs()[..., 0]
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    near = cos_t > 0.9995
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_t)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_t)
    q = w0[..., None] * q0 + w1[..., None] * q1
    q = q / torch.clamp(torch.sqrt(_dot4(q, q)), min=1e-12)[..., None]
    x, y, z, w = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    S = (1.0 - t)[..., None, None] * S0 + t[..., None, None] * S1
    # R @ S as elementwise sums (no BLAS), as utils/transform.py applies matrices
    M3 = torch.stack([torch.stack([R[..., i, 0] * S[..., 0, j] + R[..., i, 1] * S[..., 1, j]
                                   + R[..., i, 2] * S[..., 2, j] for j in range(3)], -1)
                      for i in range(3)], -2)
    out = torch.zeros(M3.shape[:-2] + (4, 4), dtype=torch.float32, device=t.device)
    out[..., :3, :3] = M3
    out[..., :3, 3] = T
    out[..., 3, 3] = 1.0
    return out


def xf_parts(xf: torch.Tensor) -> tuple:
    """The six parts (T0, q0, S0, T1, q1, S1) of rows of a moving mesh's
    packed transforms (..., 32) (scene.anim_xf: T0 3, q0 4, S0 9, then the
    shutter's close)."""
    return (xf[..., 0:3], xf[..., 3:7], xf[..., 7:16].reshape(xf.shape[:-1] + (3, 3)),
            xf[..., 16:19], xf[..., 19:23], xf[..., 23:32].reshape(xf.shape[:-1] + (3, 3)))


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def motion_bounds(T0, q0, S0, T1, q1, S1, points):
    """Conservative AABB (lo, hi) f32 of `points` (N, 3) under the animated
    transform over the whole t in [0, 1] (host numpy, float64; the JAX
    package's closed-form bound for transform.rs:2207-2281 motion_bounds):
    the union of the end positions padded by theta (d0 + d1) / 4 per point,
    theta the relative rotation's angle and d the point's distance from
    its axis, which holds the slerp's arc."""
    P = np.asarray(points, np.float64).reshape(-1, 3)
    T0 = np.asarray(T0, np.float64)
    T1 = np.asarray(T1, np.float64)
    S0 = np.asarray(S0, np.float64).reshape(3, 3)
    S1 = np.asarray(S1, np.float64).reshape(3, 3)
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    v0 = P @ S0.T
    v1 = P @ S1.T
    x0 = v0 @ _quat_to_mat_np(q0).T + T0
    x1 = v1 @ _quat_to_mat_np(q1).T + T1
    # relative rotation q0^-1 q1 (x, y, z, w), shortest arc
    x0q, y0q, z0q, w0q = -q0[0], -q0[1], -q0[2], q0[3]  # conjugate
    x1q, y1q, z1q, w1q = q1
    qd = np.array([
        w0q * x1q + x0q * w1q + y0q * z1q - z0q * y1q,
        w0q * y1q - x0q * z1q + y0q * w1q + z0q * x1q,
        w0q * z1q + x0q * y1q - y0q * x1q + z0q * w1q,
        w0q * w1q - x0q * x1q - y0q * y1q - z0q * z1q,
    ])
    if qd[3] < 0.0:
        qd = -qd
    theta = 2.0 * np.arccos(np.clip(qd[3], -1.0, 1.0))
    an = np.linalg.norm(qd[:3])
    axis = qd[:3] / an if an > 1e-12 else np.array([0.0, 0.0, 1.0])
    dist = lambda v: np.linalg.norm(v - np.outer(v @ axis, axis), axis=-1)
    pad = (0.25 * theta * (dist(v0) + dist(v1)))[:, None]
    lo = np.minimum(x0 - pad, x1 - pad).min(0)
    hi = np.maximum(x0 + pad, x1 + pad).max(0)
    return lo.astype(np.float32), hi.astype(np.float32)


def inverse_affine(m: torch.Tensor) -> torch.Tensor:
    """Inverses of affine matrices (..., 4, 4): the 3x3 block by cofactors
    (a determinant below 1e-20 in size divides by 1), the translation by
    -A^-1 t (the JAX inverse_affine; an interpolated matrix must invert per
    lane, where a static one keeps its inverse)."""
    a = lambda i, j: m[..., i, j]
    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1.0, det)
    adj = (
        (c00, a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2), a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)),
        (c01, a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0), a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)),
        (c02, a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1), a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)),
    )
    inv = [[c * inv_det for c in row] for row in adj]
    out = torch.zeros_like(m)
    for i in range(3):
        for j in range(3):
            out[..., i, j] = inv[i][j]
        out[..., i, 3] = -(inv[i][0] * a(0, 3) + inv[i][1] * a(1, 3) + inv[i][2] * a(2, 3))
    out[..., 3, 3] = 1.0
    return out
