"""The camera's half of the animated transform (reference
src/core/transform.rs:894-2204 AnimatedTransform).

The port's copy of the JAX package's ``utils/animated.py`` for what camera
motion needs: ``decompose`` (host numpy, float64) splits each shutter end's
matrix into a translation, a rotation quaternion and a scale matrix, and
``interpolate`` recomposes the matrix at each lane's time (per-lane lerp of
the translation and the scale, slerp of the quaternion).  ``motion_bounds``
and ``inverse_affine``, which animated primitives need, come with the
instancing module (ROADMAP A25).
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


def interpolate(t: torch.Tensor, T0, q0, S0, T1, q1, S1) -> torch.Tensor:
    """Per-lane (N, 4, 4) matrices at times t (N,) in [0, 1]
    (transform.rs:2104-2204).  The six parts are f32 tensors on t's device:
    T (3,), q (4,) as (x, y, z, w), S (3, 3)."""
    t = torch.clamp(t.to(torch.float32), 0.0, 1.0)
    T = (1.0 - t)[:, None] * T0 + t[:, None] * T1
    # slerp (quaternion.rs slerp), negated for the shorter arc
    cos_t = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(cos_t < 0.0, -q1, q1)
    cos_t = cos_t.abs()[0]
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    near = cos_t > 0.9995
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_t)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_t)
    q = w0[:, None] * q0 + w1[:, None] * q1
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    S = (1.0 - t)[:, None, None] * S0 + t[:, None, None] * S1
    # R @ S as elementwise sums (no BLAS), as utils/transform.py applies matrices
    M3 = torch.stack([torch.stack([R[:, i, 0] * S[:, 0, j] + R[:, i, 1] * S[:, 1, j]
                                   + R[:, i, 2] * S[:, 2, j] for j in range(3)], -1)
                      for i in range(3)], -2)
    out = torch.zeros(t.shape + (4, 4), dtype=torch.float32, device=t.device)
    out[:, :3, :3] = M3
    out[:, :3, 3] = T
    out[:, 3, 3] = 1.0
    return out
