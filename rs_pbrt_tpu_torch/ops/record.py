"""The hit record of a triangle row, plain PyTorch, and the 3-vector
helpers of the kernels' plain versions.

``tri_record`` is scene_intersect._tri_interaction of the JAX package
(reference triangle.rs:300-420) as the kernels compute it: the plain
version of ``csrc/record.cuh``, which the bounce kernel (K2) and the fused
closest-hit kernel (K5) share, term by term in the kernels' order.  The
TPU kernels fetched the row by a select-accumulate sweep over the table;
here it is one indexed read of the winning row, which never reads row -1.
Vectors are 3-tuples of (N,) tensors, as the kernels hold them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import arrays as sa
from ..utils import vecmath as vm

GAMMA7 = float(vm.gamma(7.0))
N_REC_COLS = 28  # tri_attr columns the record reads (p, n, uv, has_n, mat, light, reverse)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def where3(m, a, b):
    return tuple(torch.where(m, a[k], b[k]) for k in range(3))


def normalize(a, eps=1e-20):
    return scale(a, 1.0 / torch.sqrt(torch.clamp(dot(a, a), min=eps)))


def coordinate_system(v):
    """First axis of vecmath.coordinate_system (branch on |x| > |y|)."""
    use_a = v[0].abs() > v[1].abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(v[0] * v[0] + v[2] * v[2], min=1e-20))
    inv_b = 1.0 / torch.sqrt(torch.clamp(v[1] * v[1] + v[2] * v[2], min=1e-20))
    return (
        torch.where(use_a, -v[2] * inv_a, 0.0),
        torch.where(use_a, 0.0, v[2] * inv_b),
        torch.where(use_a, v[0] * inv_a, -v[1] * inv_b),
    )


def take(table, row, valid, col):
    """table[row, col] where valid, else 0 (rows clamped for the gather)."""
    r = torch.clamp(row, 0, table.shape[0] - 1).long()  # never read row -1
    return torch.where(valid, table[r, col], 0.0)


class TriRecord(NamedTuple):
    p: tuple
    p_err: tuple
    ng: tuple
    ns: tuple
    uv: tuple  # (u, v)
    dpdu: tuple
    mat: torch.Tensor  # (N,) int32
    light: torch.Tensor  # (N,) int32 area light id or -1


def tri_record(tris, bi, b0, b1) -> TriRecord:
    """Record of the hit at barycentrics (b0, b1) of row bi of `tris`
    ((T, N_TRI_ATTR) f32); bi < 0 reads the all-zero row."""
    valid = bi >= 0
    at = [take(tris, bi, valid, c) for c in range(N_REC_COLS)]
    p0, p1, p2 = at[sa.TA_P0:sa.TA_P0 + 3], at[sa.TA_P1:sa.TA_P1 + 3], at[sa.TA_P2:sa.TA_P2 + 3]
    n0, n1, n2 = at[sa.TA_N0:sa.TA_N0 + 3], at[sa.TA_N1:sa.TA_N1 + 3], at[sa.TA_N2:sa.TA_N2 + 3]
    uv0, uv1, uv2 = (at[sa.TA_UV0:sa.TA_UV0 + 2], at[sa.TA_UV1:sa.TA_UV1 + 2],
                     at[sa.TA_UV2:sa.TA_UV2 + 2])
    has_n_f, mat_f = at[sa.TA_HAS_N], at[sa.TA_MAT]
    light_f, rev_f = at[sa.TA_LIGHT], at[sa.TA_REVERSE]

    b2 = 1.0 - b0 - b1
    p = tuple(b0 * p0[k] + b1 * p1[k] + b2 * p2[k] for k in range(3))
    p_err = tuple(
        GAMMA7 * ((b0 * p0[k]).abs() + (b1 * p1[k]).abs() + (b2 * p2[k]).abs())
        for k in range(3)
    )
    e02 = sub(p0, p2)
    e12 = sub(p1, p2)
    ng = normalize(cross(e02, e12), 1e-30)
    ns = tuple(b0 * n0[k] + b1 * n1[k] + b2 * n2[k] for k in range(3))
    # guarded: a mesh without vertex normals interpolates ns = 0, whose
    # sqrt's backward is inf (the JAX _tri_interaction's guard)
    ns_len = torch.sqrt(torch.clamp(dot(ns, ns), min=1e-20))
    has_n = (has_n_f > 0.5) & (ns_len > 1e-8)
    inv_nsl = 1.0 / torch.clamp(ns_len, min=1e-8)
    ns = where3(has_n, scale(ns, inv_nsl), ng)
    rev = rev_f > 0.5
    ns = where3(rev, scale(ns, -1.0), ns)
    flip_ng = (has_n & (dot(ng, ns) < 0.0)) | (~has_n & rev)
    ng = where3(flip_ng, scale(ng, -1.0), ng)
    uv = tuple(b0 * uv0[k] + b1 * uv1[k] + b2 * uv2[k] for k in range(2))
    duv02 = (uv0[0] - uv2[0], uv0[1] - uv2[1])
    duv12 = (uv1[0] - uv2[0], uv1[1] - uv2[1])
    det_uv = duv02[0] * duv12[1] - duv02[1] * duv12[0]
    inv_det_uv = torch.where(
        det_uv.abs() < 1e-12, 0.0, 1.0 / torch.where(det_uv == 0.0, 1.0, det_uv)
    )
    dpdu = tuple((duv12[1] * e02[k] - duv02[1] * e12[k]) * inv_det_uv for k in range(3))
    dpdu = where3(dot(dpdu, dpdu) < 1e-16, coordinate_system(ng), dpdu)
    mat = (mat_f + 0.5).to(torch.int32)
    light = (light_f + torch.where(light_f < 0.0, -0.5, 0.5)).to(torch.int32)
    return TriRecord(p, p_err, ng, ns, uv, dpdu, mat, light)
