"""Cubic Bézier curves (hair): the build-time flattening, the leaf test and
the plain versions of the curve intersection kernels.

The port of the JAX package's ``ops/curves.py`` (reference
src/shapes/curve.rs).  The reference subdivides each curve per ray down to
an adaptive depth; here, as in the JAX package, every curve is blossomed to
that depth once, on the host (``flatten_curves``), and the render-time
test is the reference's leaf test (curve.rs:215-343) for each (ray,
segment) pair (``curve_seg_test``).  Segments are packed as rows of
``scene/arrays.py``'s CV_* columns (``pack_curve_attr``).

Two routes find a ray's nearest segment, as in the JAX package
(scene_intersect.py:304-307): up to ``scene_intersect.BRUTE_FORCE_MAX_CURVES``
segments the all-pairs sweep (``intersect_curves_plain``: C3, its any hit
C4), above it the walk through a binary SAH tree over the segments' boxes
(``bvh_intersect_curves_plain``: C1, its any hit C2).  These are the plain
versions of the CUDA kernels of ``csrc/curves.cu`` (``ops/curve_kernel.py``
launches them); the leaf test is written here term by term in the order of
``csrc/curve.cuh``, so the kernels give these functions' bits.  3-vectors
are 3-tuples of tensors, as the kernels hold them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene.arrays import (CV_CP, CV_INV_SIN_NA, CV_MAT, CV_N0, CV_N1, CV_NORM_ANGLE,
                            CV_TYPE, CV_U0, CV_U1, CV_W0, CV_W1, N_CURVE_ATTR)
from ..utils import vecmath as vm

FLAT = 0
CYLINDER = 1
RIBBON = 2

STACK_DEPTH = 64  # the walk's stack entries (the JAX bvh.STACK_DEPTH, bvh.rs:420)
SLAB_EPS = float(np.float32(1.0 + 2.0 * vm.gamma(3.0)))
SWEEP_PAIRS = 1 << 22  # (ray, segment) pairs the plain sweep tests at once


# ---------------------------------------------------------------------------
# host build: blossom curves to leaf segments (numpy)
# ---------------------------------------------------------------------------


def _blossom_np(cp, u0, u1, u2):
    """Bézier blossom (curve.rs:631): cp (..., 4, 3), u arrays."""
    a0 = cp[..., 0, :] + (cp[..., 1, :] - cp[..., 0, :]) * u0[..., None]
    a1 = cp[..., 1, :] + (cp[..., 2, :] - cp[..., 1, :]) * u0[..., None]
    a2 = cp[..., 2, :] + (cp[..., 3, :] - cp[..., 2, :]) * u0[..., None]
    b0 = a0 + (a1 - a0) * u1[..., None]
    b1 = a1 + (a2 - a1) * u1[..., None]
    return b0 + (b1 - b0) * u2[..., None]


def _segment_cps_np(cp, u0, u1):
    """Control points of the sub-curve over [u0, u1] (curve.rs:346-356)."""
    return np.stack([_blossom_np(cp, u0, u0, u0), _blossom_np(cp, u0, u0, u1),
                     _blossom_np(cp, u0, u1, u1), _blossom_np(cp, u1, u1, u1)], axis=-2)


def adaptive_depth_np(cp, width0, width1):
    """The reference's refinement depth (curve.rs:449-466) at build time:
    L0 the largest L2 norm of a second difference, eps = max width / 20,
    depth = clamp(log4(sqrt(2) 6 L0 / (8 eps)), 0, 10)."""
    d2 = cp[..., 0:2, :] - 2.0 * cp[..., 1:3, :] + cp[..., 2:4, :]
    l0 = np.sqrt((d2 ** 2).sum(-1)).max(-1)
    eps = np.maximum(np.maximum(width0, width1) * 0.05, 1e-12)
    x = np.maximum(1.41421356 * 6.0 * l0 / (8.0 * eps), 1e-12)
    r0 = (np.log2(x) / 2.0).astype(np.int32)
    return np.clip(r0, 0, 10)


def flatten_curves(cps, width0, width1, ctype, n0=None, n1=None, splitdepth=3,
                   max_total_depth=10):
    """N curves -> M leaf segments (host numpy).  cps (N, 4, 3) in world
    space; width0, width1, ctype (N,); n0, n1 (N, 3) ribbon normals or None;
    splitdepth: the reference's per-curve segment count exponent
    (curve.rs:119), to which the adaptive depth is added.  Returns a dict of
    segment arrays and their boxes."""
    cps = np.asarray(cps, np.float32).reshape(-1, 4, 3)
    n = cps.shape[0]
    width0 = np.broadcast_to(np.asarray(width0, np.float32), (n,))
    width1 = np.broadcast_to(np.asarray(width1, np.float32), (n,))
    ctype = np.broadcast_to(np.asarray(ctype, np.int32), (n,))
    if n0 is None:
        n0 = np.zeros((n, 3), np.float32)
        n1 = np.zeros((n, 3), np.float32)
    else:
        n0 = np.asarray(n0, np.float32).reshape(n, 3)
        n1 = np.asarray(n1, np.float32).reshape(n, 3)

    depth = np.minimum(adaptive_depth_np(cps, width0, width1) + splitdepth, max_total_depth)
    n_segs = (1 << depth).astype(np.int64)
    total = int(n_segs.sum())
    curve_of = np.repeat(np.arange(n), n_segs)
    seg_in_curve = np.arange(total) - np.repeat(np.cumsum(n_segs) - n_segs, n_segs)
    inv = 1.0 / n_segs[curve_of].astype(np.float32)
    u0 = seg_in_curve.astype(np.float32) * inv
    u1 = (seg_in_curve + 1).astype(np.float32) * inv

    seg_cp = _segment_cps_np(cps[curve_of], u0, u1).astype(np.float32)  # (M, 4, 3)
    w_par0 = width0[curve_of]
    w_par1 = width1[curve_of]
    w0 = w_par0 + (w_par1 - w_par0) * u0
    w1 = w_par0 + (w_par1 - w_par0) * u1

    # ribbon normals at the segment ends by the parent's slerp (curve.rs:256-263)
    pn0 = n0[curve_of]
    pn1 = n1[curve_of]
    ang = np.arccos(np.clip((pn0 * pn1).sum(-1), 0.0, 1.0))
    inv_sin = np.where(ang > 1e-6, 1.0 / np.maximum(np.sin(ang), 1e-12), 0.0)

    def slerp_n(u):
        s0 = np.where(ang > 1e-6, np.sin((1.0 - u) * ang) * inv_sin, 1.0 - u)
        s1 = np.where(ang > 1e-6, np.sin(u * ang) * inv_sin, u)
        v = s0[:, None] * pn0 + s1[:, None] * pn1
        return v / np.maximum(np.sqrt((v ** 2).sum(-1, keepdims=True)), 1e-12)

    sn0 = slerp_n(u0).astype(np.float32)
    sn1 = slerp_n(u1).astype(np.float32)
    sang = np.arccos(np.clip((sn0 * sn1).sum(-1), 0.0, 1.0)).astype(np.float32)
    sinv = np.where(sang > 1e-6, 1.0 / np.maximum(np.sin(sang), 1e-12), 0.0).astype(np.float32)

    half_w = (np.maximum(w0, w1) * 0.5)[:, None].astype(np.float32)
    return dict(
        crv_cp=seg_cp, crv_w0=w0.astype(np.float32), crv_w1=w1.astype(np.float32),
        crv_u0=u0.astype(np.float32), crv_u1=u1.astype(np.float32), crv_n0=sn0, crv_n1=sn1,
        crv_norm_angle=sang, crv_inv_sin_na=sinv, crv_type=ctype[curve_of].astype(np.int32),
        crv_curve_id=curve_of.astype(np.int32),
        bmin=(seg_cp.min(axis=1) - half_w).astype(np.float32),
        bmax=(seg_cp.max(axis=1) + half_w).astype(np.float32),
    )


def pack_curve_attr(arrs, mat_ids):
    """The flattened segments and their material ids as (M, N_CURVE_ATTR)
    f32 rows."""
    m = arrs["crv_cp"].shape[0]
    at = np.zeros((m, N_CURVE_ATTR), np.float32)
    at[:, CV_CP:CV_CP + 12] = arrs["crv_cp"].reshape(m, 12)
    at[:, CV_W0] = arrs["crv_w0"]
    at[:, CV_W1] = arrs["crv_w1"]
    at[:, CV_U0] = arrs["crv_u0"]
    at[:, CV_U1] = arrs["crv_u1"]
    at[:, CV_N0:CV_N0 + 3] = arrs["crv_n0"]
    at[:, CV_N1:CV_N1 + 3] = arrs["crv_n1"]
    at[:, CV_NORM_ANGLE] = arrs["crv_norm_angle"]
    at[:, CV_INV_SIN_NA] = arrs["crv_inv_sin_na"]
    at[:, CV_TYPE] = arrs["crv_type"]
    at[:, CV_MAT] = np.asarray(mat_ids, np.float32)
    return at


def segment_boxes(crv_attr: np.ndarray):
    """(bmin, bmax) (M, 3) of segment rows: the control points' box grown by
    half the larger width (the JAX scene_intersect.build_accel)."""
    at = np.asarray(crv_attr, np.float32)
    cp = at[:, CV_CP:CV_CP + 12].reshape(-1, 4, 3)
    hw = np.maximum(at[:, CV_W0], at[:, CV_W1])[:, None] * 0.5
    return cp.min(1) - hw, cp.max(1) + hw


# ---------------------------------------------------------------------------
# the leaf test (plain PyTorch, csrc/curve.cuh's order)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _normalize(a):
    """vecmath.normalize: a / max(sqrt(max(|a|^2, 1e-30)), 1e-20)."""
    ln = torch.clamp(torch.sqrt(torch.clamp(_dot(a, a), min=1e-30)), min=1e-20)
    return (a[0] / ln, a[1] / ln, a[2] / ln)


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _clip(x, lo, hi):
    """jnp.clip's min(max(x, lo), hi), NaN propagated."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _coordinate_axis(v):
    """The first axis of vecmath.coordinate_system (branch on |x| > |y|)."""
    use_a = v[0].abs() > v[1].abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(v[0] * v[0] + v[2] * v[2], min=1e-20))
    inv_b = 1.0 / torch.sqrt(torch.clamp(v[1] * v[1] + v[2] * v[2], min=1e-20))
    zero = torch.zeros_like(inv_a)
    return (torch.where(use_a, -v[2] * inv_a, zero), torch.where(use_a, zero, v[2] * inv_b),
            torch.where(use_a, v[0] * inv_a, -v[1] * inv_b))


def _where3(m, a, b):
    return tuple(torch.where(m, a[k], b[k]) for k in range(3))


def _vec(x):
    return tuple(x.unbind(-1))


def eval_bezier(cp, u):
    """de Casteljau point and derivative (curve.rs:651) of 4 control points
    cp (each a 3-tuple) at u; the derivative falls back to cp3 - cp0 where
    it is degenerate."""
    a0 = tuple(_lerp(u, cp[0][k], cp[1][k]) for k in range(3))
    a1 = tuple(_lerp(u, cp[1][k], cp[2][k]) for k in range(3))
    a2 = tuple(_lerp(u, cp[2][k], cp[3][k]) for k in range(3))
    b0 = tuple(_lerp(u, a0[k], a1[k]) for k in range(3))
    b1 = tuple(_lerp(u, a1[k], a2[k]) for k in range(3))
    p = tuple(_lerp(u, b0[k], b1[k]) for k in range(3))
    deriv = tuple(3.0 * (b1[k] - b0[k]) for k in range(3))
    small = _dot(deriv, deriv) < 1e-14
    return p, _where3(small, _sub(cp[3], cp[0]), deriv)


def _ray_frame(d, cp0, cp3):
    """The ray frame oriented so that the segment runs along +x
    (curve.rs:385-415), with the coordinate_system fallback where d and the
    chord are parallel."""
    ez = _normalize(d)
    up = _cross(d, _sub(cp3, cp0))
    degen = _dot(up, up) < 1e-18
    up = _where3(degen, _coordinate_axis(ez), up)
    ex = _normalize(_cross(up, ez))
    return ex, _cross(ez, ex), ez


class CurveSegHit(NamedTuple):
    hit: torch.Tensor  # bool
    t: torch.Tensor  # the ray parameter, inf where no hit
    u: torch.Tensor  # the parent curve's u
    v: torch.Tensor  # across the width
    w: torch.Tensor  # the segment-local parameter, clamped to [0, 1]


def _split_rows(rows):
    """The leaf test's arguments from (..., N_CURVE_ATTR) rows."""
    cp = tuple(tuple(rows[..., CV_CP + 3 * i + k] for k in range(3)) for i in range(4))
    return dict(cp=cp, w0=rows[..., CV_W0], w1=rows[..., CV_W1], u0=rows[..., CV_U0],
                u1=rows[..., CV_U1], n0=tuple(rows[..., CV_N0 + k] for k in range(3)),
                n1=tuple(rows[..., CV_N1 + k] for k in range(3)),
                norm_angle=rows[..., CV_NORM_ANGLE], inv_sin_na=rows[..., CV_INV_SIN_NA],
                ctype=rows[..., CV_TYPE])


def seg_test(o, d, t_max, cp, w0, w1, u0, u1, n0, n1, norm_angle, inv_sin_na, ctype) -> CurveSegHit:
    """The reference's leaf test (curve.rs:215-343) on 3-tuples o, d, the
    control points cp (4 3-tuples) and the segment's scalars, every operand
    broadcast against the others: the slab rejects in the ray frame, the
    end tangents' edge functions, the clamped closest approach along the
    chord, the width there (a ribbon's scaled by its slerped normal's cosine
    to the ray) and the depth test.  ctype is a float tag (0, 1, 2)."""
    ex, ey, ez = _ray_frame(d, cp[0], cp[3])
    q = []
    for p in cp:
        r = _sub(p, o)
        q.append((_dot(r, ex), _dot(r, ey), _dot(r, ez)))
    ray_length = torch.sqrt(torch.clamp(_dot(d, d), min=1e-30))
    z_max = ray_length * t_max
    half_w = 0.5 * torch.maximum(w0, w1)
    hi = tuple(torch.maximum(torch.maximum(q[0][k], q[1][k]), torch.maximum(q[2][k], q[3][k]))
               for k in range(3))
    lo = tuple(torch.minimum(torch.minimum(q[0][k], q[1][k]), torch.minimum(q[2][k], q[3][k]))
               for k in range(3))
    # conservative slab rejects (curve.rs:425-447)
    ok = ~((hi[1] + half_w < 0.0) | (lo[1] - half_w > 0.0) | (hi[0] + half_w < 0.0)
           | (lo[0] - half_w > 0.0) | (hi[2] + half_w < 0.0) | (lo[2] - half_w > z_max))
    # the end tangents' edge functions (curve.rs:221-230)
    q0, q1, q2, q3 = q
    edge0 = (q1[1] - q0[1]) * (-q0[1]) + q0[0] * (q0[0] - q1[0])
    edge1 = (q2[1] - q3[1]) * (-q3[1]) + q3[0] * (q3[0] - q2[0])
    ok = ok & (edge0 >= 0.0) & (edge1 >= 0.0)
    # the closest approach along the chord (curve.rs:232-253)
    sdx, sdy = q3[0] - q0[0], q3[1] - q0[1]
    denom = sdx * sdx + sdy * sdy
    ok = ok & (denom > 0.0)
    w = ((-q0[0]) * sdx + (-q0[1]) * sdy) / torch.clamp(denom, min=1e-20)
    u = _clip(_lerp(w, u0, u1), u0, u1)
    span = torch.where(u1 == u0, 1.0, u1 - u0)
    lw = (u - u0) / span
    hit_width = _lerp(lw, w0, w1)
    # a ribbon's width scaled by its normal's cosine to the ray (curve.rs:256-264)
    straight = norm_angle < 1e-6
    s0 = torch.where(straight, 1.0 - lw, torch.sin((1.0 - lw) * norm_angle) * inv_sin_na)
    s1 = torch.where(straight, lw, torch.sin(lw * norm_angle) * inv_sin_na)
    n_hit = tuple(s0 * n0[k] + s1 * n1[k] for k in range(3))
    ribbon_scale = _dot(n_hit, d).abs() / torch.clamp(ray_length, min=1e-20)
    hit_width = torch.where(ctype == RIBBON, hit_width * ribbon_scale, hit_width)
    # the curve's point at w, the width and depth tests (curve.rs:266-277)
    wc = _clip(w, torch.zeros_like(w), torch.ones_like(w))
    pc, dpcdw = eval_bezier(q, wc)
    dist2 = pc[0] * pc[0] + pc[1] * pc[1]
    ok = ok & (dist2 <= hit_width * hit_width * 0.25)
    ok = ok & (pc[2] >= 0.0) & (pc[2] <= z_max)
    # v from the side of the tangent (curve.rs:279-286)
    dist = torch.sqrt(torch.clamp(dist2, min=0.0))
    edge_func = dpcdw[0] * (-pc[1]) + pc[0] * dpcdw[1]
    ratio = dist / torch.clamp(hit_width, min=1e-20)
    v = torch.where(edge_func > 0.0, 0.5 + ratio, 0.5 - ratio)
    t = pc[2] / torch.clamp(ray_length, min=1e-20)
    ok = ok & (t > 1e-7)
    return CurveSegHit(ok, torch.where(ok, t, float("inf")), u, v, wc)


def curve_seg_test(o, d, t_max, cp, w0, w1, u0, u1, n0, n1, norm_angle, inv_sin_na,
                   ctype) -> CurveSegHit:
    """seg_test with the JAX package's signature: o, d (..., 3), cp
    (..., 4, 3), n0, n1 (..., 3), the rest (...)."""
    return seg_test(_vec(o), _vec(d), t_max, tuple(_vec(cp[..., i, :]) for i in range(4)),
                    w0, w1, u0, u1, _vec(n0), _vec(n1), norm_angle, inv_sin_na,
                    ctype.to(torch.float32))


def row_test(o, d, t_max, rows) -> CurveSegHit:
    """seg_test of rays o, d (3-tuples) against segment rows (..., 26)."""
    return seg_test(o, d, t_max, **_split_rows(rows))


# ---------------------------------------------------------------------------
# the plain versions of C1-C4
# ---------------------------------------------------------------------------


class CurveHit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) the hit's t, t_max where none
    seg: torch.Tensor  # (N,) int32 the winning segment (0 where none)
    w: torch.Tensor  # (N,) the hit's local parameter
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)


def intersect_curves_plain(o, d, t_max, rows, any_hit: bool = False,
                           work: Optional[dict] = None):
    """The all-pairs sweep (the JAX intersect_curves_brute, curves.py:387):
    the least t over every segment, the lowest segment among equal t
    (argmin).  Where no segment hits: valid False, t = t_max, seg 0 and w,
    u, v of segment 0's test.  any_hit: (N,) bool, any segment hit (C4).
    Rays go in chunks of SWEEP_PAIRS pairs.  work, when given, gets the
    leaf tests the sweep needs ("tests": every pair; with any_hit, each
    ray's tests up to its first hit in segment order)."""
    n, s = o.shape[0], rows.shape[0]
    chunk = max(1, SWEEP_PAIRS // max(s, 1))
    outs, tests = [], 0
    idx = torch.arange(s, device=o.device)
    for a in range(0, n, chunk):
        oc, dc, tc = o[a:a + chunk], d[a:a + chunk], t_max[a:a + chunk]
        h = row_test(tuple(x[:, None] for x in _vec(oc)), tuple(x[:, None] for x in _vec(dc)),
                     tc[:, None], rows[None, :, :])
        if any_hit:
            hit = h.hit.any(1)
            if work is not None:
                first = torch.where(h.hit, idx[None, :], s).min(1).values
                tests += int(torch.where(hit, first + 1, s).sum())
            outs.append(hit)
            continue
        best = torch.argmin(h.t, dim=1)
        take = lambda x: x.gather(1, best[:, None])[:, 0]
        bt = take(h.t)
        valid = torch.isfinite(bt)
        outs.append(CurveHit(valid, torch.where(valid, bt, tc), best.to(torch.int32), take(h.w),
                             take(h.u), take(h.v)))
    if work is not None:
        work["tests"] = tests if any_hit else n * s
    if any_hit:
        return torch.cat(outs) if outs else torch.zeros(0, dtype=torch.bool, device=o.device)
    if not outs:
        z = torch.zeros(0, device=o.device)
        return CurveHit(z.bool(), z, z.int(), z, z, z)
    return CurveHit(*(torch.cat(x) for x in zip(*outs)))


class CurveBVH(NamedTuple):
    """A binary SAH tree over segment boxes (ops/bvh_native.build_binary_native)
    on the device: node i's children child[i] (>= 0 a node, < 0 the leaf
    ~position), their boxes box[i] = (bmin_l, bmax_l, bmin_r, bmax_r), and
    prim[leaf position] the segment row."""

    child: torch.Tensor  # (S-1, 2) int32
    box: torch.Tensor  # (S-1, 12) f32
    prim: torch.Tensor  # (S,) int32


def curve_bvh_from_numpy(child_l, child_r, bmin_l, bmax_l, bmin_r, bmax_r, prim_ids,
                         device) -> CurveBVH:
    """CurveBVH on `device` from the binary tree's arrays (the JAX LBVH's
    fields of the same names)."""
    f = lambda a: np.asarray(a, np.float32).reshape(-1, 3)
    child = np.stack([np.asarray(child_l, np.int32), np.asarray(child_r, np.int32)], -1)
    box = np.concatenate([f(bmin_l), f(bmax_l), f(bmin_r), f(bmax_r)], -1)
    return CurveBVH(torch.as_tensor(child, device=device),
                    torch.as_tensor(np.ascontiguousarray(box), device=device),
                    torch.as_tensor(np.asarray(prim_ids, np.int32), device=device))


def _slab(o, inv_d, t_max, bmin, bmax):
    """The JAX bvh._slab on 3-tuples: (hit, t_near)."""
    t_lo = tuple((bmin[k] - o[k]) * inv_d[k] for k in range(3))
    t_hi = tuple((bmax[k] - o[k]) * inv_d[k] for k in range(3))
    tn = [torch.minimum(t_lo[k], t_hi[k]) for k in range(3)]
    tf = [torch.maximum(t_lo[k], t_hi[k]) for k in range(3)]
    t_near = torch.maximum(torch.maximum(tn[0], tn[1]), tn[2])
    t_far = torch.minimum(torch.minimum(tf[0], tf[1]), tf[2]) * SLAB_EPS
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max), t_near


def bvh_intersect_curves_plain(o, d, t_max, tree: CurveBVH, rows, any_hit: bool = False,
                               work: Optional[dict] = None):
    """The JAX walk bvh_intersect_curves (curves.py:409-491) step by step:
    each step pops one node, slab-tests both children against the best t
    so far, runs the leaf test of a hit leaf child (left, then right with
    the left's result), a segment winning only at a strictly smaller t, and
    pushes the hit internal children, the farther first (the left is the
    nearer when tn_l <= tn_r).  The stack holds STACK_DEPTH entries: a push
    onto a full stack overwrites its top entry, as the JAX walk's clamp
    does.  Returns CurveHit (a miss: t = t_max, seg 0, w = u = v = 0), or
    with any_hit (N,) bool, each ray stopping at its first hit (C2).

    Lanes leave the wavefront when their walk ends; lanes with t_max < 0 or
    NaN (dead paths, which can hit nothing) leave at once.  work, when
    given, gets per ray the nodes visited and the leaf tests run ("nodes",
    "tests", (N,) int64), the distinct nodes and segments read
    ("node_rows", "seg_rows") and the pushes the clamp overwrote
    ("clamped")."""
    n, dev = o.shape[0], o.device
    out_t = t_max.clone()
    out_seg = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_w, out_u, out_v = (torch.zeros(n, device=dev) for _ in range(3))
    n_nodes = torch.zeros(n, dtype=torch.int64, device=dev)
    n_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    node_seen = torch.zeros(tree.child.shape[0], dtype=torch.bool, device=dev)
    seg_seen = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    clamped = torch.zeros((), dtype=torch.int64, device=dev)

    lane = torch.nonzero(t_max >= 0.0)[:, 0]
    lo, ld = _vec(o[lane]), _vec(d[lane])
    inv_d = tuple(1.0 / torch.where(x == 0.0, 1e-20, x) for x in ld)
    best_t = t_max[lane].clone()
    best_seg = torch.full_like(lane, -1, dtype=torch.int32)
    best_w, best_u, best_v = (torch.zeros_like(best_t) for _ in range(3))
    stack = torch.zeros((lane.shape[0], STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones_like(lane)
    lanes = torch.arange(lane.shape[0], device=dev)

    def leaf(c, mask, best):
        """The leaf test of child refs c (< 0) on the lanes of mask."""
        b_t, b_seg, b_w, b_u, b_v = best
        li = torch.nonzero(mask)[:, 0]
        if not li.numel():
            return best
        prim = tree.prim[(~c[li]).long()]
        n_tests[lane[li]] += 1
        seg_seen[prim.long()] = True
        h = row_test(tuple(x[li] for x in lo), tuple(x[li] for x in ld), b_t[li],
                     rows[prim.long()])
        upd = h.hit & (h.t < b_t[li])
        u_ = li[upd]
        b_t, b_seg, b_w, b_u, b_v = (x.clone() for x in best)
        b_t[u_], b_seg[u_] = h.t[upd], prim[upd]
        b_w[u_], b_u[u_], b_v[u_] = h.w[upd], h.u[upd], h.v[upd]
        return b_t, b_seg, b_w, b_u, b_v

    while lane.numel():
        live = sp > 0
        if any_hit:
            live &= best_seg < 0
        if not bool(live.all()):
            done = ~live
            ids = lane[done]
            out_t[ids], out_seg[ids] = best_t[done], best_seg[done]
            out_w[ids], out_u[ids], out_v[ids] = best_w[done], best_u[done], best_v[done]
            lane, lo, ld, inv_d = (lane[live], tuple(x[live] for x in lo),
                                   tuple(x[live] for x in ld), tuple(x[live] for x in inv_d))
            best_t, best_seg = best_t[live], best_seg[live]
            best_w, best_u, best_v = best_w[live], best_u[live], best_v[live]
            stack, sp = stack[live], sp[live]
            lanes = torch.arange(lane.shape[0], device=dev)
            if not lane.numel():
                break
        node = stack[lanes, sp - 1].long()
        sp = sp - 1
        n_nodes[lane] += 1
        node_seen[node] = True
        cl, cr = tree.child[node, 0], tree.child[node, 1]
        bx = tree.box[node]
        col = lambda c: tuple(bx[:, c + k] for k in range(3))
        hit_l, tn_l = _slab(lo, inv_d, best_t, col(0), col(3))
        hit_r, tn_r = _slab(lo, inv_d, best_t, col(6), col(9))
        best = (best_t, best_seg, best_w, best_u, best_v)
        best = leaf(cl, hit_l & (cl < 0), best)
        best = leaf(cr, hit_r & (cr < 0), best)
        best_t, best_seg, best_w, best_u, best_v = best

        push_l = hit_l & (cl >= 0)
        push_r = hit_r & (cr >= 0)
        near_is_l = tn_l <= tn_r
        first = torch.where(near_is_l, cl, cr)
        second = torch.where(near_is_l, cr, cl)
        push_first = torch.where(near_is_l, push_l, push_r)
        push_second = torch.where(near_is_l, push_r, push_l)
        for push, child in ((push_second, second), (push_first, first)):
            clamped = clamped + (push & (sp == STACK_DEPTH)).sum()
            at = torch.clamp(sp, max=STACK_DEPTH - 1)
            stack[lanes, at] = torch.where(push, child, stack[lanes, at])
            sp = torch.where(push, torch.clamp(sp + 1, max=STACK_DEPTH), sp)

    if work is not None:
        work.update(nodes=n_nodes, tests=n_tests, node_rows=int(node_seen.sum()),
                    seg_rows=int(seg_seen.sum()), clamped=int(clamped))
    valid = out_seg >= 0
    if any_hit:
        return valid
    return CurveHit(valid, out_t, torch.clamp(out_seg, min=0), out_w, out_u, out_v)


# ---------------------------------------------------------------------------
# the shading record of a hit (plain PyTorch, as the JAX package's XLA)
# ---------------------------------------------------------------------------


def curve_seg_detail(o, d, rows, w, v):
    """Shading geometry of hits at local parameter w and v on segment rows
    (curve.rs:288-336): world-space p, p_error, dpdu and the normal.  o, d
    (N, 3), rows (N, 26)."""
    s = _split_rows(rows)
    ex, ey, ez = (torch.stack(a, -1) for a in _ray_frame(_vec(d), s["cp"][0], s["cp"][3]))
    p_world, dpdu = (torch.stack(a, -1) for a in eval_bezier(s["cp"], w))
    u0, u1, w0, w1 = s["u0"], s["u1"], s["w0"], s["w1"]
    na, inv_sin = s["norm_angle"], s["inv_sin_na"]
    span = torch.where(u1 == u0, 1.0, u1 - u0)
    lw = (_lerp(w, u0, u1) - u0) / span
    hit_width = _lerp(lw, w0, w1)
    straight = na < 1e-6
    s0 = torch.where(straight, 1.0 - lw, torch.sin((1.0 - lw) * na) * inv_sin)
    s1 = torch.where(straight, lw, torch.sin(lw * na) * inv_sin)
    n_hit = s0[:, None] * torch.stack(s["n0"], -1) + s1[:, None] * torch.stack(s["n1"], -1)
    # a ribbon's dpdv (curve.rs:303-305)
    dpdv_ribbon = vm.normalize(vm.cross(n_hit, dpdu)) * hit_width[:, None]
    # flat and cylinder: dpdv in the ray plane (curve.rs:306-322)
    dpdu_plane = torch.stack([vm.dot(dpdu, ex), vm.dot(dpdu, ey), vm.dot(dpdu, ez)], -1)
    dpdv_plane = vm.normalize(torch.stack(
        [-dpdu_plane[:, 1], dpdu_plane[:, 0], torch.zeros_like(dpdu_plane[:, 0])], -1)
    ) * hit_width[:, None]
    # a cylinder's dpdv rotated by -theta about dpdu_plane (Rodrigues)
    theta = _lerp(v, -90.0, 90.0) * (np.pi / 180.0)
    axis = vm.normalize(dpdu_plane)
    ct = torch.cos(-theta)[:, None]
    st = torch.sin(-theta)[:, None]
    rotated = (dpdv_plane * ct + vm.cross(axis, dpdv_plane) * st
               + axis * vm.dot(axis, dpdv_plane)[:, None] * (1.0 - ct))
    ctype = s["ctype"]
    dpdv_plane = torch.where((ctype == CYLINDER)[:, None], rotated, dpdv_plane)
    dpdv_flat = dpdv_plane[:, 0:1] * ex + dpdv_plane[:, 1:2] * ey + dpdv_plane[:, 2:3] * ez
    dpdv = torch.where((ctype == RIBBON)[:, None], dpdv_ribbon, dpdv_flat)
    ns = vm.normalize(vm.cross(dpdu, dpdv))
    p_err = (2.0 * hit_width)[:, None].expand_as(p_world)
    return p_world, p_err, dpdu, ns


def curve_interaction(o, d, crv_attr, hit: CurveHit):
    """The shading record of each lane's winning segment (the JAX
    curve_interaction): (p, p_err, dpdu, ns, uv, mat)."""
    rows = crv_attr[hit.seg.long()]
    p, p_err, dpdu, ns = curve_seg_detail(o, d, rows, hit.w, hit.v)
    uv = torch.stack([hit.u, hit.v], -1)
    return p, p_err, dpdu, ns, uv, torch.round(rows[:, CV_MAT]).to(torch.int32)
