"""Watertight ray-triangle tests, plain PyTorch forms.

The port of rs_pbrt_tpu/ops/pallas_intersect.py:_ray_constants,
_watertight_tri and _watertight_tri_any (reference triangle.rs:134-449).
Rays are (N,) tensors per component; a triangle is 9 vertex coordinates
(0-d tensors or floats).  ``csrc/watertight.cuh`` computes the same
expressions term by term for the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.vecmath import gamma

GAMMA2 = float(gamma(2.0))
GAMMA3 = float(gamma(3.0))
GAMMA5 = float(gamma(5.0))
BIG = 3e38  # "no hit yet" distance


class RayConst(NamedTuple):
    Sx: tuple  # onehot(kx) + sx * onehot(kz)
    Sy: tuple  # onehot(ky) + sy * onehot(kz)
    Sz: tuple  # onehot(kz)
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    inv_dz: torch.Tensor


def ray_constants(o, d) -> RayConst:
    """Per-ray permute and shear (triangle.rs:154-222); o, d: 3-tuples."""
    dx, dy, dz = d
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    use_x = (adx >= ady) & (adx >= adz)
    use_y = ~use_x & (ady >= adz)
    use_z = ~(use_x | use_y)
    hz = tuple(m.to(dx.dtype) for m in (use_x, use_y, use_z))
    hx = (hz[2], hz[0], hz[1])
    hy = (hz[1], hz[2], hz[0])
    dzp = hz[0] * dx + hz[1] * dy + hz[2] * dz
    dxp = hx[0] * dx + hx[1] * dy + hx[2] * dz
    dyp = hy[0] * dx + hy[1] * dy + hy[2] * dz
    inv_dz = 1.0 / dzp
    sx = -dxp * inv_dz
    sy = -dyp * inv_dz
    Sx = tuple(hx[k] + sx * hz[k] for k in range(3))
    Sy = tuple(hy[k] + sy * hz[k] for k in range(3))
    Sz = hz
    ox, oy, oz = o
    cx = Sx[0] * ox + Sx[1] * oy + Sx[2] * oz
    cy = Sy[0] * ox + Sy[1] * oy + Sy[2] * oz
    cz = Sz[0] * ox + Sz[1] * oy + Sz[2] * oz
    return RayConst(Sx, Sy, Sz, cx, cy, cz, inv_dz)


def _edge_test(rc: RayConst, p, t_lim):
    """Edge functions, det, scaled t, the reject mask and the error bound
    on t scaled by |det|.  p: the triangle's 9 vertex coordinates."""
    Sx, Sy, Sz = rc.Sx, rc.Sy, rc.Sz

    def xform(px, py, pz):
        x = Sx[0] * px + Sx[1] * py + Sx[2] * pz - rc.cx
        y = Sy[0] * px + Sy[1] * py + Sy[2] * pz - rc.cy
        z = Sz[0] * px + Sz[1] * py + Sz[2] * pz - rc.cz
        return x, y, z

    x0, y0, z0 = xform(p[0], p[1], p[2])
    x1, y1, z1 = xform(p[3], p[4], p[5])
    x2, y2, z2 = xform(p[6], p[7], p[8])
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    z0s = rc.inv_dz * z0
    z1s = rc.inv_dz * z1
    z2s = rc.inv_dz * z2
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    neg_det = det < 0.0
    miss_range = (neg_det & ((t_scaled >= 0.0) | (t_scaled < t_lim * det))) | (
        ~neg_det & ((t_scaled <= 0.0) | (t_scaled > t_lim * det))
    )
    max_zt = torch.maximum(torch.maximum(z0s.abs(), z1s.abs()), z2s.abs())
    delta_z = GAMMA3 * max_zt
    max_xt = torch.maximum(torch.maximum(x0.abs(), x1.abs()), x2.abs())
    max_yt = torch.maximum(torch.maximum(y0.abs(), y1.abs()), y2.abs())
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = torch.maximum(torch.maximum(e0.abs(), e1.abs()), e2.abs())
    c_eps = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e)
    reject = (neg & pos) | (det == 0.0) | miss_range
    return e0, e1, det, t_scaled, c_eps, reject


def watertight_tri(rc: RayConst, p, t_lim):
    """Closest-hit test -> (hit, t, b0, b1)."""
    e0, e1, det, t_scaled, c_eps, reject = _edge_test(rc, p, t_lim)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    t = t_scaled * inv_det
    delta_t = c_eps * inv_det.abs()
    return ~(reject | (t <= delta_t)), t, b0, b1


def watertight_tri_any(rc: RayConst, p, t_lim):
    """Occlusion-only test, division free -> hit mask."""
    _, _, det, t_scaled, c_eps, reject = _edge_test(rc, p, t_lim)
    t_signed = torch.where(det < 0.0, -t_scaled, t_scaled)
    return ~(reject | (t_signed <= c_eps))


def closest_sweep(tris: torch.Tensor, n_tri: int, o, d, t_lim):
    """Closest hit over rows 0..n_tri-1 of a (T, >=9) table ->
    (t, tri index or -1, b0, b1)."""
    rc = ray_constants(o, d)
    bt = torch.full_like(o[0], BIG)
    bi = torch.full(o[0].shape, -1, dtype=torch.int32, device=o[0].device)
    b0 = torch.zeros_like(o[0])
    b1 = torch.zeros_like(o[0])
    for t in range(n_tri):
        hit, tval, tb0, tb1 = watertight_tri(rc, tris[t], t_lim)
        upd = hit & (tval < bt)
        bt = torch.where(upd, tval, bt)
        bi = torch.where(upd, t, bi)
        b0 = torch.where(upd, tb0, b0)
        b1 = torch.where(upd, tb1, b1)
    return bt, bi, b0, b1


def any_sweep(tris: torch.Tensor, n_tri: int, o, d, t_lim):
    """Occlusion mask over rows 0..n_tri-1."""
    rc = ray_constants(o, d)
    occ = torch.zeros(o[0].shape, dtype=torch.bool, device=o[0].device)
    for t in range(n_tri):
        occ = occ | watertight_tri_any(rc, tris[t], t_lim)
    return occ


def any_sweep_tests(tris: torch.Tensor, n_tri: int, o, d, t_lim, mask) -> int:
    """Triangle tests that a sweep stopping at the first occluder (as
    csrc/bounce.cu's does) runs over the lanes of mask."""
    rc = ray_constants(o, d)
    live = mask.clone()
    tests = torch.zeros((), dtype=torch.int64, device=mask.device)
    for t in range(n_tri):
        tests += live.sum()
        live &= ~watertight_tri_any(rc, tris[t], t_lim)
    return int(tests)
