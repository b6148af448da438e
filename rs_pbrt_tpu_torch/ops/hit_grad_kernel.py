"""G1: the closest triangle hit's vector-Jacobian product, and the
differentiable closest hit it serves.

The JAX package takes gradients through its XLA watertight test
(rs_pbrt_tpu/ops/intersect.py:61-130 ``intersect_tri``): t, b0 and b1 are
differentiable functions of the ray's o and d (through the shear) and of
the hit triangle's vertices, and the hit record is rebuilt from them
(``_tri_interaction``).  The port's hits come from kernels that return no
gradient (K3, B1, D1), so ``TriHitFn`` wraps the closest hit in a
``torch.autograd.Function``: its forward is the walk the scene already
uses, on detached rays; its backward is ``hit_vjp``, which launches G1
(``csrc/hit_grad.cu``) for CUDA tensors and runs ``hit_vjp_plain``, the
same reverse sweep in plain PyTorch, for CPU ones.

``hit_vjp(o, d, tri, g_t, g_b0, g_b1, tris, want_verts)``: o, d (N, 3)
f32, tri (N,) int32 (-1 where the ray missed), the upstream gradients of
t, b0 and b1 (N,), tris (T, C) f32 with the vertices in columns 0..8.
Returns (grad_o (N, 3), grad_d (N, 3), grad_verts (T, 9) or None); a lane
whose tri is -1 gives zeros.  The plain version computes each lane's
terms in the kernel's order, so the per-lane outputs agree bit for bit;
the kernel adds grad_verts with atomics, in no fixed order.

``diff_anim_hit`` serves moving meshes the same way: V1 finds each lane's
triangle on detached rays, and G1 is the backward in the mesh's object
space, where the ray is carried by the inverse of the mesh's transform
interpolated at the ray's time.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .intersect import TriHit

launches = 0  # kernel launches of `hit_vjp`; the plain version counts none


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("hit_grad").rs_hit_grad
    P, I = ctypes.c_void_p, ctypes.c_int
    # o, d, tri, g_t, g_b0, g_b1, tris, n_tri, cols, n, g_o, g_d, g_verts, stream
    fn.argtypes = [P] * 7 + [I, I, ctypes.c_longlong, P, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def _comp(v, k):
    """Component k (N,) of the rows of v (N, 3)."""
    return v.gather(1, k[:, None])[:, 0]


def hit_vjp_plain(o, d, tri, g_t, g_b0, g_b1, tris, want_verts: bool = False,
                  work: dict = None):
    """G1's plain version: the reverse sweep of the watertight test at each
    lane's triangle, in the kernel's order of operations.  work, when given
    with want_verts, gains "abs_verts" (T, 9), the sum of the |terms| added
    into each vertex entry, and "n_verts" (T,), the lanes that add to each
    row, and "hits", the lanes with a triangle."""
    n, n_tri = o.shape[0], tris.shape[0]
    valid = (tri >= 0) & (tri < n_tri)
    r = torch.clamp(tri.long(), 0, max(n_tri - 1, 0))
    ad = d.abs()
    kz = torch.where((ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2]), 0,
                     torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    sz = 1.0 / _comp(d, kz)
    sx = -_comp(d, kx) * sz
    sy = -_comp(d, ky) * sz
    q = tris[r, :9].reshape(n, 3, 3) - o[:, None, :]  # (N, vertex, xyz)
    pick = lambda k: q.gather(2, k[:, None, None].expand(n, 3, 1))[..., 0]  # (N, 3)
    qx, qy, qz = pick(kx), pick(ky), pick(kz)
    x = qx + sx[:, None] * qz
    y = qy + sy[:, None] * qz
    zs = sz[:, None] * qz
    x0, x1, x2 = x.unbind(1)
    y0, y1, y2 = y.unbind(1)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    det = e0 + e1 + e2
    ts = e0 * zs[:, 0] + e1 * zs[:, 1] + e2 * zs[:, 2]
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    g_inv = g_b0 * e0 + g_b1 * e1 + g_t * ts
    g_det = torch.where(det == 0.0, 0.0, -(g_inv * inv) * inv)
    g_ts = g_t * inv
    ge0 = g_b0 * inv + g_det + g_ts * zs[:, 0]
    ge1 = g_b1 * inv + g_det + g_ts * zs[:, 1]
    ge2 = g_det + g_ts * zs[:, 2]
    gx = torch.stack([ge2 * y1 - ge1 * y2, ge0 * y2 - ge2 * y0, ge1 * y0 - ge0 * y1], 1)
    gy = torch.stack([ge1 * x2 - ge2 * x1, ge2 * x0 - ge0 * x2, ge0 * x1 - ge1 * x0], 1)
    gzs = g_ts[:, None] * torch.stack([e0, e1, e2], 1)
    dot3 = lambda a, b: a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]
    g_sz, g_sx, g_sy = dot3(gzs, qz), dot3(gx, qz), dot3(gy, qz)
    gq_z = sz[:, None] * gzs + sx[:, None] * gx + sy[:, None] * gy
    gq = torch.zeros_like(q)
    for k, g in ((kx, gx), (ky, gy), (kz, gq_z)):
        gq = gq.scatter(2, k[:, None, None].expand(n, 3, 1), g[..., None])
    g_o = -gq[:, 0] - gq[:, 1] - gq[:, 2]
    g_sz_all = g_sz - g_sx * _comp(d, kx) - g_sy * _comp(d, ky)
    g_d = torch.zeros_like(d)
    for k, g in ((kx, -(g_sx * sz)), (ky, -(g_sy * sz)), (kz, -(g_sz_all * sz) * sz)):
        g_d = g_d.scatter(1, k[:, None], g[:, None])
    keep = valid[:, None]
    g_o, g_d = torch.where(keep, g_o, 0.0), torch.where(keep, g_d, 0.0)
    g_verts = None
    if want_verts:
        g_verts = torch.zeros((n_tri, 9), dtype=o.dtype, device=o.device).index_add_(
            0, r[valid], gq.reshape(n, 9)[valid])
        if work is not None:
            work["abs_verts"] = torch.zeros_like(g_verts).index_add_(
                0, r[valid], gq.reshape(n, 9)[valid].abs())
            work["n_verts"] = torch.zeros(n_tri, dtype=o.dtype, device=o.device).index_add_(
                0, r[valid], torch.ones_like(r[valid], dtype=o.dtype))
    if work is not None:
        work["hits"] = int(valid.sum())
    return g_o, g_d, g_verts


def _check(name, t, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"hit_vjp: {name} must be a contiguous {dtype} CUDA tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)} on {t.device}")


def hit_vjp(o, d, tri, g_t, g_b0, g_b1, tris, want_verts: bool = False):
    """G1 for CUDA tensors, hit_vjp_plain for CPU ones."""
    if o.device.type == "cpu":
        return hit_vjp_plain(o, d, tri, g_t, g_b0, g_b1, tris, want_verts)
    global launches
    n = o.shape[0]
    if tris.dim() != 2 or tris.shape[1] < 9:
        raise ValueError("hit_vjp: the table needs the 9 vertex coordinates a row")
    for name, t, dtype, shape in (("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
                                  ("tri", tri, torch.int32, (n,)),
                                  ("g_t", g_t, torch.float32, (n,)),
                                  ("g_b0", g_b0, torch.float32, (n,)),
                                  ("g_b1", g_b1, torch.float32, (n,)),
                                  ("tris", tris, torch.float32, tuple(tris.shape))):
        _check(name, t, dtype, shape)
    g_o = torch.empty_like(o)
    g_d = torch.empty_like(d)
    g_verts = (torch.zeros((tris.shape[0], 9), dtype=torch.float32, device=o.device)
               if want_verts else None)
    with torch.cuda.device(o.device):
        err = _kernel()(o.data_ptr(), d.data_ptr(), tri.data_ptr(), g_t.data_ptr(),
                        g_b0.data_ptr(), g_b1.data_ptr(), tris.data_ptr(), tris.shape[0],
                        tris.shape[1], n, g_o.data_ptr(), g_d.data_ptr(),
                        None if g_verts is None else g_verts.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "hit_vjp kernel launch")
    launches += 1
    return g_o, g_d, g_verts


class TriHitFn(torch.autograd.Function):
    """(t, b0, b1, tri) of the closest hit, differentiable in o, d and the
    table's vertex columns: forward ``closest(o, d)`` (a walk on detached
    rays -> TriHit), backward ``hit_vjp`` (G1)."""

    @staticmethod
    def forward(ctx, o, d, tris, closest):
        th = closest(o.detach(), d.detach())
        ctx.save_for_backward(o.detach(), d.detach(), tris.detach(), th.tri)
        ctx.mark_non_differentiable(th.tri)
        return th.t, th.b0, th.b1, th.tri

    @staticmethod
    def backward(ctx, g_t, g_b0, g_b1, _g_tri):
        o, d, tris, tri = ctx.saved_tensors
        zero = lambda g: torch.zeros_like(o[:, 0]) if g is None else g.contiguous()
        g_o, g_d, g_v = hit_vjp(o, d, tri, zero(g_t), zero(g_b0), zero(g_b1), tris,
                                want_verts=ctx.needs_input_grad[2])
        g_tris = None
        if g_v is not None:
            g_tris = torch.cat([g_v, g_v.new_zeros((g_v.shape[0], tris.shape[1] - 9))], 1)
        return (g_o if ctx.needs_input_grad[0] else None,
                g_d if ctx.needs_input_grad[1] else None, g_tris, None)


def diff_tri_hit(o, d, t_max, tris, closest) -> TriHit:
    """The closest hit of rays o, d within t_max through closest(o, d,
    t_max) -> TriHit (K3, B1 or D1 on detached rays), with t, b0 and b1
    differentiable in o, d and the vertex columns of tris (the scene's
    tri_attr) through G1."""
    t, b0, b1, tri = TriHitFn.apply(o, d, tris,
                                    lambda oo, dd: closest(oo, dd, t_max.detach()))
    return TriHit(tri >= 0, t, tri, b0, b1)


def diff_anim_hit(o, d, t_max, time, anim_xf, anim_attr, closest) -> dict:
    """The closest moving-mesh hit of rays o, d within t_max at times time
    (None: 0) through closest(o, d, t_max, time) -> the dict of
    motion_kernel.anim_hits (V1 on detached rays), with t, b0 and b1
    differentiable in o, d and time: each hit lane's ray is carried into
    its mesh's object space by the inverse of the mesh's transform
    interpolated at the ray's time (the tables anim_xf detached; object t
    is world t), and G1 is the backward there, at the lane's triangle of
    anim_attr (the JAX _anim_hits differentiates the same object-space
    watertight test)."""
    from ..utils import animated as an
    from ..utils import transform as tr

    det = lambda x: None if x is None else x.detach()
    ah = closest(o.detach(), d.detach(), t_max.detach(), det(time))
    t_lane = torch.zeros_like(t_max) if time is None else time
    m = an.interpolate(t_lane, *an.xf_parts(anim_xf.detach()[ah["grp"].long()]))
    w2o = an.inverse_affine(m)
    o_obj, d_obj = tr.xform_point(w2o, o), tr.xform_vector(w2o, d)
    tri = torch.where(ah["valid"], ah["tri"], -1).to(torch.int32)
    found = TriHit(ah["valid"], ah["t"], tri, ah["b0"], ah["b1"])
    t, b0, b1, _ = TriHitFn.apply(o_obj, d_obj, anim_attr.detach(), lambda oo, dd: found)
    return dict(ah, t=t, b0=b0, b1=b1)
