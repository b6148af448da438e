"""C1-C4: the curve intersection kernels' wrappers.

The port of the JAX package's XLA curve intersection (ops/curves.py
``bvh_intersect_curves`` and ``intersect_curves_brute``).  Each wrapper
launches its CUDA kernel (``csrc/curves.cu``, the leaf test in
``csrc/curve.cuh``) for CUDA tensors and runs its plain version
(``ops/curves.py``) for CPU tensors:

- C1 ``walk_closest``: the closest hit through the curves' binary tree;
- C2 ``walk_any``: the same tree's any hit (shadow rays);
- C3 ``sweep_closest``: the closest hit over every segment (up to
  ``scene_intersect.BRUTE_FORCE_MAX_CURVES`` rows);
- C4 ``sweep_any``: the sweep's any hit.

The closest hits return ``curves.CurveHit`` (seg 0 where nothing is hit,
as the JAX functions report it), the any hits (N,) bool.  The walk's
stack clamps at ``curves.STACK_DEPTH`` entries, as the JAX walk's does;
the kernels count the pushes it overwrote in ``clamp_counter(device)``.

Where autograd records through the rays (a camera gradient of a hair
scene), the closest hit is ``diff_curve_hit``: C1 or C3 on detached rays
inside ``CurveHitFn``, whose backward is C5, ``curve_vjp``
(``csrc/curve_grad.cu``; its twin ``curve_vjp_plain`` on CPU tensors): the
leaf test's vector-Jacobian product in o and d at each lane's winning
segment, from the gradients of t, u, v and w.  The JAX package
differentiates its sweep over every segment; C1 takes the same backward
as C3, since a walk's result is its winning segment's leaf test.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..device import resolve
from ..scene.arrays import N_CURVE_ATTR
from . import _build
from .autodiff import refuse_grad
from . import curves as cv

# kernel launches of each wrapper; the plain versions do not count
launches = {"curve_walk_closest": 0, "curve_walk_any": 0, "curve_sweep_closest": 0,
            "curve_sweep_any": 0, "curve_grad": 0}
_clamped = {}  # per device: a (1,) int32 count of the pushes the walk's stack clamp overwrote

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, child, box, prim, rows, any_hit, t, seg, w, u, v, occ, clamped, stream
    "rs_curve_walk": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # o, d, tmax, n, rows, n_segs, any_hit, t, seg, w, u, v, occ, stream
    "rs_curve_sweep": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("curves"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _grad_kernel():
    fn = _build.load("curve_grad").rs_curve_grad
    # o, d, seg, rows, n_rows, g_t, g_u, g_v, g_w, n, g_o, g_d, stream
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def clamp_counter(device) -> torch.Tensor:
    """The (1,) int32 count of the walk's pushes onto a full stack on
    `device` since it was last zeroed (``.zero_()``)."""
    dev = resolve(device)  # "cuda" and "cuda:0" name one counter
    if dev not in _clamped:
        _clamped[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _clamped[dev]


def _check(what, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def _check_rays(what, o, d, t_max, rows):
    n = o.shape[0]
    _check(what, "o", o, torch.float32, (n, 3))
    _check(what, "d", d, torch.float32, (n, 3))
    _check(what, "t_max", t_max, torch.float32, (n,))
    _check(what, "rows", rows, torch.float32, (rows.shape[0], N_CURVE_ATTR))
    if not 0 < rows.shape[0] < (1 << 31) // N_CURVE_ATTR:
        raise ValueError(f"{what}: {rows.shape[0]} segment rows")
    if n >= 1 << 31:
        raise ValueError(f"{what}: at most 2^31 - 1 rays per launch")
    return n


def _outputs(t_max, any_hit):
    n, dev = t_max.shape[0], t_max.device
    if any_hit:
        return dict(occ=torch.empty(n, dtype=torch.bool, device=dev))
    return dict(t=torch.empty_like(t_max), seg=torch.empty(n, dtype=torch.int32, device=dev),
                w=torch.empty_like(t_max), u=torch.empty_like(t_max), v=torch.empty_like(t_max))


def _ptrs(out, any_hit):
    if any_hit:
        return [None] * 5 + [out["occ"].data_ptr()]
    return [out[k].data_ptr() for k in ("t", "seg", "w", "u", "v")] + [None]


def _result(out, any_hit):
    if any_hit:
        return out["occ"]
    seg = out["seg"]
    return cv.CurveHit(seg >= 0, out["t"], torch.clamp(seg, min=0), out["w"], out["u"], out["v"])


def _walk(o, d, t_max, tree: cv.CurveBVH, rows, any_hit: bool):
    what = "curve walk"
    n = _check_rays(what, o, d, t_max, rows)
    s = tree.prim.shape[0]
    _check(what, "tree.child", tree.child, torch.int32, (max(s - 1, 1), 2))
    _check(what, "tree.box", tree.box, torch.float32, (max(s - 1, 1), 12))
    _check(what, "tree.prim", tree.prim, torch.int32, (s,))
    out = _outputs(t_max, any_hit)
    with torch.cuda.device(o.device):
        err = _kernel("rs_curve_walk")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, tree.child.data_ptr(),
            tree.box.data_ptr(), tree.prim.data_ptr(), rows.data_ptr(), int(any_hit),
            *_ptrs(out, any_hit), clamp_counter(o.device).data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "curve walk kernel launch")
    launches["curve_walk_any" if any_hit else "curve_walk_closest"] += 1
    return _result(out, any_hit)


def _sweep(o, d, t_max, rows, any_hit: bool):
    what = "curve sweep"
    n = _check_rays(what, o, d, t_max, rows)
    out = _outputs(t_max, any_hit)
    with torch.cuda.device(o.device):
        err = _kernel("rs_curve_sweep")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, rows.data_ptr(), rows.shape[0],
            int(any_hit), *_ptrs(out, any_hit), torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "curve sweep kernel launch")
    launches["curve_sweep_any" if any_hit else "curve_sweep_closest"] += 1
    return _result(out, any_hit)


def walk_closest(o, d, t_max, tree: cv.CurveBVH, rows) -> cv.CurveHit:
    """C1: the closest hit of rays o, d (N, 3) within t_max (N,) over
    segment rows (S, 26) through their tree."""
    refuse_grad("walk_closest (C1; the differentiable hit is scene_intersect.curve_hit)",
                o, d, t_max, rows)
    if o.device.type == "cpu":
        return cv.bvh_intersect_curves_plain(o, d, t_max, tree, rows)
    return _walk(o, d, t_max, tree, rows, False)


def walk_any(o, d, t_max, tree: cv.CurveBVH, rows) -> torch.Tensor:
    """C2: whether any segment lies on each ray within t_max, through the
    tree."""
    if o.device.type == "cpu":
        return cv.bvh_intersect_curves_plain(o, d, t_max, tree, rows, any_hit=True)
    return _walk(o, d, t_max, tree, rows, True)


def sweep_closest(o, d, t_max, rows) -> cv.CurveHit:
    """C3: the closest hit over every segment row."""
    refuse_grad("sweep_closest (C3; the differentiable hit is scene_intersect.curve_hit)",
                o, d, t_max, rows)
    if o.device.type == "cpu":
        return cv.intersect_curves_plain(o, d, t_max, rows)
    return _sweep(o, d, t_max, rows, False)


def sweep_any(o, d, t_max, rows) -> torch.Tensor:
    """C4: whether any segment row lies on each ray within t_max."""
    if o.device.type == "cpu":
        return cv.intersect_curves_plain(o, d, t_max, rows, any_hit=True)
    return _sweep(o, d, t_max, rows, True)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _sgn(x):
    """torch.abs's derivative: 1, -1, and 0 at 0."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def _normalize_vjp(a, g_out):
    """The gradient in a of vecmath.normalize(a) from g_out at the unit
    vector (csrc/curve_grad.cu normalize_vjp): g_out / ln, less a's
    share through ln where neither clamp holds it."""
    aa = cv._dot(a, a)
    sq = torch.sqrt(torch.clamp(aa, min=1e-30))
    ln = torch.clamp(sq, min=1e-20)
    g = _scale(g_out, 1.0 / ln)
    g_ln = -cv._dot(g_out, a) / (ln * ln)
    keep = (sq >= 1e-20) & (aa >= 1e-30)
    return tuple(torch.where(keep, g[k] + a[k] * (g_ln / sq), g[k]) for k in range(3))


def _seg_vjp(o, d, rows, g_t, g_u, g_v, g_w):
    """The leaf test's VJP at each lane's segment row (3-tuples o, d, rows
    (N, 26)), csrc/curve_grad.cu seg_vjp term by term: (g_o, g_d)."""
    s = cv._split_rows(rows)
    cp, w0, w1, u0, u1 = s["cp"], s["w0"], s["w1"], s["u0"], s["u1"]
    n0, n1, na, inv_sin = s["n0"], s["n1"], s["norm_angle"], s["inv_sin_na"]
    # forward (curve.cuh's seg_test terms)
    ez = cv._normalize(d)
    length = torch.sqrt(torch.clamp(cv._dot(d, d), min=1e-30))
    chord = cv._sub(cp[3], cp[0])
    up = cv._cross(d, chord)
    degen = cv._dot(up, up) < 1e-18
    use_a = ez[0].abs() > ez[1].abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(ez[0] * ez[0] + ez[2] * ez[2], min=1e-20))
    inv_b = 1.0 / torch.sqrt(torch.clamp(ez[1] * ez[1] + ez[2] * ez[2], min=1e-20))
    zero = torch.zeros_like(inv_a)
    up_fb = (torch.where(use_a, -ez[2] * inv_a, zero), torch.where(use_a, zero, ez[2] * inv_b),
             torch.where(use_a, ez[0] * inv_a, -ez[1] * inv_b))
    up = cv._where3(degen, up_fb, up)
    cu = cv._cross(up, ez)
    ex = cv._normalize(cu)
    ey = cv._cross(ez, ex)
    r = [cv._sub(p, o) for p in cp]
    q = [(cv._dot(ri, ex), cv._dot(ri, ey), cv._dot(ri, ez)) for ri in r]
    sdx, sdy = q[3][0] - q[0][0], q[3][1] - q[0][1]
    denom = sdx * sdx + sdy * sdy
    den_c = torch.clamp(denom, min=1e-20)
    w = ((-q[0][0]) * sdx + (-q[0][1]) * sdy) / den_c
    lu = cv._lerp(w, u0, u1)
    u = cv._clip(lu, u0, u1)
    span = torch.where(u1 == u0, 1.0, u1 - u0)
    lw = (u - u0) / span
    hw0 = cv._lerp(lw, w0, w1)
    straight = na < 1e-6
    s0 = torch.where(straight, 1.0 - lw, torch.sin((1.0 - lw) * na) * inv_sin)
    s1 = torch.where(straight, lw, torch.sin(lw * na) * inv_sin)
    n_hit = tuple(s0 * n0[k] + s1 * n1[k] for k in range(3))
    nd = cv._dot(n_hit, d)
    len_c = torch.clamp(length, min=1e-20)
    rs = nd.abs() / len_c
    ribbon = s["ctype"] == cv.RIBBON
    hw = torch.where(ribbon, hw0 * rs, hw0)
    wc = cv._clip(w, torch.zeros_like(w), torch.ones_like(w))
    a0, a1, a2 = (tuple(cv._lerp(wc, q[i][k], q[i + 1][k]) for k in range(3)) for i in range(3))
    b0 = tuple(cv._lerp(wc, a0[k], a1[k]) for k in range(3))
    b1 = tuple(cv._lerp(wc, a1[k], a2[k]) for k in range(3))
    pc = tuple(cv._lerp(wc, b0[k], b1[k]) for k in range(3))
    dpdw = tuple(3.0 * (b1[k] - b0[k]) for k in range(3))
    dp = cv._where3(cv._dot(dpdw, dpdw) < 1e-14, cv._sub(q[3], q[0]), dpdw)
    dist2 = pc[0] * pc[0] + pc[1] * pc[1]
    dist = torch.sqrt(torch.clamp(dist2, min=0.0))
    edge_func = dp[0] * (-pc[1]) + pc[0] * dp[1]
    hw_c = torch.clamp(hw, min=1e-20)
    ratio = dist / hw_c
    t = pc[2] / len_c
    # reverse
    g_len_c = -g_t * t / len_c
    g_ratio = torch.where(edge_func > 0.0, g_v, -g_v)
    g_dist = g_ratio / hw_c
    g_hw = torch.where(hw >= 1e-20, -g_ratio * ratio / hw_c, 0.0)
    g_dist2 = torch.where(dist2 > 0.0, g_dist * 0.5 / dist, 0.0)
    g_pc = (2.0 * pc[0] * g_dist2, 2.0 * pc[1] * g_dist2, g_t / len_c)
    g_wc = g_w + cv._dot(g_pc, dpdw)
    iw = 1.0 - wc
    bern = (iw * iw * iw, 3.0 * wc * iw * iw, 3.0 * wc * wc * iw, wc * wc * wc)
    g_q = [list(_scale(g_pc, b)) for b in bern]
    g_wr = torch.where((w > 0.0) & (w < 1.0), g_wc, 0.0)
    g_hw0 = torch.where(ribbon, g_hw * rs, g_hw)
    g_rs = torch.where(ribbon, g_hw * hw0, 0.0)
    g_nd = g_rs * _sgn(nd) / len_c
    g_len_c = g_len_c + -g_rs * rs / len_c
    gd = _scale(n_hit, g_nd)
    g_nhit = _scale(d, g_nd)
    g_s0, g_s1 = cv._dot(g_nhit, n0), cv._dot(g_nhit, n1)
    g_lw = g_hw0 * (w1 - w0)
    g_lw = torch.where(straight, g_lw + (g_s1 - g_s0),
                       g_lw + (-g_s0 * torch.cos((1.0 - lw) * na) * na * inv_sin
                               + g_s1 * torch.cos(lw * na) * na * inv_sin))
    g_uu = g_u + g_lw / span
    g_lu = torch.where((lu > u0) & (lu < u1), g_uu, 0.0)
    g_wr = g_wr + g_lu * (u1 - u0)
    g_num = g_wr / den_c
    g_den = torch.where(denom >= 1e-20, -g_wr * w / den_c, 0.0)
    g_sdx = -q[0][0] * g_num + 2.0 * sdx * g_den
    g_sdy = -q[0][1] * g_num + 2.0 * sdy * g_den
    g_q[0][0] = g_q[0][0] + (-sdx * g_num - g_sdx)
    g_q[0][1] = g_q[0][1] + (-sdy * g_num - g_sdy)
    g_q[3][0] = g_q[3][0] + g_sdx
    g_q[3][1] = g_q[3][1] + g_sdy
    zero3 = (zero, zero, zero)
    g_ex, g_ey, g_ez, go = zero3, zero3, zero3, zero3
    for i in range(4):
        g_r = _add(_add(_scale(ex, g_q[i][0]), _scale(ey, g_q[i][1])), _scale(ez, g_q[i][2]))
        go = cv._sub(go, g_r)
        g_ex = _add(g_ex, _scale(r[i], g_q[i][0]))
        g_ey = _add(g_ey, _scale(r[i], g_q[i][1]))
        g_ez = _add(g_ez, _scale(r[i], g_q[i][2]))
    g_ez = _add(g_ez, cv._cross(ex, g_ey))
    g_ex = _add(g_ex, cv._cross(g_ey, ez))
    g_cu = _normalize_vjp(cu, g_ex)
    g_up = cv._cross(ez, g_cu)
    g_ez = _add(g_ez, cv._cross(g_cu, up))
    # up = d x chord, or coordinate_system's axis of ez where degenerate
    gd = cv._where3(degen, gd, _add(gd, cv._cross(chord, g_up)))
    sa_ok = ez[0] * ez[0] + ez[2] * ez[2] >= 1e-20
    sb_ok = ez[1] * ez[1] + ez[2] * ez[2] >= 1e-20
    g_sa = torch.where(sa_ok, -0.5 * inv_a * inv_a * inv_a * (-g_up[0] * ez[2] + g_up[2] * ez[0]),
                       0.0)
    g_sb = torch.where(sb_ok, -0.5 * inv_b * inv_b * inv_b * (g_up[1] * ez[2] - g_up[2] * ez[1]),
                       0.0)
    fb_a = (g_ez[0] + (g_up[2] * inv_a + 2.0 * ez[0] * g_sa), g_ez[1],
            g_ez[2] + (-g_up[0] * inv_a + 2.0 * ez[2] * g_sa))
    fb_b = (g_ez[0], g_ez[1] + (-g_up[2] * inv_b + 2.0 * ez[1] * g_sb),
            g_ez[2] + (g_up[1] * inv_b + 2.0 * ez[2] * g_sb))
    g_ez = cv._where3(degen, cv._where3(use_a, fb_a, fb_b), g_ez)
    gd = _add(gd, _normalize_vjp(d, g_ez))
    keep = (length >= 1e-20) & (cv._dot(d, d) >= 1e-30)
    gd = tuple(torch.where(keep, gd[k] + d[k] * (g_len_c / length), gd[k]) for k in range(3))
    return go, gd


def curve_vjp_plain(o, d, seg, rows, g_t, g_u, g_v, g_w):
    """C5's twin: csrc/curve_grad.cu's reverse sweep of the leaf test,
    term by term, at each lane's segment seg (< 0: no hit, zeros), from
    the upstream gradients of t, u, v, w (N,), in o and d -> (g_o, g_d)
    (N, 3)."""
    g_o, g_d = torch.zeros_like(o), torch.zeros_like(d)
    idx = torch.nonzero((seg >= 0) & (seg < rows.shape[0])).flatten()
    if not idx.numel():
        return g_o, g_d
    go, gd = _seg_vjp(cv._vec(o[idx]), cv._vec(d[idx]), rows[seg[idx].long()], g_t[idx],
                      g_u[idx], g_v[idx], g_w[idx])
    g_o[idx] = torch.stack(go, -1)
    g_d[idx] = torch.stack(gd, -1)
    return g_o, g_d


def curve_vjp(o, d, seg, rows, g_t, g_u, g_v, g_w):
    """C5 for CUDA tensors, curve_vjp_plain for CPU ones: (g_o, g_d)."""
    if o.device.type == "cpu":
        return curve_vjp_plain(o, d, seg, rows, g_t, g_u, g_v, g_w)
    what = "curve_vjp"
    n = o.shape[0]
    _check(what, "o", o, torch.float32, (n, 3))
    _check(what, "d", d, torch.float32, (n, 3))
    _check(what, "seg", seg, torch.int32, (n,))
    _check(what, "rows", rows, torch.float32, (rows.shape[0], N_CURVE_ATTR))
    for name, g in (("g_t", g_t), ("g_u", g_u), ("g_v", g_v), ("g_w", g_w)):
        _check(what, name, g, torch.float32, (n,))
    if n >= 1 << 31 or rows.shape[0] >= 1 << 31:
        raise ValueError(f"{what}: {n} lanes, {rows.shape[0]} rows")
    g_o, g_d = torch.empty_like(o), torch.empty_like(d)
    with torch.cuda.device(o.device):
        err = _grad_kernel()(
            o.data_ptr(), d.data_ptr(), seg.data_ptr(), rows.data_ptr(), rows.shape[0],
            g_t.data_ptr(), g_u.data_ptr(), g_v.data_ptr(), g_w.data_ptr(), n, g_o.data_ptr(),
            g_d.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "curve_vjp kernel launch")
    launches["curve_grad"] += 1
    return g_o, g_d


class CurveHitFn(torch.autograd.Function):
    """(valid, t, seg, w, u, v) of the closest curve hit, differentiable in
    o and d (and in t_max, which a lane without a hit returns as its t):
    forward ``closest(o, d, t_max)`` (C1 or C3 on detached rays ->
    CurveHit), backward ``curve_vjp`` (C5)."""

    @staticmethod
    def forward(ctx, o, d, t_max, rows, closest):
        h = closest(o.detach(), d.detach(), t_max.detach())
        seg = torch.where(h.valid, h.seg, -1).to(torch.int32)
        ctx.save_for_backward(o.detach(), d.detach(), seg, rows.detach(), h.valid)
        ctx.mark_non_differentiable(h.valid, h.seg)
        return h.valid, h.t, h.seg, h.w, h.u, h.v

    @staticmethod
    def backward(ctx, _g_valid, g_t, _g_seg, g_w, g_u, g_v):
        o, d, seg, rows, valid = ctx.saved_tensors
        zero = lambda g: torch.zeros_like(o[:, 0]) if g is None else g.contiguous()
        g_o, g_d = curve_vjp(o.contiguous(), d.contiguous(), seg, rows.contiguous(), zero(g_t),
                             zero(g_u), zero(g_v), zero(g_w))
        g_t_max = None
        if ctx.needs_input_grad[2] and g_t is not None:
            g_t_max = torch.where(valid, 0.0, g_t)
        return (g_o if ctx.needs_input_grad[0] else None,
                g_d if ctx.needs_input_grad[1] else None, g_t_max, None, None)


def diff_curve_hit(o, d, t_max, rows, closest) -> cv.CurveHit:
    """The closest curve hit of rays o, d within t_max through closest(o,
    d, t_max) -> CurveHit (C1 or C3 on detached rays), with t, u, v and w
    differentiable in o and d through C5."""
    return cv.CurveHit(*CurveHitFn.apply(o, d, t_max, rows, closest))
