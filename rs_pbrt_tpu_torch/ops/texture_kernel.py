"""T1: texture evaluation, the kernel's wrapper, and its backward passes T2
and T3.

``texture_eval(tb, ids, uv, p, width=None)`` evaluates the JAX package's
``eval_texture`` (ops/texture.py:286) for each lane: ids (S, N) int32,
S rows of textures at the same N points, so that one launch serves a
shading step's bound slots, a bump map's three evaluations or an alpha
test's two masks; uv (N, 2) and p (N, 3) shared by the rows, or (S, N, 2)
and (S, N, 3); width (N,) the texture-space footprint, or None (level 0
without reading the pyramid).  Returns (S, N, 3) f32, zeros on lanes whose
id is negative.  On CUDA tensors it launches the kernel of
``csrc/texture.cu`` (one thread a lane, a switch on the lane's texture
type); on CPU tensors it runs the plain version,
``ops/texture.eval_texture``.

Where autograd records through the tables' params or atlas, or through
uv, p or width (a camera or geometry gradient on a textured surface), the
lookup is ``TextureFn``: its forward is the same launch on detached
inputs; its backward launches, for the inputs that need a gradient,
``texture_grad`` (T2), the vector-Jacobian product in tex_params (X, 16)
and tex_atlas (AH, AW, 3), and ``texture_coord_grad`` (T3), the one in
uv, p and width; both in ``csrc/texture_grad.cu`` on CUDA tensors, their
twins on CPU ones: ``texture_grad_plain`` by autograd of the plain
lookup, ``texture_coord_grad_plain`` the kernel's sweep term by term.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .autodiff import tracks
from . import texture as tx
from .texture import TexTables, eval_texture
from ..utils import transform as tr

# kernel launches of T1, T2 and T3; the plain versions count none
launches = {"texture_eval": 0, "texture_grad": 0, "texture_coord_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("texture").rs_texture_eval
    # type, params, child, w2t, atlas, rect, mip, nlv, perm, n_tex, ah, aw,
    # kind_mask, ids, uv, p, width, n, rows, per_row, out, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P, _P]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _grad_kernel():
    fn = _build.load("texture_grad").rs_texture_grad
    # T1's arguments without out, then g_out, g_params, g_atlas, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _coord_kernel():
    fn = _build.load("texture_grad").rs_texture_coord_grad
    # T1's arguments without out, then g_out, g_uv, g_p, g_width, stream
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P] * 5
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"texture_eval: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"texture_eval: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def plain(tb: TexTables, ids, uv, p, width=None):
    """The plain version at the wrapper's shapes: (S, N, 3)."""
    ids2 = ids if ids.dim() == 2 else ids[None]
    return eval_texture(tb, ids2, uv, p, width)


def texture_eval(tb: TexTables, ids, uv, p, width=None):
    """T1 on the lanes ids (S, N) (a (N,) ids is one row); the plain
    version on the CPU.  (S, N, 3).  Through TextureFn where autograd
    records through tb.params, tb.atlas, uv, p or width."""
    if tracks(tb.params, tb.atlas, uv, p, width):
        return TextureFn.apply(tb.params, tb.atlas, uv, p, width, tb, ids)
    return _eval(tb, ids, uv, p, width)


def _tables(tb: TexTables, ids, uv, p, width, what: str):
    """The launch's checked arguments: (ids (S, N) int32, uv, p, width,
    per_row), each contiguous."""
    ids = (ids if ids.dim() == 2 else ids[None]).to(torch.int32).contiguous()
    rows, n = ids.shape
    per_row = uv.dim() == 3
    uv, p = uv.contiguous(), p.contiguous()
    if rows * n >= (1 << 31) or tb.type.shape[0] >= (1 << 30):
        raise ValueError(f"{what}: {rows} x {n} lanes")
    lead = (rows, n) if per_row else (n,)
    X = tb.type.shape[0]
    ah, aw = tb.atlas.shape[0], tb.atlas.shape[1]
    for name, t, dtype, shape in (
            ("type", tb.type, torch.int32, (X,)), ("params", tb.params, torch.float32, (X, 16)),
            ("child", tb.child, torch.int32, (X, 2)), ("w2t", tb.w2t, torch.float32, (X, 4, 4)),
            ("atlas", tb.atlas, torch.float32, (ah, aw, 3)),
            ("rect", tb.rect, torch.int32, (X, 4)),
            ("mip", tb.mip, torch.int32, (X, tb.mip.shape[1], 3)),
            ("nlv", tb.nlv, torch.int32, (X,)), ("perm", tb.perm, torch.int32, (512,)),
            ("ids", ids, torch.int32, (rows, n)), ("uv", uv, torch.float32, lead + (2,)),
            ("p", p, torch.float32, lead + (3,))):
        _check(name, t, dtype, shape)
    if tb.mip.shape[1] != 12:
        raise ValueError(f"{what}: mip must hold 12 levels, not {tb.mip.shape[1]}")
    if width is not None:
        width = width.contiguous()
        _check("width", width, torch.float32, (n,))
    return ids, uv, p, width, per_row


def _table_ptrs(tb: TexTables) -> list:
    return [tb.type.data_ptr(), tb.params.data_ptr(), tb.child.data_ptr(), tb.w2t.data_ptr(),
            tb.atlas.data_ptr(), tb.rect.data_ptr(), tb.mip.data_ptr(), tb.nlv.data_ptr(),
            tb.perm.data_ptr(), tb.type.shape[0], tb.atlas.shape[0], tb.atlas.shape[1],
            tb.kind_mask]


def _eval(tb: TexTables, ids, uv, p, width=None):
    """T1's launch (the plain version on the CPU)."""
    if ids.device.type == "cpu":
        return plain(tb, ids, uv, p, width)
    ids, uv, p, width, per_row = _tables(tb, ids, uv, p, width, "texture_eval")
    rows, n = ids.shape
    out = torch.empty((rows, n, 3), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = _kernel()(
            *_table_ptrs(tb), ids.data_ptr(), uv.data_ptr(), p.data_ptr(),
            None if width is None else width.data_ptr(), n, rows, int(per_row),
            out.data_ptr(), torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_eval kernel launch")
    launches["texture_eval"] += 1
    return out


def texture_grad_plain(tb: TexTables, ids, uv, p, width, g_out):
    """T2's plain version: the vector-Jacobian product of the plain
    eval_texture at these lanes with g_out (S, N, 3), by autograd through
    its ops, in the tables' params and atlas -> (g_params (X, 16), g_atlas
    (AH, AW, 3))."""
    params = tb.params.detach().requires_grad_(True)
    atlas = tb.atlas.detach().requires_grad_(True)
    det = lambda t: None if t is None else t.detach()
    with torch.enable_grad():
        out = plain(tb._replace(params=params, atlas=atlas), ids, det(uv), det(p), det(width))
        gp, ga = torch.autograd.grad(out, [params, atlas], g_out.reshape(out.shape),
                                     allow_unused=True)
    return (torch.zeros_like(params) if gp is None else gp,
            torch.zeros_like(atlas) if ga is None else ga)


def texture_grad(tb: TexTables, ids, uv, p, width, g_out):
    """T2 for CUDA tensors, texture_grad_plain for CPU ones: (g_params
    (X, 16), g_atlas (AH, AW, 3)) of T1's lanes ids, uv, p, width with the
    upstream gradient g_out (S, N, 3)."""
    if ids.device.type == "cpu":
        return texture_grad_plain(tb, ids, uv, p, width, g_out)
    ids, uv, p, width, per_row = _tables(tb, ids, uv, p, width, "texture_grad")
    rows, n = ids.shape
    g_out = g_out.reshape(rows, n, 3).contiguous()
    _check("g_out", g_out, torch.float32, (rows, n, 3))
    g_params = torch.zeros_like(tb.params)
    g_atlas = torch.zeros_like(tb.atlas)
    with torch.cuda.device(ids.device):
        err = _grad_kernel()(
            *_table_ptrs(tb), ids.data_ptr(), uv.data_ptr(), p.data_ptr(),
            None if width is None else width.data_ptr(), n, rows, int(per_row),
            g_out.data_ptr(), g_params.data_ptr(), g_atlas.data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_grad kernel launch")
    launches["texture_grad"] += 1
    return g_params, g_atlas


_LN2 = 0.693147180559945309


def _noise_weight_d(t):
    """d noise_weight / dt: 30 t^4 - 60 t^3 + 30 t^2."""
    t2 = t * t
    return 30.0 * t2 * t2 - 60.0 * t2 * t + 30.0 * t2


def _noise_vjp(perm, x, y, z, g):
    """g times the Perlin noise's gradient at (x, y, z) (N,) each, as
    csrc/texture_grad.cu noise_vjp sums it: the weights' terms, then each
    lattice corner's gradient vector in corner order -> [gx, gy, gz]."""
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    dx, dy, dz = x - fx, y - fy, z - fz
    ix, iy, iz = (f.long() & 255 for f in (fx, fy, fz))
    gr = lambda a, b, c, u, v, w: tx.grad(perm, ix + a, iy + b, iz + c, u, v, w)
    w000 = gr(0, 0, 0, dx, dy, dz)
    w100 = gr(1, 0, 0, dx - 1.0, dy, dz)
    w010 = gr(0, 1, 0, dx, dy - 1.0, dz)
    w110 = gr(1, 1, 0, dx - 1.0, dy - 1.0, dz)
    w001 = gr(0, 0, 1, dx, dy, dz - 1.0)
    w101 = gr(1, 0, 1, dx - 1.0, dy, dz - 1.0)
    w011 = gr(0, 1, 1, dx, dy - 1.0, dz - 1.0)
    w111 = gr(1, 1, 1, dx - 1.0, dy - 1.0, dz - 1.0)
    nw = tx._noise_weight
    wx, wy, wz = nw(dx), nw(dy), nw(dz)
    x00, x10 = tx._lerp(wx, w000, w100), tx._lerp(wx, w010, w110)
    x01, x11 = tx._lerp(wx, w001, w101), tx._lerp(wx, w011, w111)
    y0, y1 = tx._lerp(wy, x00, x10), tx._lerp(wy, x01, x11)
    g_wz = g * (y1 - y0)
    g_y0, g_y1 = g * (1.0 - wz), g * wz
    g_wy = g_y0 * (x10 - x00) + g_y1 * (x11 - x01)
    g_x00, g_x10 = g_y0 * (1.0 - wy), g_y0 * wy
    g_x01, g_x11 = g_y1 * (1.0 - wy), g_y1 * wy
    g_wx = (g_x00 * (w100 - w000) + g_x10 * (w110 - w010) + g_x01 * (w101 - w001)
            + g_x11 * (w111 - w011))
    gd = [g_wx * _noise_weight_d(dx), g_wy * _noise_weight_d(dy), g_wz * _noise_weight_d(dz)]
    a = 1.0 - wx
    for (cx, cy, cz), gw in (((0, 0, 0), g_x00 * a), ((1, 0, 0), g_x00 * wx),
                             ((0, 1, 0), g_x10 * a), ((1, 1, 0), g_x10 * wx),
                             ((0, 0, 1), g_x01 * a), ((1, 0, 1), g_x01 * wx),
                             ((0, 1, 1), g_x11 * a), ((1, 1, 1), g_x11 * wx)):
        h = perm[(perm[(perm[ix + cx] + iy + cy).long()] + iz + cz).long()] & 15
        su = torch.where((h & 1) > 0, -gw, gw)
        sv = torch.where((h & 2) > 0, -gw, gw)
        first = (h < 8) | (h == 12) | (h == 13)
        gd[0] = torch.where(first, gd[0] + su, gd[0])
        gd[1] = torch.where(first, gd[1], gd[1] + su)
        second = (h < 4) | (h == 12) | (h == 13)
        gd[1] = torch.where(second, gd[1] + sv, gd[1])
        gd[2] = torch.where(second, gd[2], gd[2] + sv)
    return gd


def _fbm_vjp(perm, p, omega, octaves, turb: bool, g):
    """g times fbm's (turbulence's, turb) gradient at p (N, 3) in p, its
    first `octaves` octaves (csrc/texture_grad.cu fbm_vjp) -> [gx, gy, gz]."""
    gp = [torch.zeros_like(g) for _ in range(3)]
    o = torch.ones_like(g)
    for i, lam in enumerate(tx.OCTAVE_LAMBDA):
        q = [p[:, k] * lam for k in range(3)]
        gg = g * o
        if turb:
            gg = gg * torch.sign(tx.noise(tx._consts(p.device)[0], torch.stack(q, -1)))
        gq = _noise_vjp(perm, *q, gg)
        on = i < octaves
        gp = [torch.where(on, gp[k] + gq[k] * lam, gp[k]) for k in range(3)]
        o = o * omega
    return gp


def _xform_point_vjp(m, p, g_pt):
    """g_pt, the gradient at xform_point(m, p), carried back to p (N, 3):
    m's rows over the homogeneous w, less the divide's term."""
    row = lambda i: m[:, i, 0] * p[:, 0] + m[:, i, 1] * p[:, 1] + m[:, i, 2] * p[:, 2]
    w = row(3) + m[:, 3, 3]
    g_w = torch.zeros_like(w)
    for i in range(3):
        out = (row(i) + m[:, i, 3]) / w
        g_w = g_w - g_pt[i] * out / w
    return torch.stack([(g_pt[0] * m[:, 0, k] + g_pt[1] * m[:, 1, k] + g_pt[2] * m[:, 2, k]) / w
                        + g_w * m[:, 3, k] for k in range(3)], -1)


def _atlas_vjp(atlas, rect, u, v, g):
    """The bilinear fetch's gradient in (u, v) from g (N, 3) at the rects
    (N, 4) (csrc/texture_grad.cu atlas_vjp) -> (g_u, g_v); black lanes 0."""
    h, w = rect[:, 1].to(torch.float32), rect[:, 2].to(torch.float32)
    wrap = rect[:, 3]
    uu = u * w - 0.5
    vv = (1.0 - v) * h - 0.5

    def wrapc(x, n):
        clm = torch.minimum(torch.clamp(x, min=0.0), n - 1.0)
        return torch.where(wrap == 0, torch.remainder(x, n), clm)

    x0, y0f = torch.floor(uu), torch.floor(vv)
    fx, fy = uu - x0, vv - y0f
    black = (wrap == 2) & ((uu < -0.5) | (uu > w - 0.5) | (vv < -0.5) | (vv > h - 0.5))
    ah, aw = atlas.shape[0], atlas.shape[1]
    g_fx, g_fy = torch.zeros_like(u), torch.zeros_like(u)
    for dy in (0, 1):
        for dx in (0, 1):
            xs = wrapc(x0 + dx, w).long()
            ys = wrapc(y0f + dy, h).long() + rect[:, 0]
            texel = atlas[torch.clamp(ys, 0, ah - 1), torch.clamp(xs, 0, aw - 1)]
            wx, wy = (fx if dx else 1.0 - fx), (fy if dy else 1.0 - fy)
            g_w = torch.zeros_like(u)
            for k in range(3):
                g_w = g_w + g[:, k] * texel[:, k]
            g_fx = g_fx + (g_w * wy if dx else -(g_w * wy))
            g_fy = g_fy + (g_w * wx if dy else -(g_w * wx))
    g_fx, g_fy = torch.where(black, 0.0, g_fx), torch.where(black, 0.0, g_fy)
    return g_fx * w, -(g_fy * h)


def _leaf_coord_vjp(tb: TexTables, tid, uv, p, width, g):
    """The leaf textures tid's (N,) gradients in the lanes' uv (N, 2), p
    (N, 3) and width (N,) or None from g (N, 3), each family's on its own
    lanes (csrc/texture_grad.cu leaf_vjp with a Coord) -> (g_u, g_v, g_p,
    g_width)."""
    has = lambda t: bool(tb.kind_mask & (1 << t))
    tp, ttype = tb.params[tid], tb.type[tid]
    u, v, su, sv = tx._mapped_uv(tp, uv)
    perm = tx._consts(uv.device)[0]
    zero = torch.zeros_like(u)
    g_u, g_v, g_w = zero, zero, zero
    g_p = torch.zeros_like(p)
    noise = [t for t in tx.NOISE_FAMILIES if has(t)]
    if noise and bool(torch.isin(ttype, torch.tensor(noise, device=u.device)).any()):
        m = tb.w2t[tid]
        pt = tr.xform_point(m, p)
        octs = torch.clamp(tp[:, tx.TP_OCTAVES].to(torch.int32), 1, tx.MAX_OCTAVES)
        omega = torch.where(tp[:, tx.TP_OMEGA] == 0.0, 0.5, tp[:, tx.TP_OMEGA])
        value = tp[:, tx.TP_VALUE:tx.TP_VALUE + 3]
        g_f = g[:, 0] * value[:, 0] + g[:, 1] * value[:, 1] + g[:, 2] * value[:, 2]
        g_pt = [zero, zero, zero]
        pick = lambda on, new: [torch.where(on, a, b) for a, b in zip(new, g_pt)]
        for t, turb in ((tx.TEX_FBM, False), (tx.TEX_WRINKLED, True)):
            if has(t):
                g_pt = pick(ttype == t, _fbm_vjp(perm, pt, omega, octs, turb, g_f))
        if has(tx.TEX_WINDY):
            pw = 0.100000001490116119 * pt
            six = torch.full_like(octs, 6)
            three = torch.full_like(octs, 3)
            a = tx.fbm(perm, pw, 0.5, three)
            b = tx.fbm(perm, pt, 0.5, six)
            g_pw = _fbm_vjp(perm, pw, 0.5, three, False, g_f * b * torch.sign(a))
            gb = _fbm_vjp(perm, pt, 0.5, six, False, g_f * a.abs())
            g_pt = pick(ttype == tx.TEX_WINDY,
                        [gb[k] + 0.100000001490116119 * g_pw[k] for k in range(3)])
        if has(tx.TEX_MARBLE):
            marble_c = tx._consts(u.device)[1]
            scale_n = torch.where(tp[:, tx.TP_SCALE_N] == 0.0, 1.0, tp[:, tx.TP_SCALE_N])
            variation = tp[:, tx.TP_VARIATION]
            first = scale_n[:, None] * pt
            f = tx.fbm(perm, first, omega, octs)
            arg = first[:, 1] + variation * f
            t_ = torch.sin(arg) * 0.5 + 0.5
            tt = torch.clamp(t_, 0.0, 0.9999) * 6.0
            i = tt.long()
            ft = tt - i.to(torch.float32)
            a = 1.0 - ft
            ds = (-3.0 * a * a, 3.0 * a * a - 6.0 * ft * a, 6.0 * ft * a - 3.0 * ft * ft,
                  3.0 * ft * ft)
            cm = [marble_c[torch.clamp(i + k, 0, marble_c.shape[0] - 1)] for k in range(4)]
            g_ft = torch.zeros_like(u)
            for k in range(3):
                g_ft = g_ft + 1.5 * g[:, k] * (ds[0] * cm[0][:, k] + ds[1] * cm[1][:, k]
                                               + ds[2] * cm[2][:, k] + ds[3] * cm[3][:, k])
            inside = (t_ > 0.0) & (t_ < 0.9999)
            g_arg = torch.where(inside, g_ft * 6.0 * 0.5 * torch.cos(arg), 0.0)
            gq = _fbm_vjp(perm, first, omega, octs, False, g_arg * variation)
            g_first = [gq[0], g_arg + gq[1], gq[2]]
            g_pt = pick(ttype == tx.TEX_MARBLE, [g_first[k] * scale_n for k in range(3)])
        is_noise = torch.isin(ttype, torch.tensor(noise, device=u.device))
        g_p = torch.where(is_noise[:, None], _xform_point_vjp(m, p, g_pt), g_p)
    if has(tx.TEX_UV):
        is_uv = ttype == tx.TEX_UV
        g_u, g_v = torch.where(is_uv, g[:, 0], g_u), torch.where(is_uv, g[:, 1], g_v)
    if has(tx.TEX_IMAGEMAP) and bool((ttype == tx.TEX_IMAGEMAP).any()):
        gi = g * tp[:, tx.TP_GAMMA_SCALE, None]
        if width is None:
            iu, iv = _atlas_vjp(tb.atlas, tb.rect[tid], u, v, gi)
            iw = zero
        else:
            a_, b_ = su.abs(), sv.abs()
            smax = torch.maximum(a_, b_)
            weff = width * smax
            nlv_i = tb.nlv[tid]
            nlv = nlv_i.to(torch.float32)
            raw = nlv - 1.0 + torch.log2(torch.clamp(weff, min=1e-8))
            top = torch.clamp(nlv - 1.0, min=0.0)
            level = torch.minimum(torch.clamp(raw, min=0.0), top)
            l0 = torch.floor(level).long()
            l1 = torch.minimum(l0 + 1, torch.clamp(nlv_i - 1, min=0).long())
            f = level - l0.to(torch.float32)
            wrap = tb.rect[tid][:, 3:4]
            mip = tb.mip[tid]
            rect_at = lambda lv: torch.cat([mip.gather(1, lv[:, None, None].expand(-1, 1, 3))[:, 0],
                                            wrap], -1)
            r0, r1 = rect_at(l0), rect_at(l1)
            c0 = tx.atlas_lookup(tb.atlas, r0, u, v)
            c1 = tx.atlas_lookup(tb.atlas, r1, u, v)
            gu0, gv0 = _atlas_vjp(tb.atlas, r0, u, v, gi * (1.0 - f)[:, None])
            gu1, gv1 = _atlas_vjp(tb.atlas, r1, u, v, gi * f[:, None])
            iu, iv = gu0 + gu1, gv0 + gv1
            g_f = (gi[:, 0] * (c1[:, 0] - c0[:, 0]) + gi[:, 1] * (c1[:, 1] - c0[:, 1])
                   + gi[:, 2] * (c1[:, 2] - c0[:, 2]))
            on = (raw > 0.0) & (raw < top) & (weff > 1e-8)
            iw = torch.where(on, g_f / (weff * _LN2) * smax, 0.0)
        is_img = ttype == tx.TEX_IMAGEMAP
        g_u, g_v = torch.where(is_img, iu, g_u), torch.where(is_img, iv, g_v)
        g_w = torch.where(is_img, iw, g_w)
    return g_u * su, g_v * sv, g_p, g_w


def _coord_vjp(tb: TexTables, ids, uv, p, width, g):
    """One row's gradients in uv, p and width from g (N, 3) at ids (N,)
    (csrc/texture_grad.cu texture_vjp with a Coord): a leaf's own, or a
    combinator's children's, the first child's then the second's."""
    n_tex = tb.type.shape[0]
    live = (ids >= 0) & (g != 0.0).any(-1)
    tid = torch.clamp(ids, 0, n_tex - 1).long()
    ttype = tb.type[tid]
    comb = live & torch.isin(ttype, torch.tensor(tx.COMBINATORS, device=ids.device))
    c1 = torch.clamp(tb.child[tid, 0], 0, n_tex - 1).long()
    c2 = torch.clamp(tb.child[tid, 1], 0, n_tex - 1).long()
    g1, g2 = g, torch.zeros_like(g)
    if bool(comb.any()):
        v1 = tx.eval_leaf(tb, c1, uv, p, width)
        v2 = tx.eval_leaf(tb, c2, uv, p, width)
        tp = tb.params[tid]
        u, v, _, _ = tx._mapped_uv(tp, uv)
        amt = tp[:, tx.TP_VALUE, None]
        check = (torch.floor(u).long() + torch.floor(v).long()) % 2 == 0
        perm = tx._consts(u.device)[0]
        s_cell, t_cell = torch.floor(u + 0.5), torch.floor(v + 0.5)
        cell = torch.stack([s_cell, t_cell, torch.zeros_like(s_cell)], -1)
        off = lambda a, b: torch.tensor([a, b, 0.0], device=u.device)
        has_dot = tx.noise(perm, cell + 0.5) > 0.0
        cx = s_cell + 0.35 * tx.noise(perm, cell + off(1.5, 2.8))
        cy = t_cell + 0.35 * tx.noise(perm, cell + off(4.5, 9.8))
        dot_in = has_dot & ((u - cx) * (u - cx) + (v - cy) * (v - cy) < tx.DOT_RADIUS2)
        first = torch.where(ttype == tx.TEX_CHECKER, check, dot_in)[:, None]
        sel = lambda t: (ttype == t)[:, None]
        zero = torch.zeros_like(g)
        g1 = torch.where(sel(tx.TEX_SCALE), g * v2, torch.where(
            sel(tx.TEX_MIX), g * (1.0 - amt), torch.where(first, g, zero)))
        g2 = torch.where(sel(tx.TEX_SCALE), g * v1, torch.where(
            sel(tx.TEX_MIX), g * amt, torch.where(first, zero, g)))
        g1 = torch.where(comb[:, None], g1, g)
    a = _leaf_coord_vjp(tb, torch.where(comb, c1, tid), uv, p, width, g1)
    out = [torch.where(live, x, 0.0) if x.dim() == 1 else torch.where(live[:, None], x, 0.0)
           for x in a]
    if bool(comb.any()):
        b = _leaf_coord_vjp(tb, c2, uv, p, width, g2)
        out = [torch.where(comb if x.dim() == 1 else comb[:, None], x + y, x)
               for x, y in zip(out, b)]
    return out


def texture_coord_grad_plain(tb: TexTables, ids, uv, p, width, g_out):
    """T3's plain version: csrc/texture_grad.cu's reverse sweep in the
    lanes' coordinates, term by term: (g_uv, g_p, g_width) of uv's, p's
    and width's shapes (g_width None without a width), the rows' sums
    where they share the points, with the upstream gradient g_out (S, N,
    3)."""
    tb = tb._replace(params=tb.params.detach(), atlas=tb.atlas.detach())
    ids2 = ids if ids.dim() == 2 else ids[None]
    rows, n = ids2.shape
    g_out = g_out.reshape(rows, n, 3)
    per_row = uv.dim() == 3
    g_uv, g_p = torch.zeros_like(uv), torch.zeros_like(p)
    g_w = None if width is None else torch.zeros_like(width)
    for s in range(rows):
        gu, gv, gp, gw = _coord_vjp(tb, ids2[s], uv[s] if per_row else uv,
                                    p[s] if per_row else p, width, g_out[s])
        if per_row:
            g_uv[s] = torch.stack([gu, gv], -1)
            g_p[s] = gp
        else:
            g_uv = g_uv + torch.stack([gu, gv], -1)
            g_p = g_p + gp
        if g_w is not None:
            g_w = g_w + gw
    return g_uv, g_p, g_w


def texture_coord_grad(tb: TexTables, ids, uv, p, width, g_out):
    """T3 for CUDA tensors, texture_coord_grad_plain for CPU ones: (g_uv,
    g_p, g_width) of T1's lanes ids, uv, p, width with the upstream
    gradient g_out (S, N, 3)."""
    if ids.device.type == "cpu":
        return texture_coord_grad_plain(tb, ids, uv, p, width, g_out)
    ids, uv, p, width, per_row = _tables(tb, ids, uv, p, width, "texture_coord_grad")
    rows, n = ids.shape
    g_out = g_out.reshape(rows, n, 3).contiguous()
    _check("g_out", g_out, torch.float32, (rows, n, 3))
    g_uv, g_p = torch.empty_like(uv), torch.empty_like(p)
    g_width = None if width is None else torch.empty_like(width)
    with torch.cuda.device(ids.device):
        err = _coord_kernel()(
            *_table_ptrs(tb), ids.data_ptr(), uv.data_ptr(), p.data_ptr(),
            None if width is None else width.data_ptr(), n, rows, int(per_row),
            g_out.data_ptr(), g_uv.data_ptr(), g_p.data_ptr(),
            None if g_width is None else g_width.data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "texture_coord_grad kernel launch")
    launches["texture_coord_grad"] += 1
    return g_uv, g_p, g_width


class TextureFn(torch.autograd.Function):
    """T1's lookup, differentiable in the tables' params and atlas and in
    the lanes' uv, p and width: forward T1 on detached inputs, backward T2
    (texture_grad) for the tables and T3 (texture_coord_grad) for the
    coordinates, each launched only where its inputs need a gradient."""

    @staticmethod
    def forward(ctx, params, atlas, uv, p, width, tb, ids):
        tb = tb._replace(params=params.detach(), atlas=atlas.detach())
        det = lambda t: None if t is None else t.detach()
        uv, p, width = det(uv), det(p), det(width)
        ctx.tb, ctx.width = tb, width
        ctx.save_for_backward(ids, uv, p)
        return _eval(tb, ids, uv, p, width)

    @staticmethod
    def backward(ctx, g_out):
        ids, uv, p = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_params = g_atlas = g_uv = g_p = g_width = None
        if need[0] or need[1]:
            g_params, g_atlas = texture_grad(ctx.tb, ids, uv, p, ctx.width, g_out)
        if need[2] or need[3] or need[4]:
            g_uv, g_p, g_width = texture_coord_grad(ctx.tb, ids, uv, p, ctx.width, g_out)
        keep = lambda k, g: g if need[k] else None
        return (keep(0, g_params), keep(1, g_atlas), keep(2, g_uv), keep(3, g_p),
                keep(4, g_width), None, None)
