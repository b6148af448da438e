"""Texture evaluation: Perlin noise, the image atlas and the per-lane
texture switch, in plain PyTorch.

The port of the JAX package's ``ops/texture.py`` (reference
src/core/texture.rs Perlin noise :295-424, mappings :51-284, and the twelve
classes of src/textures/*).  Textures live in the scene's flat tables: a
type tag, 16 parameters and two child references a row, world-to-texture
transforms, and every image's MIP pyramid stacked into one atlas (one rect
per texture and level, ``ops/mipmap.py``).  ``eval_texture`` is T1's plain
version (``ops/texture_kernel.py``, ``csrc/texture.cu``): it evaluates the
JAX way, every family of the scene's kind mask that the lanes reach on
every lane, then selects each lane's own, with one level of nesting (a scale, mix, checker
or dots texture evaluates its children as leaves).  Lanes whose id is
negative (an unbound slot) give zeros: every caller keeps only the lanes
of a bound texture.  ``atlas_lookup`` alone serves the projection and
goniometric lights (``models/lights.py``).  The noise reads the reference's
512-entry permutation table, ``data/noise_tables.npz``.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..utils import transform as tr

# texture type tags (reference src/textures/*)
TEX_CONSTANT = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_CHECKER = 3
TEX_DOTS = 4
TEX_FBM = 5
TEX_WRINKLED = 6
TEX_MARBLE = 7
TEX_WINDY = 8
TEX_IMAGEMAP = 9
TEX_UV = 10
TEX_BILERP = 11

# tex_params columns
TP_VALUE = 0  # 0:3 constant rgb; a scale's factor; a mix's amount in column 0
TP_SU = 3  # the uv mapping's scale and offset
TP_SV = 4
TP_DU = 5
TP_DV = 6
TP_OMEGA = 7
TP_OCTAVES = 8
TP_VARIATION = 9  # marble
TP_SCALE_N = 10  # marble's noise scale
TP_WRAP = 11  # an image map's wrap: 0 repeat, 1 clamp, 2 black
TP_GAMMA_SCALE = 12  # an image map's scale factor
N_TEX_PARAMS = 16

MAX_OCTAVES = 8
NOISE_FAMILIES = (TEX_FBM, TEX_WRINKLED, TEX_MARBLE, TEX_WINDY)
COMBINATORS = (TEX_SCALE, TEX_MIX, TEX_CHECKER, TEX_DOTS)


def _octave_lambdas():
    """Each octave's frequency: 1.99^i by repeated products in double, as
    the JAX fbm's Python float, used in f32."""
    lam, out = 1.0, []
    for _ in range(MAX_OCTAVES):
        out.append(float(np.float32(lam)))
        lam *= 1.99
    return tuple(out)


OCTAVE_LAMBDA = _octave_lambdas()
# dots (textures/dots.rs): the dot radius, squared in double and used in f32
DOT_RADIUS2 = float(np.float32((0.35 * 0.7) * (0.35 * 0.7)))

# the marble colour spline's nine control points (textures/marble.rs)
MARBLE_C = np.asarray(
    [[0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
     [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
     [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6]], np.float32)

_DATA = Path(__file__).resolve().parent.parent / "data" / "noise_tables.npz"


@lru_cache(maxsize=None)
def _noise_perm_np() -> np.ndarray:
    return np.load(_DATA)["noise_perm"].astype(np.int32)


@lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(noise permutation (512,) int32, marble control points (9, 3)) on
    device."""
    return (torch.as_tensor(_noise_perm_np(), device=device),
            torch.as_tensor(MARBLE_C, device=device))


class TexTables(NamedTuple):
    """The scene's texture tables, as T1 reads them."""

    type: torch.Tensor  # (X,) int32
    params: torch.Tensor  # (X, N_TEX_PARAMS) f32
    child: torch.Tensor  # (X, 2) int32, -1 none
    w2t: torch.Tensor  # (X, 4, 4) f32 world to texture space
    atlas: torch.Tensor  # (AH, AW, 3) f32 every image's pyramid
    rect: torch.Tensor  # (X, 4) int32 level 0's (y0, h, w) and the wrap mode
    mip: torch.Tensor  # (X, MAX_LEVELS, 3) int32 each level's (y0, h, w)
    nlv: torch.Tensor  # (X,) int32 the pyramid's levels
    perm: torch.Tensor  # (512,) int32 the noise permutation
    kind_mask: int  # bit t set for the leaf families the scene evaluates


def tables_of(scene) -> TexTables:
    """The scene's TexTables.  The kind mask is the scene's tex_kind_mask,
    with the image map's bit cleared where the atlas has one row (the JAX
    eval_leaf reads no image then)."""
    mask = scene.tex_kind_mask
    if scene.tex_atlas.shape[0] <= 1:
        mask &= ~(1 << TEX_IMAGEMAP)
    return TexTables(scene.tex_type, scene.tex_params, scene.tex_child, scene.tex_w2t,
                     scene.tex_atlas, scene.tex_rect, scene.tex_mip, scene.tex_nlv,
                     _consts(scene.tex_type.device)[0], mask)


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def grad(perm, x, y, z, dx, dy, dz):
    """The gradient term of one lattice corner (texture.rs grad :341)."""
    h = perm[(perm[(perm[x] + y).long()] + z).long()] & 15
    u = torch.where((h < 8) | (h == 12) | (h == 13), dx, dy)
    v = torch.where((h < 4) | (h == 12) | (h == 13), dy, dz)
    u = torch.where((h & 1) > 0, -u, u)
    v = torch.where((h & 2) > 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(perm, p):
    """Perlin noise at points p (..., 3) (texture.rs noise_flt :295)."""
    x, y, z = p.unbind(-1)
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    dx, dy, dz = x - fx, y - fy, z - fz
    ix, iy, iz = (f.long() & 255 for f in (fx, fy, fz))
    w000 = grad(perm, ix, iy, iz, dx, dy, dz)
    w100 = grad(perm, ix + 1, iy, iz, dx - 1, dy, dz)
    w010 = grad(perm, ix, iy + 1, iz, dx, dy - 1, dz)
    w110 = grad(perm, ix + 1, iy + 1, iz, dx - 1, dy - 1, dz)
    w001 = grad(perm, ix, iy, iz + 1, dx, dy, dz - 1)
    w101 = grad(perm, ix + 1, iy, iz + 1, dx - 1, dy, dz - 1)
    w011 = grad(perm, ix, iy + 1, iz + 1, dx, dy - 1, dz - 1)
    w111 = grad(perm, ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1)
    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = _lerp(wx, w000, w100)
    x10 = _lerp(wx, w010, w110)
    x01 = _lerp(wx, w001, w101)
    x11 = _lerp(wx, w011, w111)
    y0 = _lerp(wy, x00, x10)
    y1 = _lerp(wy, x01, x11)
    return _lerp(wz, y0, y1)


def fbm(perm, p, omega, octaves):
    """Fractional Brownian motion (texture.rs fbm :370): the first
    `octaves` (per lane, at most MAX_OCTAVES) octaves' noise, weighted by
    powers of omega."""
    total = torch.zeros(p.shape[:-1], device=p.device)
    o = torch.ones_like(total)
    for i, lam in enumerate(OCTAVE_LAMBDA):
        total = total + torch.where(i < octaves, o * noise(perm, p * lam), 0.0)
        o = o * omega
    return total


def turbulence(perm, p, omega, octaves):
    """fbm of |noise| (texture.rs turbulence :400)."""
    total = torch.zeros(p.shape[:-1], device=p.device)
    o = torch.ones_like(total)
    for i, lam in enumerate(OCTAVE_LAMBDA):
        total = total + torch.where(i < octaves, o * noise(perm, p * lam).abs(), 0.0)
        o = o * omega
    return total


def marble(perm, marble_c, p, scale_n, omega, octaves, variation):
    """textures/marble.rs: a sine displaced by fbm, through the colour
    spline's cubic blend of four control points."""
    first = scale_n[..., None] * p
    t_disp = variation * fbm(perm, first, omega, octaves)
    t = torch.sin(first[..., 1] + t_disp) * 0.5 + 0.5
    tt = torch.clamp(t, 0.0, 0.9999) * float(len(MARBLE_C) - 3)
    i = tt.long()
    ft = tt - i.to(torch.float32)
    c0, c1, c2, c3 = (marble_c[i + k] for k in range(4))
    s0 = (1 - ft) * (1 - ft) * (1 - ft)
    s1 = 3 * ft * (1 - ft) * (1 - ft)
    s2 = 3 * ft * ft * (1 - ft)
    s3 = ft * ft * ft
    rgb = s0[..., None] * c0 + s1[..., None] * c1 + s2[..., None] * c2 + s3[..., None] * c3
    return 1.5 * rgb


def windy(perm, p):
    """textures/windy.rs: |wind strength| x wave height, two fbm's."""
    octs3 = torch.full(p.shape[:-1], 3, device=p.device)
    octs6 = torch.full(p.shape[:-1], 6, device=p.device)
    wind_strength = fbm(perm, 0.1 * p, 0.5, octs3)
    wave_height = fbm(perm, p, 0.5, octs6)
    return wind_strength.abs() * wave_height


def atlas_lookup(atlas, rect, u, v):
    """Bilinear fetch of the atlas at (u, v) (...,) in the rects (..., 4)
    int (y0, h, w, wrap); image row 0 is the top (v flipped).  Wrap 0
    repeats, 1 clamps, 2 gives black outside [0, 1)."""
    h = rect[..., 1].to(torch.float32)
    w = rect[..., 2].to(torch.float32)
    wrap = rect[..., 3]
    uu = u * w - 0.5
    vv = (1.0 - v) * h - 0.5

    def wrapc(x, n):
        clm = torch.minimum(torch.clamp(x, min=0.0), n - 1.0)
        return torch.where(wrap == 0, torch.remainder(x, n), clm)

    x0 = torch.floor(uu)
    y0f = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0f
    ah, aw = atlas.shape[0], atlas.shape[1]
    black = (wrap == 2) & ((uu < -0.5) | (uu > w - 0.5) | (vv < -0.5) | (vv > h - 0.5))
    acc = torch.zeros(u.shape + (3,), device=u.device)
    for dy_i in (0, 1):
        for dx_i in (0, 1):
            xs = wrapc(x0 + dx_i, w).long()
            ys = wrapc(y0f + dy_i, h).long() + rect[..., 0]
            wgt = (fx if dx_i else (1 - fx)) * (fy if dy_i else (1 - fy))
            texel = atlas[torch.clamp(ys, 0, ah - 1), torch.clamp(xs, 0, aw - 1)]
            acc = acc + wgt[..., None] * texel
    return torch.where(black[..., None], 0.0, acc)


def trilinear_lookup(tb: TexTables, tex_id, u, v, width):
    """The pyramid at footprint width (reference mipmap.rs:233-270): the
    bilinear fetches of the two levels about nlv - 1 + log2(width), lerped
    by the fractional level; width 0 reads level 0."""
    nlv_i = tb.nlv[tex_id]
    nlv = nlv_i.to(torch.float32)
    level = nlv - 1.0 + torch.log2(torch.clamp(width, min=1e-8))
    level = torch.minimum(torch.clamp(level, min=0.0), torch.clamp(nlv - 1.0, min=0.0))
    l0 = torch.floor(level).long()
    l1 = torch.minimum(l0 + 1, torch.clamp(nlv_i - 1, min=0).long())
    f = (level - l0.to(torch.float32))[..., None]
    wrap = tb.rect[tex_id][..., 3:4]
    mip = tb.mip[tex_id]  # (..., MAX_LEVELS, 3)

    def rect_at(lv):
        r3 = torch.gather(mip, -2, lv[..., None, None].expand(lv.shape + (1, 3)))[..., 0, :]
        return torch.cat([r3, wrap], -1)

    c0 = atlas_lookup(tb.atlas, rect_at(l0), u, v)
    c1 = atlas_lookup(tb.atlas, rect_at(l1), u, v)
    return (1.0 - f) * c0 + f * c1


def _mapped_uv(tp, uv):
    """(u, v, su, sv) of the uv mapping (texture.rs UVMapping2D): a scale
    of 0 reads as 1."""
    su = torch.where(tp[..., TP_SU] == 0.0, 1.0, tp[..., TP_SU])
    sv = torch.where(tp[..., TP_SV] == 0.0, 1.0, tp[..., TP_SV])
    return uv[..., 0] * su + tp[..., TP_DU], uv[..., 1] * sv + tp[..., TP_DV], su, sv


def _types_of(tb: TexTables, tex_id, on) -> int:
    """Bitmask of the type tags of textures tex_id (in range) on the lanes
    of on (read from the device)."""
    return sum(1 << t for t in torch.unique(tb.type[tex_id][on]).tolist())


def eval_leaf(tb: TexTables, tex_id, uv, p, width=None, kinds=None):
    """The leaf families of the kind mask (or of kinds, a part of it) at
    tex_id (..., in range), each lane's own selected: (..., 3).  A lane
    whose family the mask lacks (or a combinator, a constant, a bilerp)
    reads its TP_VALUE."""
    kinds = tb.kind_mask if kinds is None else kinds
    has = lambda t: bool(kinds & (1 << t))
    tp = tb.params[tex_id]
    ttype = tb.type[tex_id]
    u, v, su, sv = _mapped_uv(tp, uv)
    value = tp[..., TP_VALUE:TP_VALUE + 3]
    out = value.expand(u.shape + (3,))
    perm, marble_c = _consts(tp.device)
    if any(has(t) for t in NOISE_FAMILIES):
        p_tex = tr.xform_point(tb.w2t[tex_id], p)
        octs = torch.clamp(tp[..., TP_OCTAVES].to(torch.int32), 1, MAX_OCTAVES)
        omega = torch.where(tp[..., TP_OMEGA] == 0.0, 0.5, tp[..., TP_OMEGA])
        if has(TEX_FBM):
            f = fbm(perm, p_tex, omega, octs)
            out = torch.where((ttype == TEX_FBM)[..., None], f[..., None] * value, out)
        if has(TEX_WRINKLED):
            f = turbulence(perm, p_tex, omega, octs)
            out = torch.where((ttype == TEX_WRINKLED)[..., None], f[..., None] * value, out)
        if has(TEX_MARBLE):
            scale_n = torch.where(tp[..., TP_SCALE_N] == 0, 1.0, tp[..., TP_SCALE_N])
            m = marble(perm, marble_c, p_tex, scale_n, omega, octs, tp[..., TP_VARIATION])
            out = torch.where((ttype == TEX_MARBLE)[..., None], m, out)
        if has(TEX_WINDY):
            f = windy(perm, p_tex)
            out = torch.where((ttype == TEX_WINDY)[..., None], f[..., None] * value, out)
    if has(TEX_UV):
        uvc = torch.stack([u - torch.floor(u), v - torch.floor(v), torch.zeros_like(u)], -1)
        out = torch.where((ttype == TEX_UV)[..., None], uvc, out)
    if has(TEX_IMAGEMAP):
        if width is None:
            img = atlas_lookup(tb.atlas, tb.rect[tex_id], u, v)
        else:
            # the mapping scales the footprint too (texture.rs
            # UVMapping2D::map scales dstdx, dstdy by su, sv)
            img = trilinear_lookup(tb, tex_id, u, v,
                                   width * torch.maximum(su.abs(), sv.abs()))
        img = img * tp[..., TP_GAMMA_SCALE, None]
        out = torch.where((ttype == TEX_IMAGEMAP)[..., None], img, out)
    return out


def eval_texture(tb: TexTables, tex_id, uv, p, width=None):
    """T1's plain version: the texture tex_id (...,) int at uv (..., 2) and
    p (..., 3) (broadcast against tex_id; width (...,) the texture-space
    footprint, None for level 0 without a lookup of the pyramid), with one
    level of nesting: a scale, mix, checker or dots lane combines its two
    children's leaves.  (..., 3); 0 on lanes whose id is negative.

    Only the families and combinators the lanes reach are evaluated (read
    from the device): the others' selects would keep nothing, so each
    lane's value is the JAX package's execute-and-select's."""
    n_tex = tb.type.shape[0]
    on = tex_id >= 0
    tid = torch.clamp(tex_id, 0, n_tex - 1).long()
    ttype = tb.type[tid]
    present = _types_of(tb, tid, on)
    out = eval_leaf(tb, tid, uv, p, width, tb.kind_mask & present)
    if present & sum(1 << t for t in COMBINATORS):
        comb = on & torch.isin(ttype, torch.tensor(COMBINATORS, device=ttype.device))
        c1 = torch.clamp(tb.child[tid, 0], 0, n_tex - 1).long()
        c2 = torch.clamp(tb.child[tid, 1], 0, n_tex - 1).long()
        kinds = tb.kind_mask & (_types_of(tb, c1, comb) | _types_of(tb, c2, comb))
        v1 = eval_leaf(tb, c1, uv, p, width, kinds)
        v2 = eval_leaf(tb, c2, uv, p, width, kinds)
        tp = tb.params[tid]
        u, v, _, _ = _mapped_uv(tp, uv)
        sel = lambda t, a, b: torch.where((ttype == t)[..., None], a, b)
        if present & (1 << TEX_SCALE):
            out = sel(TEX_SCALE, v1 * v2, out)
        if present & (1 << TEX_MIX):
            out = sel(TEX_MIX, _lerp(tp[..., TP_VALUE, None], v1, v2), out)
        if present & (1 << TEX_CHECKER):
            check = (torch.floor(u).long() + torch.floor(v).long()) % 2 == 0
            out = sel(TEX_CHECKER, torch.where(check[..., None], v1, v2), out)
        if present & (1 << TEX_DOTS):
            # dots (textures/dots.rs): a noise-jittered dot in each unit cell
            perm = _consts(tp.device)[0]
            s_cell, t_cell = torch.floor(u + 0.5), torch.floor(v + 0.5)
            cell = torch.stack([s_cell, t_cell, torch.zeros_like(s_cell)], -1)
            off = lambda a, b: torch.tensor([a, b, 0.0], device=u.device)
            has_dot = noise(perm, cell + 0.5) > 0.0
            cx = s_cell + 0.35 * noise(perm, cell + off(1.5, 2.8))
            cy = t_cell + 0.35 * noise(perm, cell + off(4.5, 9.8))
            inside = has_dot & ((u - cx) * (u - cx) + (v - cy) * (v - cy) < DOT_RADIUS2)
            out = sel(TEX_DOTS, torch.where(inside[..., None], v1, v2), out)
    return torch.where(on[..., None], out, 0.0)
