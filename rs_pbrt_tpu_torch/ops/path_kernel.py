"""K2: one whole path-tracer bounce per launch, for statically simple scenes.

The port of rs_pbrt_tpu/ops/pallas_path.py.  For an all-matte,
triangle-only scene lit by triangle-range area lights (the Cornell box),
one launch runs a whole bounce of models/integrators/path.py:

    closest hit -> hit record -> emitted light with MIS -> 7 Sobol' dims ->
    light pick -> area sample -> shadow any-hit -> Lambert NEE ->
    cosine sample -> Russian roulette

and ``mega_radiance`` runs ``max_depth`` such launches and then one that
only adds emission.  The lane state is structure-of-arrays: a (13, N) f32
tensor (``LANE_ROWS``) and an (N,) int32 ``alive``.

``bounce`` launches the CUDA kernel (``csrc/bounce.cu``) for CUDA tensors
and runs ``bounce_plain``, the same bounce in plain PyTorch, for CPU
tensors.  ``bounce_plain`` follows the JAX kernel step by step, with the
same guards and epsilons; the tables are read by direct indexing where the
TPU needed select-accumulate loops.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene import arrays as sa
from ..utils import vecmath as vm
from . import _build
from . import lowdiscrepancy as ld
from . import sampling as smp
from .record import coordinate_system as _coordinate_system
from .record import cross as _cross
from .record import dot as _dot
from .record import normalize as _normalize
from .record import scale as _scale
from .record import sub as _sub
from .record import take as _take
from .record import tri_record
from .record import where3 as _where3
from .sobol_kernel import sobol_dims_plain
from .watertight import BIG, any_sweep, any_sweep_tests, closest_sweep

MEGA_MAX_TRIS = 2048
MEGA_MAX_LIGHTS = 8
MEGA_MAX_LIGHT_TRIS = 16
DIMS_PER_BOUNCE = 7  # light select, light u (2), bsdf u (2), lobe, rr

LANE_ROWS = ("ox", "oy", "oz", "dx", "dy", "dz", "beta_r", "beta_g", "beta_b",
             "L_r", "L_g", "L_b", "prev_pdf")
N_LANE_ROWS = len(LANE_ROWS)

INV_PI = float(np.float32(1.0 / np.pi))

launches = 0  # kernel launches of `bounce`; the plain path does not count


class MegaCfg(NamedTuple):
    """What the bounce kernel needs to know of an eligible scene."""

    n_tri: int
    n_mats: int
    lights: tuple  # ((tri_start, tri_count), ...) per light
    a_cols: int  # alight_tri_cdf.shape[1]


def mega_cfg(scene: sa.Scene) -> Optional[MegaCfg]:
    """MegaCfg when the bounce kernel can render `scene`, else None.  The
    same limits as the JAX package (pallas_path.py:58-60,104-147), decided
    on the host copies of the tables."""
    if (scene.n_spheres or scene.n_curve_segs or scene.has_env or scene.has_alpha
            or scene.has_subsurface or scene.has_hair):
        return None
    if not (0 < scene.n_tris <= MEGA_MAX_TRIS):
        return None
    if not (0 < scene.n_lights <= MEGA_MAX_LIGHTS):
        return None
    if scene.tex_slot_mask != 0 or scene.mat_kind_mask != (1 << sa.MATTE):
        return None
    mat = scene.mat_attr.cpu().numpy()
    if (mat[:, sa.MA_PARAMS + sa.MP_SIGMA] != 0.0).any():
        return None  # oren-nayar
    la = scene.light_attr.cpu().numpy()
    types = np.rint(la[:, sa.LA_TYPE]).astype(int)
    geom = np.rint(la[:, sa.LA_GEOM]).astype(int)
    if (types != sa.LIGHT_AREA).any() or (geom != sa.ALG_TRI_RANGE).any():
        return None
    starts = np.rint(la[:, sa.LA_TRI_START]).astype(int)
    counts = np.rint(la[:, sa.LA_TRI_END]).astype(int) - starts
    if (counts <= 0).any() or counts.max() > MEGA_MAX_LIGHT_TRIS:
        return None
    return MegaCfg(
        n_tri=int(scene.n_tris),
        n_mats=int(scene.mat_attr.shape[0]),
        lights=tuple((int(s), int(c)) for s, c in zip(starts, counts)),
        a_cols=int(scene.alight_tri_cdf.shape[1]),
    )


class MegaTables(NamedTuple):
    tris: torch.Tensor  # (T, 32) f32 tri_attr
    lattr: torch.Tensor  # (L, 22) f32 light_attr
    lsel: torch.Tensor  # (2, L+1) f32: light-pick CDF, then per-light pick pdf
    ltricdf: torch.Tensor  # (L, A+1) f32 per-light triangle-area CDF
    mattr: torch.Tensor  # (M, 37) f32 mat_attr


def mega_tables(scene: sa.Scene) -> MegaTables:
    """The kernel's tables; lsel is the power distribution over lights
    (path._light_select_dist)."""
    dist = smp.make_distribution_1d(scene.light_power)
    n_l = scene.n_lights
    lsel = torch.zeros((2, n_l + 1), dtype=torch.float32, device=scene.device)
    lsel[0] = dist.cdf
    lsel[1, :n_l] = dist.func / torch.clamp(dist.func_int * n_l, min=1e-30)
    return MegaTables(
        scene.tri_attr.contiguous(), scene.light_attr.contiguous(), lsel,
        scene.alight_tri_cdf.contiguous(), scene.mat_attr.contiguous(),
    )


# ---------------------------------------------------------------------------
# plain version: 3-tuples of (N,) tensors
# ---------------------------------------------------------------------------

def _offset_ray_origin(p, p_err, n, w):
    d = n[0].abs() * p_err[0] + n[1].abs() * p_err[1] + n[2].abs() * p_err[2]
    flip = _dot(w, n) < 0.0
    out = []
    for k in range(3):
        off = torch.where(flip, -d * n[k], d * n[k])
        po = p[k] + off
        out.append(torch.where(off > 0.0, vm.next_float_up(po),
                               torch.where(off < 0.0, vm.next_float_down(po), po)))
    return tuple(out)


def bounce_plain(lanes, alive_i, index, tables: MegaTables, cfg: MegaCfg, *,
                 dim_row: int, n_bits: int, first_bounce: bool, rr_active: bool,
                 emit_only: bool, rr_threshold: float, work: Optional[dict] = None):
    """One bounce in plain PyTorch (pallas_path.py:_bounce_kernel).
    Returns the new (lanes, alive).  work: a dict that, if given, gets the
    number of lanes that run each step of the kernel (for its bound)."""
    tris, lattr, lsel, ltricdf, mattr = tables
    n_l = len(cfg.lights)
    o = (lanes[0], lanes[1], lanes[2])
    d = (lanes[3], lanes[4], lanes[5])
    beta = (lanes[6], lanes[7], lanes[8])
    Lrad = [lanes[9], lanes[10], lanes[11]]
    prev_pdf = lanes[12]
    alive = alive_i != 0

    # ---- closest hit + record ----
    bt, bi, b0, b1 = closest_sweep(tris, cfg.n_tri, o, d, BIG)
    rec = tri_record(tris, bi, b0, b1)
    p, p_err, ng, ns, dpdu, mat, light = (rec.p, rec.p_err, rec.ng, rec.ns, rec.dpdu, rec.mat,
                                          rec.light)
    valid = bi >= 0
    wo = _scale(_normalize(d), -1.0)

    # ---- emitted light at the hit, MIS against the previous bsdf pdf ----
    hit_light = torch.where(valid & alive, light, -1)
    is_emitter = hit_light >= 0
    lok = is_emitter & (hit_light < n_l)
    le = [_take(lattr, hit_light, lok, sa.LP_I + k) for k in range(3)]
    area_h = _take(lattr, hit_light, lok, sa.LP_AREA)
    two_h = _take(lattr, hit_light, lok, sa.LP_TWO_SIDED)
    selpdf_h = _take(lsel.T, hit_light, lok, 1)
    emits = (two_h > 0.5) | (_dot(ns, wo) > 0.0)
    le_on = emits & is_emitter
    to_hit = _sub(p, o)
    d2h = torch.clamp(_dot(to_hit, to_hit), min=1e-12)
    inv_dist_h = 1.0 / torch.sqrt(d2h)
    cos_lh = _dot(ns, to_hit).abs() * inv_dist_h
    area_pdf = d2h / torch.clamp(cos_lh * torch.clamp(area_h, min=1e-12), min=1e-12)
    area_pdf = torch.where(cos_lh < 1e-7, 0.0, area_pdf)
    light_pdf = selpdf_h * area_pdf
    w_bsdf = torch.ones_like(bt) if first_bounce else smp.power_heuristic(prev_pdf, light_pdf)
    gain = torch.where(le_on, w_bsdf, 0.0)
    Lrad = [Lrad[k] + beta[k] * le[k] * gain for k in range(3)]
    if work is not None:
        has_n = _take(tris, bi, valid, sa.TA_HAS_N) > 0.5
        work.update(live=int(alive.sum()), hit=int((alive & valid).sum()),
                    hit_normals=int((alive & valid & has_n).sum()))
    alive = alive & valid

    if not emit_only:
        o, d, beta, Lrad, alive, prev_pdf = _shade(
            tables, cfg, index, dim_row, n_bits, rr_active, rr_threshold,
            o, d, beta, Lrad, alive, prev_pdf, p, p_err, ng, ns, dpdu, mat, wo, work)
    out = torch.stack([*o, *d, *beta, *Lrad, prev_pdf])
    return out, alive.to(torch.int32)


def _shade(tables, cfg, index, dim_row, n_bits, rr_active, rr_threshold,
           o, d, beta, Lrad, alive, prev_pdf, p, p_err, ng, ns, dpdu, mat, wo, work):
    """NEE, bsdf sampling and Russian roulette of bounce_plain."""
    tris, lattr, lsel, ltricdf, mattr = tables
    n_l = len(cfg.lights)

    # ---- BSDF frame: ss along dpdu (path._shading_frame_du) ----
    ss = _sub(dpdu, _scale(ns, _dot(ns, dpdu)))
    degen = _dot(ss, ss) < 1e-14
    ss_fb = _coordinate_system(ns)
    ss = _where3(degen, ss_fb, _normalize(_where3(degen, ss_fb, ss)))
    ts = _cross(ns, ss)
    wo_l = (_dot(wo, ss), _dot(wo, ts), _dot(wo, ns))

    # ---- matte lambertian ----
    mok = (mat >= 0) & (mat < cfg.n_mats)
    kd = tuple(_take(mattr, mat, mok, sa.MA_PARAMS + sa.MP_KD + k) for k in range(3))
    kd_black = (kd[0] == 0.0) & (kd[1] == 0.0) & (kd[2] == 0.0)

    dims = sobol_dims_plain(index, dim_row, DIMS_PER_BOUNCE, n_bits).unbind(-1)

    # ---- NEE: pick a light by power ----
    usel = dims[0]
    cnt = (lsel[0][None, :] <= usel[:, None]).sum(-1)
    li_idx = torch.clamp(cnt - 1, 0, n_l - 1)
    sel_pdf = lsel[1][li_idx]

    # area-sample a triangle of the chosen light (lights._area_sample_tri)
    ul0, ul1 = dims[1], dims[2]
    cdf = ltricdf[li_idx]  # (N, A+1)
    cnt_t = (cdf <= ul0[:, None]).sum(-1)
    off = torch.clamp(cnt_t - 1, 0, cfg.a_cols - 2)
    c0 = cdf.gather(1, off[:, None])[:, 0]
    c1 = cdf.gather(1, off[:, None] + 1)[:, 0]
    larea = lattr[li_idx, sa.LP_AREA]
    ltwo = lattr[li_idx, sa.LP_TWO_SIDED]
    lint = [lattr[li_idx, sa.LP_I + k] for k in range(3)]
    starts = torch.tensor([s for s, _ in cfg.lights], device=usel.device)
    counts = torch.tensor([c for _, c in cfg.lights], device=usel.device)
    tok = off < counts[li_idx]
    row = starts[li_idx] + off
    lp0 = [_take(tris, row, tok, 0 + k) for k in range(3)]
    lp1 = [_take(tris, row, tok, 3 + k) for k in range(3)]
    lp2 = [_take(tris, row, tok, 6 + k) for k in range(3)]
    ln0 = [_take(tris, row, tok, 9 + k) for k in range(3)]
    ln1 = [_take(tris, row, tok, 12 + k) for k in range(3)]
    ln2 = [_take(tris, row, tok, 15 + k) for k in range(3)]
    lhasn = _take(tris, row, tok, sa.TA_HAS_N)
    lrev = _take(tris, row, tok, sa.TA_REVERSE)
    u_remap = torch.clamp((ul0 - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0 - 1e-7)
    su0 = torch.sqrt(u_remap)
    lb0 = 1.0 - su0
    lb1 = ul1 * su0
    lb2 = 1.0 - lb0 - lb1
    p_l = tuple(lb0 * lp0[k] + lb1 * lp1[k] + lb2 * lp2[k] for k in range(3))
    ng_l = _normalize(_cross(_sub(lp1, lp0), _sub(lp2, lp0)), 1e-30)
    ns_l = tuple(lb0 * ln0[k] + lb1 * ln1[k] + lb2 * ln2[k] for k in range(3))
    ff_l = (lhasn > 0.5) & (_dot(ng_l, ns_l) < 0.0)
    ng_l = _where3(ff_l, _scale(ng_l, -1.0), ng_l)
    ng_l = _where3(lrev > 0.5, _scale(ng_l, -1.0), ng_l)
    to_a = _sub(p_l, p)
    d2a = torch.clamp(_dot(to_a, to_a), min=1e-12)
    inv_da = 1.0 / torch.sqrt(d2a)
    wi_l3 = _scale(to_a, inv_da)
    cos_l = _dot(ng_l, _scale(wi_l3, -1.0))
    emits_l = (ltwo > 0.5) | (cos_l > 0.0)
    li = [torch.where(emits_l, lint[k], 0.0) for k in range(3)]
    ls_pdf = d2a / torch.clamp(cos_l.abs() * torch.clamp(larea, min=1e-12), min=1e-12)
    ls_pdf = torch.where(cos_l.abs() < 1e-7, 0.0, ls_pdf)

    # f and scattering pdf toward the light
    wi_loc = (_dot(wi_l3, ss), _dot(wi_l3, ts), _dot(wi_l3, ns))
    reflect = _dot(wi_l3, ng) * _dot(wo, ng) > 0.0
    same_h = wi_loc[2] * wo_l[2] > 0.0
    f_on = reflect & same_h & ~kd_black
    abs_ci = wi_loc[2].abs()
    f_w = torch.where(f_on, INV_PI * abs_ci, 0.0)
    scat_pdf = torch.where(same_h & ~kd_black, abs_ci * INV_PI, 0.0)
    contrib_ok = (alive & ~kd_black & (ls_pdf > 0.0)
                  & ((li[0] > 0.0) | (li[1] > 0.0) | (li[2] > 0.0)) & (f_w > 0.0))

    # shadow ray, any hit
    p_sh = _offset_ray_origin(p, p_err, ng, wi_l3)
    delta_sh = _sub(p_l, p_sh)
    dist_sh = torch.sqrt(_dot(delta_sh, delta_sh))
    sh_d = _scale(delta_sh, 1.0 / torch.clamp(dist_sh, min=1e-12))
    occluded = any_sweep(tris, cfg.n_tri, p_sh, sh_d, dist_sh * (1.0 - 1e-3))
    if work is not None:
        work.update(
            light_normals=int((alive & (lhasn > 0.5)).sum()), shadow=int(contrib_ok.sum()),
            shadow_tests=any_sweep_tests(tris, cfg.n_tri, p_sh, sh_d, dist_sh * (1.0 - 1e-3),
                                         contrib_ok),
            unoccluded=int((contrib_ok & ~occluded).sum()))

    w_light = smp.power_heuristic(ls_pdf, scat_pdf)
    inv_pdf = w_light / torch.clamp(ls_pdf * sel_pdf, min=1e-12)
    nee_gain = torch.where(contrib_ok & ~occluded, f_w * inv_pdf, 0.0)
    Lrad = [Lrad[k] + beta[k] * kd[k] * li[k] * nee_gain for k in range(3)]

    # ---- BSDF sample: cosine hemisphere ----
    dxs, dys = smp.concentric_sample_disk(torch.stack(dims[3:5], -1)).unbind(-1)
    z = torch.sqrt(torch.clamp(1.0 - dxs * dxs - dys * dys, min=0.0))
    sgn = torch.where(torch.where(wo_l[2] == 0.0, 1.0, wo_l[2]) > 0.0, 1.0, -1.0)
    wi_s = _normalize((dxs * sgn, dys * sgn, z * sgn))
    same_h_s = wi_s[2] * wo_l[2] > 0.0
    pdf_s = torch.where(kd_black | ~same_h_s, 0.0, wi_s[2].abs() * INV_PI)
    ok = (pdf_s > 0.0) & ~kd_black
    wi_w = tuple(wi_s[0] * ss[k] + wi_s[1] * ts[k] + wi_s[2] * ns[k] for k in range(3))
    cos_wi = _dot(wi_w, ns).abs()
    upd = alive & ok
    scale_b = torch.where(upd, INV_PI * cos_wi / torch.clamp(pdf_s, min=1e-12), 1.0)
    beta = tuple(beta[k] * torch.where(upd, kd[k], 1.0) * scale_b for k in range(3))
    alive = alive & ok
    if work is not None:
        work.update(cont=int(alive.sum()), rr_keep=0)
    prev_pdf = torch.where(alive, pdf_s, prev_pdf)
    o = _where3(alive, _offset_ray_origin(p, p_err, ng, wi_w), o)
    d = _where3(alive, wi_w, d)

    # ---- Russian roulette (path.rs:253-262) ----
    if rr_active:
        rr_max = torch.maximum(torch.maximum(beta[0], beta[1]), beta[2])
        q = torch.clamp(1.0 - rr_max, min=0.05)
        consider = (rr_max < rr_threshold) & alive
        kill = consider & (dims[6] < q)
        inv_keep = 1.0 / torch.clamp(1.0 - q, min=1e-6)
        keep = torch.where(consider & ~kill, inv_keep, 1.0)
        beta = _scale(beta, keep)
        alive = alive & ~kill
        if work is not None:
            work["rr_keep"] = int((consider & ~kill).sum())
    return o, d, beta, Lrad, alive, prev_pdf


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I,  # lanes_in, alive_in, index, lanes_out, alive_out, n
             _P, _I, _P, _I, _P, _P, _I, _P, _I,  # tris, n_tri, lattr, n_l, lsel, ltricdf, a_cols, mattr, n_mats
             _P, _I, _I,  # mats, dim_row, n_bits
             _I, _I, _I, ctypes.c_float, _P]  # first, rr_active, emit_only, rr_threshold, stream


def _kernel():
    lib = _build.load("bounce")
    fn = lib.rs_bounce
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"bounce: {name} lies on {t.device}, expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"bounce: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"bounce: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bounce: {name} is not contiguous")


def bounce(lanes, alive, index, tables: MegaTables, cfg: MegaCfg, *, dim_row: int,
           n_bits: int, first_bounce: bool, rr_active: bool, emit_only: bool,
           rr_threshold: float):
    """One bounce: the CUDA kernel for CUDA tensors, bounce_plain for CPU
    tensors.  lanes (13, N) f32, alive (N,) int32, index (N,) int64 Sobol'
    global index; dim_row: the first of this bounce's 7 Sobol' dims."""
    kw = dict(dim_row=dim_row, n_bits=n_bits, first_bounce=first_bounce,
              rr_active=rr_active, emit_only=emit_only, rr_threshold=rr_threshold)
    if lanes.device.type == "cpu":
        return bounce_plain(lanes, alive, index, tables, cfg, **kw)
    global launches
    n = lanes.shape[1]
    n_l = len(cfg.lights)
    _check("lanes", lanes, torch.float32, (N_LANE_ROWS, n))
    _check("alive", alive, torch.int32, (n,))
    _check("index", index, torch.int64, (n,))
    _check("tris", tables.tris, torch.float32, (tables.tris.shape[0], sa.N_TRI_ATTR))
    _check("lattr", tables.lattr, torch.float32, (n_l, sa.N_LIGHT_ATTR))
    _check("lsel", tables.lsel, torch.float32, (2, n_l + 1))
    _check("ltricdf", tables.ltricdf, torch.float32, (n_l, cfg.a_cols))
    _check("mattr", tables.mattr, torch.float32, (cfg.n_mats, sa.N_MAT_ATTR))
    if tables.tris.shape[0] < cfg.n_tri:
        raise ValueError("bounce: tri table shorter than cfg.n_tri")
    if n_bits not in (32, 52):
        raise ValueError(f"bounce: n_bits must be 32 or 52, got {n_bits}")
    if n >= 1 << 31:
        raise ValueError("bounce: at most 2^31 - 1 lanes per launch")
    if not (emit_only or 0 <= dim_row <= ld.NUM_SOBOL_DIMENSIONS - DIMS_PER_BOUNCE):
        raise ValueError(f"bounce: Sobol' dims {dim_row}..{dim_row + 6} out of range")
    mats = ld.sobol_matrices(lanes.device, torch.int32)
    lanes_out = torch.empty_like(lanes)
    alive_out = torch.empty_like(alive)
    with torch.cuda.device(lanes.device):
        err = _kernel()(
            lanes.data_ptr(), alive.data_ptr(), index.data_ptr(),
            lanes_out.data_ptr(), alive_out.data_ptr(), n,
            tables.tris.data_ptr(), cfg.n_tri, tables.lattr.data_ptr(), n_l,
            tables.lsel.data_ptr(), tables.ltricdf.data_ptr(), cfg.a_cols,
            tables.mattr.data_ptr(), cfg.n_mats,
            mats.data_ptr(), dim_row if not emit_only else 0, n_bits,
            int(first_bounce), int(rr_active), int(emit_only), float(rr_threshold),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bounce kernel launch")
    launches += 1
    return lanes_out, alive_out


def init_lanes(ray_o: torch.Tensor, ray_d: torch.Tensor):
    """Lane state of fresh camera paths: (13, N) rows o, d, beta = 1,
    L = 0, prev_pdf = 1, and alive = 1."""
    n = ray_o.shape[0]
    lanes = torch.empty((N_LANE_ROWS, n), dtype=torch.float32, device=ray_o.device)
    lanes[0:3] = ray_o.T
    lanes[3:6] = ray_d.T
    lanes[6:9] = 1.0  # beta
    lanes[9:12] = 0.0  # L
    lanes[12] = 1.0  # prev_pdf
    return lanes, torch.ones(n, dtype=torch.int32, device=ray_o.device)


def mega_radiance(scene: sa.Scene, cfg: MegaCfg, max_depth: int, rr_threshold: float,
                  index: torch.Tensor, n_bits: int, dim0: int, ray_o, ray_d):
    """Path radiance through the bounce kernel (pallas_path.py:702-771):
    max_depth bounce launches, then one launch that only adds emission.
    index: (N,) int64 Sobol' global index; dim0: the first bounce dim
    (path.DIM_CAMERA).  Returns (N, 3) L."""
    if dim0 + DIMS_PER_BOUNCE * max_depth > ld.NUM_SOBOL_DIMENSIONS:
        raise ValueError(f"max_depth {max_depth} needs more than {ld.NUM_SOBOL_DIMENSIONS} Sobol' dims")
    lanes, alive = init_lanes(ray_o, ray_d)
    index = index.contiguous()
    tables = mega_tables(scene)
    kw = dict(n_bits=n_bits, rr_threshold=rr_threshold)
    for b in range(max_depth):
        lanes, alive = bounce(lanes, alive, index, tables, cfg,
                              dim_row=dim0 + DIMS_PER_BOUNCE * b, first_bounce=b == 0,
                              rr_active=b > 2, emit_only=False, **kw)
    lanes, alive = bounce(lanes, alive, index, tables, cfg, dim_row=dim0,
                          first_bounce=max_depth == 0, rr_active=False, emit_only=True, **kw)
    return lanes[9:12].T.contiguous()
