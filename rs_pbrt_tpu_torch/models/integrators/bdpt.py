"""Bidirectional path tracing.

The port of the JAX package's ``models/integrators/bdpt.py`` (reference
src/integrators/bdpt.rs).  Each lane walks a camera subpath of up to
max_depth + 2 vertices and a light subpath of up to max_depth + 1
(``_walk``: closest hits through K5, B1 or the other walks by the scene's
accelerator, BSDF sampling through the base material's textures, T1, and
Fourier lobes, F1/F2; in media homogeneous distance sampling or, with a
density grid, delta tracking through M1), then connects them by every
(s, t) strategy up to max_depth: s = 0 the camera path's emission (and an
escaped ray's sky), s = 1 a fresh light sample, t = 1 the light vertex
splatted to the film through the camera's importance (``cameras.
camera_sample_wi``), and the general s, t >= 2 connection, each with its
shadow ray (K4, B2 or the others' any hit; M2 through a grid) and its MIS
weight (W1, ``ops/mis_kernel.py``).

The subpaths are SoA tensors stored slot-major, (D, N, ...): a slot of
every lane is one contiguous row, written in place by ``_set`` (a masked
select, the JAX ``.at[:, slot].set``), and W1 reads its pdf and delta
columns coalesced.  Connection vertices are evaluated with their
material's base parameters, without textures (``_vertex_f``), and the
light-path origin's delta test counts point, spot and distant lights only,
as in the JAX package; the walks see moving meshes at time 0.

Sampler dims (``dim_bases``): film 0-1, time 2, lens 3-4, light pick 20,
light position 21-22 and direction 23-24, then the camera walk's 3 dims a
vertex (5 with media), the light walk's, and 3 a strategy for s = 1.  A
render draws every dim from 2 on in one block (one K1 or H1 launch where
they number at most 128); MLT reads its primary-sample-space vectors
instead (``SampleCtx.pss``).  Grid media key their tracking by lane
(``arange(n)`` of the batch), so a grid-medium image equals the JAX one only
at the same batching.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import bsdf as bx
from ...ops import film as filmmod
from ...ops import medium as med
from ...ops import medium_kernel as mk
from ...ops import mis_kernel as misk
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...ops import sobol_kernel as sk
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import cameras as cam
from .. import lights as lt
from .. import samplers as smpl
from .path import (PathCfg, _light_select_dist, _shading_frame, _shading_frame_du, _to_local,
                   _to_world)
from .volpath import _media_tables, _prim_media

VT_CAMERA = 0
VT_LIGHT = 1
VT_SURFACE = 2
VT_MEDIUM = 3

# Subpath.light of a camera vertex on the environment sphere (an escaped
# ray); densities at such a vertex stay in solid-angle measure
ENV_LIGHT = -2
WALK_SEED = 0xBD  # the walks' delta tracking: seed, salts 0xC0 + slot (camera), 0x40 + slot
SEG_SALT, SEG_SEED = 0xBD7, 0x91  # the connections' ratio tracking (bdpt.py:434)
# paths a batch at most, by default, sized by memory on an NVIDIA H100
# 80GB HBM3: a lane holds two subpaths of max_depth + 2 and + 1 vertices
# (86 B a vertex: p, ns, ng, wo, beta, mat, light, vtype, med, pdf_fwd,
# pdf_rev, delta, valid; 1,118 B at depth 5), max_depth splat groups (20 B
# each) and the connections' temporaries: 2,577 B at the peak of a depth-5
# batch of 2^22 lanes on the Cornell box (chip_smoke.py phase 28, PERF.md),
# so 2^23 lanes take ~21.6 GB at depth 5 and about twice that at depth 10
MAX_LANES = 1 << 23


class Subpath(NamedTuple):
    """SoA vertex storage, slot-major: slot 0 is the endpoint (camera or
    light)."""

    p: torch.Tensor  # (D, N, 3)
    ns: torch.Tensor  # (D, N, 3)
    ng: torch.Tensor  # (D, N, 3)
    wo: torch.Tensor  # (D, N, 3) toward the previous vertex
    beta: torch.Tensor  # (D, N, 3)
    mat: torch.Tensor  # (D, N) int32
    light: torch.Tensor  # (D, N) int32 area light id at the vertex, -1, or ENV_LIGHT
    pdf_fwd: torch.Tensor  # (D, N) area-measure forward pdf
    pdf_rev: torch.Tensor  # (D, N) area-measure reverse pdf
    delta: torch.Tensor  # (D, N) bool: a specular vertex
    vtype: torch.Tensor  # (D, N) int32
    valid: torch.Tensor  # (D, N) bool
    count: torch.Tensor  # (N,) int32 valid vertices
    med: torch.Tensor  # (D, N) int32 the medium the arriving segment crossed (-1 vacuum)


def _empty_subpath(n: int, depth: int, dev) -> Subpath:
    z3 = lambda: torch.zeros((depth, n, 3), device=dev)
    z1 = lambda: torch.zeros((depth, n), device=dev)
    zi = lambda v=0: torch.full((depth, n), v, dtype=torch.int32, device=dev)
    zb = lambda: torch.zeros((depth, n), dtype=torch.bool, device=dev)
    return Subpath(z3(), z3(), z3(), z3(), z3(), zi(), zi(-1), z1(), z1(), zb(), zi(), zb(),
                   torch.zeros(n, dtype=torch.int32, device=dev), zi(-1))


def _set(path: Subpath, slot: int, mask, **kw):
    """Writes vertex fields at `slot` for the lanes of mask, in place."""
    for k, v in kw.items():
        cur = getattr(path, k)
        m = mask[:, None] if cur.dim() == 3 else mask
        cur[slot] = torch.where(m, v, cur[slot])


def _convert_density(pdf_solid, p_from, p_to, n_to, to_is_med=None):
    """Solid angle -> area measure at p_to (bdpt.rs convert_density); a
    medium vertex (to_is_med) has no cosine."""
    d = p_to - p_from
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    w = d / torch.sqrt(d2)[..., None]
    cos = vm.dot(n_to, w).abs()
    if to_is_med is not None:
        cos = torch.where(to_is_med, 1.0, cos)
    return pdf_solid * cos / d2


def _walk(scene: sa.Scene, cfg_s, ctx, o0, d0, beta0, pdf_dir0, max_verts: int, dim_base: int,
          accel, path: Subpath, mode_importance: bool, prev0_env=None, med0=None) -> Subpath:
    """The random walk that fills slots 1.. of `path` (slot 0 written),
    in place (bdpt.rs random_walk :1237, the JAX _walk).  A camera walk in
    a scene with a sky appends an ENV_LIGHT vertex where a ray escapes;
    prev0_env: the lanes whose slot 0 is the sky (its pdf_rev stays solid
    angle); med0: the walk's starting media in a scene with media."""
    n, dev = o0.shape[0], o0.device
    o, d, beta, pdf_fwd_solid = o0, d0, beta0, pdf_dir0
    alive = (beta > 0).any(-1) & (pdf_dir0 > 0)
    prev_p, prev_ns = path.p[0], path.ns[0]
    prev_is_med = torch.zeros(n, dtype=torch.bool, device=dev)
    has_med = scene.has_media
    dims_per = 5 if has_med else 3
    if has_med:
        cur_med = med0 if med0 is not None else torch.full((n,), -1, dtype=torch.int32,
                                                            device=dev)
        lane_key = torch.arange(n, dtype=torch.int32, device=dev) if scene.has_grid else None
    far = float(np.float32(8.0) * np.float32(max(scene.world_radius, 1.0)))
    for slot in range(1, max_verts):
        # dead lanes cast with t_max = -1, which the walks end at once
        it = si.scene_intersect(scene, o, d, torch.where(alive, float(vm.INFINITY), -1.0), accel)
        dim0 = dim_base + (slot - 1) * dims_per
        if has_med:  # distance-sample the current medium on [0, t_hit]
            in_med = alive & (cur_med >= 0)
            mid = torch.clamp(cur_med, min=0)
            seg_t = torch.where(it.valid, it.t, far)
            if scene.has_grid:  # delta tracking, homogeneous media too (grid.rs:209-271)
                salt = (0x40 if mode_importance else 0xC0) + slot
                ms = med.MediumSample(*mk.delta_track(
                    *_media_tables(scene), mid, in_med, o.contiguous(), d.contiguous(),
                    seg_t.contiguous(), lane_key, salt, WALK_SEED))
            else:
                ms = med.homogeneous_sample(scene.med_sigma_a[mid], scene.med_sigma_s[mid],
                                            smpl.get_1d(cfg_s, ctx, dim0 + 3),
                                            smpl.get_1d(cfg_s, ctx, dim0 + 4), seg_t)
            med_scatter = in_med & ms.sampled
            beta = torch.where(in_med[:, None], beta * ms.weight, beta)
            p_med = o + ms.t[:, None] * d
        else:
            med_scatter = torch.zeros(n, dtype=torch.bool, device=dev)
        hit = it.valid & alive & ~med_scatter
        _set(path, slot, hit, p=it.p, ns=it.ns, ng=it.ng, wo=it.wo, beta=beta, mat=it.mat,
             light=it.light, pdf_fwd=_convert_density(pdf_fwd_solid, prev_p, it.p, it.ns),
             vtype=VT_SURFACE, valid=hit)
        if has_med:
            _set(path, slot, hit, med=cur_med)
            # a medium scattering event: density converted without a cosine
            d2_med = torch.clamp(vm.length_squared(p_med - prev_p), min=1e-12)
            _set(path, slot, med_scatter, p=p_med, ns=d, ng=d, wo=-d, beta=beta, mat=-1,
                 light=-1, pdf_fwd=pdf_fwd_solid / d2_med, vtype=VT_MEDIUM, valid=med_scatter,
                 med=cur_med)
        path.count.add_((hit | med_scatter).to(torch.int32))
        if scene.has_env and not mode_importance:
            # an escaped camera ray: a vertex on the sky, pdf_fwd unconverted
            miss = alive & ~it.valid & ~med_scatter
            wr = 2.0 * max(scene.world_radius, 1.0)
            _set(path, slot, miss, p=o + d * wr, ns=-d, ng=-d, wo=-d, beta=beta, light=ENV_LIGHT,
                 pdf_fwd=pdf_fwd_solid, vtype=VT_LIGHT, valid=miss)
            path.count.add_(miss.to(torch.int32))
        alive = hit | med_scatter

        b = bx.make_bsdf_at(scene, it)
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        wo_l = _to_local(it.wo, ss, ts, it.ns)
        u2 = smpl.get_2d(cfg_s, ctx, dim0)
        bs = bx.bsdf_sample(b, wo_l, u2, smpl.get_1d(cfg_s, ctx, dim0 + 2))
        wi_w = _to_world(bs.wi, ss, ts, it.ns)
        cos_wi = vm.absdot(wi_w, it.ns)
        ok = (bs.pdf > 0.0) & (bs.f > 0.0).any(-1)
        _set(path, slot, hit, delta=bs.is_specular)
        # the reverse pdf, written to the previous vertex
        pdf_rev_solid = bx.bsdf_pdf(b, _to_local(wi_w, ss, ts, it.ns), wo_l)
        if has_med:  # the phase sample reuses the BSDF's 2D dims
            wi_med, ph = med.hg_sample_phase(-d, u2, scene.med_g[mid])
            wi_w = torch.where(med_scatter[:, None], wi_med, wi_w)
            ok = torch.where(med_scatter, ph > 0.0, ok)
            pdf_rev_solid = torch.where(med_scatter, ph, pdf_rev_solid)
        here_p = torch.where(med_scatter[:, None], p_med, it.p) if has_med else it.p
        prev_rev = _convert_density(pdf_rev_solid, here_p, prev_p, prev_ns,
                                    to_is_med=prev_is_med if has_med else None)
        if slot == 1 and prev0_env is not None:
            prev_rev = torch.where(prev0_env, pdf_rev_solid, prev_rev)
        path.pdf_rev[slot - 1] = torch.where(hit | med_scatter, prev_rev, path.pdf_rev[slot - 1])

        # surface lanes scale beta by f cos / pdf; medium lanes keep it
        beta = torch.where((hit & ok)[:, None],
                           beta * bs.f * (cos_wi / torch.clamp(bs.pdf, min=1e-12))[:, None], beta)
        alive = alive & ok
        pdf_fwd_solid = torch.where(bs.is_specular & hit, 1.0, bs.pdf)
        if has_med:
            pdf_fwd_solid = torch.where(med_scatter, ph, pdf_fwd_solid)
            # the medium changes only at real interfaces (spawn_ray)
            m_in, m_out = _prim_media(scene, it)
            entering = vm.dot(wi_w, it.ng) < 0.0
            cur_med = torch.where(hit & alive & (m_in != m_out),
                                  torch.where(entering, m_in, m_out), cur_med)
        prev_p = here_p
        prev_ns = it.ns
        prev_is_med = med_scatter
        o_next = vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_w)
        if has_med:
            o_next = torch.where(med_scatter[:, None], p_med, o_next)
        o = torch.where(alive[:, None], o_next, o)
        d = torch.where(alive[:, None], wi_w, d)
    return path


def dim_bases(max_verts_cam: int, max_verts_light: int, has_media: bool = False) -> tuple:
    """(camera walk, light walk, s = 1 strategies) first dims: disjoint
    streams whatever the depth (mlt.rs:28-64), 5 dims a walk vertex with
    media (channel and distance), else 3."""
    per_vert = 5 if has_media else 3
    cam_base = 40
    light_base = cam_base + per_vert * max_verts_cam + 2
    s1_base = light_base + per_vert * max_verts_light + 6
    return cam_base, light_base, s1_base


def _draw_dims(cfg_s, ctx, t_max: int, s_max: int, has_media: bool):
    """ctx with the dims a BDPT sample reads drawn ahead in one block, dims
    2 .. (at most sk.MAX_DIMS of them; the rest drawn where read), its 2D
    draws at the lens, the light's position and direction, each walk
    vertex's BSDF pair and each s = 1 strategy's light pair."""
    cam_base, light_base, s1_base = dim_bases(t_max, s_max, has_media)
    per = 5 if has_media else 3
    n = min(s1_base + 3 * t_max + 1, sk.MAX_DIMS)
    starts = ([3, 21, 23] + [cam_base + k * per for k in range(t_max - 1)]
              + [light_base + k * per for k in range(s_max - 1)]
              + [s1_base + 1 + 3 * t for t in range(2, t_max + 1)])
    pairs = tuple(k - 2 for k in starts if k - 2 + 1 < n)
    return smpl.with_dims(cfg_s, ctx, 2, n, pairs)


def generate_camera_subpath(scene: sa.Scene, camera: cam.Camera, cfg_s, ctx, p_film,
                            max_verts: int, accel, dim_base: int = 40) -> Subpath:
    """bdpt.rs:1108: the camera ray through p_film (lens dims 3-4, time 2)
    and its walk."""
    n, dev = p_film.shape[0], p_film.device
    rays = cam.generate_rays(camera, p_film, smpl.get_2d(cfg_s, ctx, 3),
                             smpl.get_1d(cfg_s, ctx, 2))
    path = _empty_subpath(n, max_verts, dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    ones3 = torch.ones((n, 3), device=dev)
    _set(path, 0, every, p=rays.o, ns=rays.d, ng=rays.d, beta=ones3, pdf_fwd=1.0,
         vtype=VT_CAMERA, valid=every)
    path.count.fill_(1)
    _, pdf_dir = cam.camera_pdf_we(camera, rays.o, rays.d)
    med0 = (torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev)
            if scene.has_media else None)
    return _walk(scene, cfg_s, ctx, rays.o, rays.d, ones3, pdf_dir, max_verts, dim_base, accel,
                 path, mode_importance=False, med0=med0)


def _light_type(scene: sa.Scene, light_idx):
    la = scene.light_attr[light_idx.long()]
    return la, torch.round(la[:, sa.LA_TYPE]).to(torch.int32)


def generate_light_subpath(scene: sa.Scene, cfg_s, ctx, n: int, max_verts: int, light_dist,
                           accel, dim_base: int = 60):
    """bdpt.rs:1161: a light picked by power (dim 20), its emitted ray
    (dims 21-24) and its walk.  Returns (subpath, light ids, selection
    pdfs, the origin's delta test: point, spot and distant lights)."""
    dev = ctx.pixel.device
    li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(light_dist, smpl.get_1d(cfg_s, ctx, 20))
    ls = lt.sample_le(scene, li_idx, smpl.get_2d(cfg_s, ctx, 21), smpl.get_2d(cfg_s, ctx, 23))
    _, ltype = _light_type(scene, li_idx)
    is_delta_l = ((ltype == sa.LIGHT_POINT) | (ltype == sa.LIGHT_SPOT)
                  | (ltype == sa.LIGHT_DISTANT))
    path = _empty_subpath(n, max_verts, dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    # the vertex's delta stays False for delta lights: it marks delta
    # BSDFs only; the origin's delta test is the MIS weight's l0_is_delta
    _set(path, 0, every, p=ls.o, ns=ls.n_light, ng=ls.n_light,
         beta=ls.le / torch.clamp(sel_pdf * ls.pdf_pos, min=1e-20)[:, None], light=li_idx,
         pdf_fwd=sel_pdf * ls.pdf_pos, vtype=VT_LIGHT, valid=every)
    path.count.fill_(1)
    cos0 = vm.dot(ls.n_light, ls.d).abs()
    is_inf = ltype == sa.LIGHT_INFINITE
    beta0 = ls.le * torch.where(ltype == sa.LIGHT_AREA, cos0, 1.0)[:, None] / torch.clamp(
        sel_pdf * ls.pdf_pos * ls.pdf_dir, min=1e-20)[:, None]
    # lights sit in the exterior (camera) medium
    med0 = (torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev)
            if scene.has_media else None)
    walked = _walk(scene, cfg_s, ctx, ls.o + ls.d * 1e-3, ls.d, beta0, ls.pdf_dir, max_verts,
                   dim_base, accel, path, mode_importance=True,
                   prev0_env=is_inf if scene.has_env else None, med0=med0)
    if scene.has_env:
        # the sky's densities (bdpt.rs infinite lights): the origin's
        # pdf_fwd the selection times the direction's (solid angle), the
        # first hit's the position's times its cosine
        walked.pdf_fwd[0] = torch.where(is_inf, sel_pdf * ls.pdf_dir, walked.pdf_fwd[0])
        if max_verts > 1:
            cos1 = vm.dot(walked.ns[1], ls.d).abs()
            walked.pdf_fwd[1] = torch.where(is_inf & walked.valid[1], ls.pdf_pos * cos1,
                                            walked.pdf_fwd[1])
    return walked, li_idx, sel_pdf, is_delta_l


def _vertex_f(scene: sa.Scene, path: Subpath, slot: int, wi_world):
    """(f (N, 3), pdf, reverse pdf) at vertex `slot` toward wi_world
    (Vertex::f): the base material's BSDF, without textures, in an
    arbitrary frame about ns; the HG phase at medium vertices."""
    b = bx.make_bsdf_from_mat(scene, torch.clamp(path.mat[slot], min=0))
    ns, wo, ng = path.ns[slot], path.wo[slot], path.ng[slot]
    ss, ts = _shading_frame(ns)
    wo_l, wi_l = _to_local(wo, ss, ts, ns), _to_local(wi_world, ss, ts, ns)
    reflect = vm.dot(wi_world, ng) * vm.dot(wo, ng) > 0
    fou = bx.fourier_terms(b, wo_l, wi_l)  # one F1 for f and pdf
    f = bx.bsdf_f(b, wo_l, wi_l, reflect, fou)
    pdf = bx.bsdf_pdf(b, wo_l, wi_l, fou)
    pdf_rev = bx.bsdf_pdf(b, wi_l, wo_l)
    if scene.has_media:
        is_med = path.vtype[slot] == VT_MEDIUM
        ph = med.phase_hg(vm.dot(wo, wi_world), scene.med_g[torch.clamp(path.med[slot], min=0)])
        f = torch.where(is_med[:, None], ph[:, None], f)
        pdf = torch.where(is_med, ph, pdf)
        pdf_rev = torch.where(is_med, ph, pdf_rev)
    return f, pdf, pdf_rev


def _seg_tr(scene: sa.Scene, seg_med, dist, o=None, d=None, cast=None):
    """(N, 3) transmittance of a connection segment through the camera-side
    vertex's medium (the JAX volpath._shadow_tr's one-medium approximation):
    closed form, or ratio tracking (M2) through a grid where o, d are
    given; only the lanes of cast track."""
    in_med = seg_med >= 0
    mid = torch.clamp(seg_med, min=0)
    if scene.has_grid and o is not None:
        lane_key = torch.arange(o.shape[0], dtype=torch.int32, device=o.device)
        tr1 = mk.ratio_track(*_media_tables(scene), mid, in_med if cast is None else in_med & cast,
                             o.contiguous(), d.contiguous(), dist.contiguous(), lane_key,
                             SEG_SALT, SEG_SEED)
        return tr1[:, None].expand(-1, 3)
    sigma_t = scene.med_sigma_a[mid] + scene.med_sigma_s[mid]
    return torch.where(in_med[:, None], med.homogeneous_tr(sigma_t, dist), 1.0)


def _g_term(scene: sa.Scene, p_a, n_a, p_b, n_b, accel, a_is_med=None, b_is_med=None,
            seg_med=None, cast=None):
    """(G with visibility, the direction a -> b, Tr) of a connection
    (bdpt.rs:1450): medium endpoints have no cosine; seg_med attenuates.
    Only the lanes of cast (all where None) cast their shadow ray; the
    others read unoccluded."""
    d = p_b - p_a
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    w = d / torch.sqrt(d2)[..., None]
    cos_a, cos_b = vm.dot(n_a, w).abs(), vm.dot(n_b, w).abs()
    if a_is_med is not None:
        cos_a = torch.where(a_is_med, 1.0, cos_a)
    if b_is_med is not None:
        cos_b = torch.where(b_is_med, 1.0, cos_b)
    g = cos_a * cos_b / d2
    o = p_a + w * 1e-3
    dist = torch.sqrt(d2)
    t_max = dist * (1 - 2e-3)
    occ = si.scene_intersect_p(scene, o, w, t_max if cast is None else torch.where(cast, t_max, -1.0),
                               accel)
    if scene.has_media and seg_med is not None:
        tr = _seg_tr(scene, seg_med, dist, o=o, d=w, cast=cast)
    else:
        tr = torch.ones((p_a.shape[0], 3), device=p_a.device)
    return torch.where(occ, 0.0, g), w, tr


def _mis_weight(cpath: Subpath, lpath: Subpath, s: int, t: int, ov: dict, l0_is_delta=None):
    """W1 (``ops/mis_kernel.py``) of strategy (s, t) with the endpoint
    overrides ov, a dict {(side, slot, field): (N,)} as the JAX _mis_weight
    takes."""
    return misk.mis_weight(cpath.pdf_fwd, cpath.pdf_rev, cpath.delta, lpath.pdf_fwd,
                           lpath.pdf_rev, lpath.delta, s, t, misk.overrides(s, t, ov),
                           l0_is_delta)


def _inf_light_density(scene: sa.Scene, light_dist, w):
    """The sky's selection-weighted directional density (bdpt.rs
    infinite_light_density), solid angle; one infinite light at most."""
    idx = torch.full((w.shape[0],), scene.env_light, dtype=torch.int64, device=w.device)
    return smp.distribution_1d_discrete_pdf(light_dist, idx) * lt.pdf_li_env(scene, w)


def _light_origin_pdfs(scene: sa.Scene, light_dist, light_idx, p_light, n_light, p_to):
    """(pdf of choosing and placing the light vertex, its directional pdf
    toward p_to, solid angle), as lights.sample_le emits (Vertex::pdf_light
    / pdf_light_origin): area lights cosine-weighted, point and goniometric
    lights uniform over the sphere, spots and projection lights uniform in
    their cones, distant lights 0 (remapped by the MIS products)."""
    li = torch.clamp(light_idx, min=0)
    sel_pdf = smp.distribution_1d_discrete_pdf(light_dist, li)
    la, ltype = _light_type(scene, li)
    is_area, is_dist = ltype == sa.LIGHT_AREA, ltype == sa.LIGHT_DISTANT
    area = torch.clamp(la[:, sa.LP_AREA], min=1e-12)
    d = p_to - p_light
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    w = d / torch.sqrt(d2)[..., None]
    cos_l = vm.dot(n_light, w).abs()
    pdf_pos = torch.where(is_area, 1.0 / area, 1.0)
    wr = la[:, sa.LP_WORLD_RADIUS]
    pdf_pos = torch.where(is_dist, 1.0 / torch.clamp(vm.PI * wr * wr, min=1e-12), pdf_pos)
    pdf_dir = cos_l * vm.INV_PI
    pdf_dir = torch.where((ltype == sa.LIGHT_POINT) | (ltype == sa.LIGHT_GONIO),
                          smp.UNIFORM_SPHERE_PDF, pdf_dir)
    spot_dir = vm.normalize(la[:, sa.LP_WORLD_CENTER:sa.LP_WORLD_CENTER + 3])
    ct_total = la[:, sa.LP_COS_TOTAL]
    pdf_dir = torch.where(ltype == sa.LIGHT_SPOT,
                          torch.where(vm.dot(spot_dir, w) >= ct_total,
                                      smp.uniform_cone_pdf(ct_total), 0.0), pdf_dir)
    tan_fov = torch.clamp(la[:, sa.LP_TAN_FOV], min=1e-6)
    ct_proj = 1.0 / torch.sqrt(1.0 + 2.0 * tan_fov * tan_fov)
    pdf_dir = torch.where(ltype == sa.LIGHT_PROJECTION,
                          torch.where(vm.dot(spot_dir, w) >= ct_proj,
                                      smp.uniform_cone_pdf(ct_proj), 0.0), pdf_dir)
    return sel_pdf * pdf_pos, torch.where(is_dist, 0.0, pdf_dir)


def radiance_and_splats(scene: sa.Scene, camera: cam.Camera, cfg: PathCfg, cfg_s, ctx, p_film,
                        accel=None, strategy_filter=None, strategy_select=None):
    """The BDPT estimate of a wavefront (bdpt.rs:924-1048): (L (N, 3),
    splat raster points (G N, 2), splat values (G N, 3)), the splats in G
    groups of N lanes, one a t = 1 strategy, unconnectable lanes at -10.
    strategy_filter: a predicate (s, t) -> bool on the strategies run;
    strategy_select: per-lane (depth, s) of MLT's depth-stratified target
    (mlt.rs:310-406), each lane keeping its strategy scaled by the
    strategies at that depth times max_depth + 1 (every strategy still
    runs)."""
    n, dev = p_film.shape[0], p_film.device
    t_max, s_max = cfg.max_depth + 2, cfg.max_depth + 1
    light_dist = _light_select_dist(scene)
    ctx = _draw_dims(cfg_s, ctx, t_max, s_max, scene.has_media)
    cam_base, light_base, s1_base = dim_bases(t_max, s_max, scene.has_media)
    cpath = generate_camera_subpath(scene, camera, cfg_s, ctx, p_film, t_max, accel, cam_base)
    lpath, _, _, l0_delta = generate_light_subpath(scene, cfg_s, ctx, n, s_max, light_dist,
                                                   accel, light_base)
    L = torch.zeros((n, 3), device=dev)
    splat_p, splat_l = [], []
    has_med = scene.has_media

    def is_med(path, i):
        return (path.vtype[i] == VT_MEDIUM) if has_med else None

    def connectible(path, i):
        """A valid surface (or medium) vertex at slot i."""
        vt = path.vtype[i]
        m = vt == VT_SURFACE
        if has_med:
            m = m | (vt == VT_MEDIUM)
        return path.valid[i] & m

    for t in range(1, t_max + 1):
        for s in range(0, s_max + 1):
            depth = s + t - 2
            if depth < 0 or depth > cfg.max_depth or (t == 1 and s == 1):
                continue  # (1, 1) is the (0, 2) and (1, 2) strategies' work
            if strategy_filter is not None and not strategy_filter(s, t):
                continue
            sel_scale = None
            if strategy_select is not None:
                d_sel, s_sel = strategy_select
                n_strategies = 1 if depth == 0 else depth + 2
                sel_scale = torch.where((d_sel == depth) & (s_sel == s),
                                        float(n_strategies * (cfg.max_depth + 1)), 0.0)
            sel = (lambda x: x) if sel_scale is None else (lambda x, k=sel_scale: x * k[:, None])

            if t == 1:  # light vertex s-1 to the camera: a splat
                lv_med = is_med(lpath, s - 1)
                ok = connectible(lpath, s - 1) & ~lpath.delta[s - 1]
                pv = lpath.p[s - 1]
                wi, we, pdf, p_raster, cam_p = cam.camera_sample_wi(camera, pv)
                f, _, pdf_rev_c = _vertex_f(scene, lpath, s - 1, wi)
                g, _, tr = _g_term(scene, pv, lpath.ns[s - 1], cam_p, wi, accel, a_is_med=lv_med,
                                   seg_med=lpath.med[s - 1] if has_med else None,
                                   cast=ok & (pdf > 0))
                # G's camera cosine is folded in We
                cos_v = vm.dot(lpath.ns[s - 1], wi).abs()
                if lv_med is not None:
                    cos_v = torch.where(lv_med, 1.0, cos_v)
                contrib = lpath.beta[s - 1] * f * tr * (we * cos_v / torch.clamp(pdf, min=1e-12))[:, None]
                contrib = torch.where((ok & (g != 0.0) & (pdf > 0))[:, None], contrib, 0.0)
                _, pdf_cam_dir = cam.camera_pdf_we(camera, cam_p, -wi)
                ov = {("l", s - 1, "pdf_rev"): _convert_density(pdf_cam_dir, cam_p, pv,
                                                                lpath.ns[s - 1], to_is_med=lv_med)}
                if s >= 2:
                    ov[("l", s - 2, "pdf_rev")] = _convert_density(
                        pdf_rev_c, pv, lpath.p[s - 2], lpath.ns[s - 2],
                        to_is_med=is_med(lpath, s - 2))
                w_mis = _mis_weight(cpath, lpath, s, 1, ov, l0_is_delta=l0_delta)
                splat_p.append(torch.where(ok[:, None], p_raster, -10.0))
                splat_l.append(sel(contrib * w_mis[:, None]))
                continue

            cv = t - 1  # the camera endpoint's slot
            cv_med = is_med(cpath, cv)
            c_ok = connectible(cpath, cv)

            if s == 0:  # the camera path alone: its endpoint emits
                hl = cpath.light[cv]
                le = lt.area_light_emitted(scene, torch.clamp(hl, min=0), cpath.ns[cv],
                                           cpath.wo[cv])
                ok = c_ok & (hl >= 0)
                contrib = cpath.beta[cv] * le
                prev = cpath.p[cv - 1]
                pdf_orig, pdf_dir_solid = _light_origin_pdfs(scene, light_dist, hl, cpath.p[cv],
                                                             cpath.ns[cv], prev)
                ov = {("c", cv, "pdf_rev"): pdf_orig,
                      ("c", cv - 1, "pdf_rev"): _convert_density(
                          pdf_dir_solid, cpath.p[cv], prev, cpath.ns[cv - 1],
                          to_is_med=is_med(cpath, cv - 1))}
                w_mis = _mis_weight(cpath, lpath, 0, t, ov)
                L = L + sel(torch.where(ok[:, None], contrib * w_mis[:, None], 0.0))
                if scene.has_env:
                    # an escaped camera path on the sky: densities there
                    # stay solid angle; the vertex before takes the sky's
                    # positional density 1/(pi r^2) times its cosine
                    is_env = (cpath.valid[cv] & (cpath.vtype[cv] == VT_LIGHT)
                              & (cpath.light[cv] == ENV_LIGHT))
                    d_esc = -cpath.wo[cv]
                    contrib_e = cpath.beta[cv] * lt.env_le(scene, d_esc)
                    ov_e = {("c", cv, "pdf_rev"): _inf_light_density(scene, light_dist, d_esc)}
                    if cv - 1 >= 1:
                        wr = max(scene.world_radius, 1e-6)
                        cos_prev = vm.dot(cpath.ns[cv - 1], d_esc).abs()
                        ov_e[("c", cv - 1, "pdf_rev")] = cos_prev / (vm.PI * wr * wr)
                    w_mis_e = _mis_weight(cpath, lpath, 0, t, ov_e)
                    L = L + sel(torch.where(is_env[:, None], contrib_e * w_mis_e[:, None], 0.0))
                continue

            if s == 1:  # a fresh light sample toward the camera vertex
                li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(
                    light_dist, smpl.get_1d(cfg_s, ctx, s1_base + 3 * t))
                ls = lt.sample_li(scene, li_idx, cpath.p[cv],
                                  smpl.get_2d(cfg_s, ctx, s1_base + 1 + 3 * t))
                f, pdf_c, pdf_rev_c = _vertex_f(scene, cpath, cv, ls.wi)
                cos_c = vm.dot(cpath.ns[cv], ls.wi).abs()
                o_sh = vm.offset_ray_origin(cpath.p[cv], torch.zeros_like(ls.wi) + 1e-4,
                                            cpath.ng[cv], ls.wi)
                if cv_med is not None:
                    cos_c = torch.where(cv_med, 1.0, cos_c)
                    o_sh = torch.where(cv_med[:, None], cpath.p[cv], o_sh)
                dist = vm.length(ls.p_target - o_sh)
                ok = c_ok & (ls.pdf > 0) & (ls.li > 0).any(-1) & ~cpath.delta[cv]
                occ = si.scene_intersect_p(scene, o_sh, ls.wi,
                                           torch.where(ok, dist * (1 - 1e-3), -1.0), accel)
                tr_s1 = (_seg_tr(scene, cpath.med[cv], dist, o=o_sh, d=ls.wi, cast=ok)
                         if has_med else 1.0)
                ok = ok & ~occ
                contrib = (cpath.beta[cv] * f * ls.li * tr_s1
                           * (cos_c / torch.clamp(ls.pdf * sel_pdf, min=1e-12))[:, None])
                pdf_orig, pdf_dir_solid = _light_origin_pdfs(scene, light_dist, li_idx,
                                                             ls.p_target, ls.n_light, cpath.p[cv])
                # the sampled light vertex stands in for light slot 0
                ov = {("c", cv, "pdf_rev"): _convert_density(pdf_dir_solid, ls.p_target,
                                                             cpath.p[cv], cpath.ns[cv],
                                                             to_is_med=cv_med),
                      ("c", cv - 1, "pdf_rev"): _convert_density(
                          pdf_rev_c, cpath.p[cv], cpath.p[cv - 1], cpath.ns[cv - 1],
                          to_is_med=is_med(cpath, cv - 1)),
                      ("l", 0, "pdf_fwd"): pdf_orig,
                      ("l", 0, "pdf_rev"): _convert_density(pdf_c, cpath.p[cv], ls.p_target,
                                                            ls.n_light),
                      ("l", 0, "delta"): ls.is_delta}
                if scene.has_env:
                    # the sky sampled: densities at it stay solid angle;
                    # toward the camera vertex its positional density
                    _, ltype = _light_type(scene, li_idx)
                    is_env_l = ltype == sa.LIGHT_INFINITE
                    wr = max(scene.world_radius, 1e-6)
                    cos_cv = vm.dot(cpath.ns[cv], ls.wi).abs()
                    if cv_med is not None:
                        cos_cv = torch.where(cv_med, 1.0, cos_cv)
                    ov[("c", cv, "pdf_rev")] = torch.where(is_env_l, cos_cv / (vm.PI * wr * wr),
                                                           ov[("c", cv, "pdf_rev")])
                    ov[("l", 0, "pdf_fwd")] = torch.where(
                        is_env_l, _inf_light_density(scene, light_dist, ls.wi),
                        ov[("l", 0, "pdf_fwd")])
                    ov[("l", 0, "pdf_rev")] = torch.where(is_env_l, pdf_c, ov[("l", 0, "pdf_rev")])
                w_mis = _mis_weight(cpath, lpath, 1, t, ov, l0_is_delta=ls.is_delta)
                L = L + sel(torch.where(ok[:, None], contrib * w_mis[:, None], 0.0))
                continue

            # the general connection, s >= 2 and t >= 2
            lv = s - 1
            lv_med = is_med(lpath, lv)
            pc, pl = cpath.p[cv], lpath.p[lv]
            ok = c_ok & connectible(lpath, lv) & ~cpath.delta[cv] & ~lpath.delta[lv]
            g, w, tr_c = _g_term(scene, pc, cpath.ns[cv], pl, lpath.ns[lv], accel,
                                 a_is_med=cv_med, b_is_med=lv_med,
                                 seg_med=cpath.med[cv] if has_med else None, cast=ok)
            f_c, pdf_c_fwd, pdf_c_rev = _vertex_f(scene, cpath, cv, w)
            f_l, pdf_l_fwd, pdf_l_rev = _vertex_f(scene, lpath, lv, -w)
            ok = ok & (g > 0)
            contrib = cpath.beta[cv] * f_c * f_l * lpath.beta[lv] * g[:, None] * tr_c
            ov = {("c", cv, "pdf_rev"): _convert_density(pdf_l_fwd, pl, pc, cpath.ns[cv],
                                                         to_is_med=cv_med),
                  ("l", lv, "pdf_rev"): _convert_density(pdf_c_fwd, pc, pl, lpath.ns[lv],
                                                         to_is_med=lv_med),
                  ("c", cv - 1, "pdf_rev"): _convert_density(
                      pdf_c_rev, pc, cpath.p[cv - 1], cpath.ns[cv - 1],
                      to_is_med=is_med(cpath, cv - 1)),
                  ("l", lv - 1, "pdf_rev"): _convert_density(
                      pdf_l_rev, pl, lpath.p[lv - 1], lpath.ns[lv - 1],
                      to_is_med=is_med(lpath, lv - 1))}
            w_mis = _mis_weight(cpath, lpath, s, t, ov, l0_is_delta=l0_delta)
            L = L + sel(torch.where(ok[:, None], contrib * w_mis[:, None], 0.0))

    if splat_p:
        return L, torch.cat(splat_p), torch.cat(splat_l)
    return L, torch.full((1, 2), -10.0, device=dev), torch.zeros((1, 3), device=dev)


def add_rect(scene: sa.Scene, camera: cam.Camera, spp: int, max_depth: int, sampler_cfg, accel,
             film: filmmod.Film, rect, spp_per_batch: int) -> int:
    """Adds spp samples of every pixel of rect (y0, h, x0, w) to film in
    place, spp_per_batch samples a pixel a batch: the box filter's samples
    by pixel, the t = 1 splats to the splat layer.  Returns the batches."""
    dev = scene.device
    y0, hh, x0, ww = rect
    n_pix = hh * ww
    xs = torch.arange(x0, x0 + ww, dtype=torch.int64, device=dev)
    ys = torch.arange(y0, y0 + hh, dtype=torch.int64, device=dev)
    pixels = torch.stack([xs.repeat(hh), ys.repeat_interleave(ww)], -1)
    fcfg = filmmod.make_filter(filmmod.FILTER_BOX)
    pcfg = PathCfg(max_depth, 1.0)
    sample = batches = 0
    while sample < spp:
        nb = min(spp_per_batch, spp - sample)
        pix = pixels.repeat(nb, 1)
        snums = torch.arange(sample, sample + nb, dtype=torch.int64,
                             device=dev).repeat_interleave(n_pix)
        ctx = smpl.make_ctx(sampler_cfg, pix, snums, frame_lt_spp=True)
        u_film, _, _ = smpl.get_camera_dims(sampler_cfg, ctx, pix)
        L, sp, sl = radiance_and_splats(scene, camera, pcfg, sampler_cfg, ctx,
                                        pix.to(torch.float32) + u_film, accel)
        # a half-pixel box adds each sample to its own pixel
        filmmod.add_samples_grid(film, fcfg, L, nb, rect)
        filmmod.add_splats(film, sp, sl)
        sample += nb
        batches += 1
    return batches


def resolve(film: filmmod.Film, spp: int, crop_rect=None) -> torch.Tensor:
    """The image of a BDPT film: the splats scaled by 1/spp (bdpt.rs:1071),
    pixels outside the crop rect (px0, px1, py0, py1) black."""
    img = filmmod.to_rgb(film, splat_scale=1.0 / spp)
    if crop_rect is not None:
        px0, px1, py0, py1 = crop_rect
        out = torch.zeros_like(img)
        out[py0:py1, px0:px1] = img[py0:py1, px0:px1]
        img = out
    return img


def render_bdpt(scene: sa.Scene, camera: cam.Camera, spp: int, max_depth: int = 5,
                sampler_cfg: Optional[smpl.SamplerCfg] = None, accel=None,
                max_lanes: int = MAX_LANES, crop_rect=None, stats: Optional[dict] = None):
    """The BDPT image (H, W, 3) (BDPTIntegrator::render bdpt.rs:849): spp
    samples of every pixel of the crop rect (px0, px1, py0, py1), the whole
    film without one, in batches of at most max_lanes paths; the box
    filter's samples added by pixel, the splats scaled by 1/spp at resolve
    (bdpt.rs:1071), pixels outside the crop black.  stats, where given,
    gets the batches."""
    if sampler_cfg is None:
        sampler_cfg = smpl.make_sampler(smpl.RANDOM, spp, camera.resolution)
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_rect if crop_rect is not None else (0, w, 0, h)
    rect = (py0, py1 - py0, px0, px1 - px0)
    film = filmmod.make_film((w, h), scene.device)
    batches = add_rect(scene, camera, spp, max_depth, sampler_cfg, accel, film, rect,
                       max(1, min(spp, max_lanes // (rect[1] * rect[3]))))
    if stats is not None:
        stats["batches"] = batches
    return resolve(film, spp, crop_rect)
