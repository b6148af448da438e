"""Volumetric path integrator: path tracing with a medium sample on every
segment.

The port of the JAX package's ``models/integrators/volpath.py`` (reference
src/integrators/volpath.rs:60-357).  Each bounce: the closest surface hit;
on a segment inside a medium a distance sample, homogeneous in closed form
(``ops/medium.homogeneous_sample``) or, in a scene with a density grid, by
delta tracking (M1, ``ops/medium_kernel.delta_track``); then either a
medium interaction (Henyey-Greenstein scattering) or the surface's (the
BSDF); NEE from that point with the current medium's transmittance
(closed form, or ratio tracking, M2), MIS against the phase function or
the BSDF; the continuation; the BSSRDF's transport at a transmissive
bounce off a subsurface material (``path.sss_transport``); the medium
change where the ray crosses a real interface (inside != outside); and
Russian roulette after bounce 3.  Lights are selected by power.  A lane's
current medium replaces the reference's MediumInterface chain
(interaction.rs spawn_ray).

Each bounce draws 11 dims (the path's 7, the medium's channel and
distance, the phase direction) and 8 more with subsurface, all bounces'
in one K1 launch where that is at most 128 dims, else one launch a
bounce, as the JAX package draws them.  The tracking's uniforms are the
hash RNG's, keyed by the lane's index in the batch (``arange(n)``) with a
constant seed, and for ratio tracking a constant salt, as in the JAX
package: the same lane draws the same tracking numbers in every batch, so
a render with grid media equals the JAX package's only at the same
batching.  Volpath never regenerates paths (the JAX package regenerates
only "path").  A ray that escapes collects the infinite light's radiance,
MIS-weighted against its light sampling by power.  Textures (which would
need ray differentials) raise.
"""

from __future__ import annotations

import torch

from ...ops import bsdf as bx
from ...ops import differentials as rd
from ...ops import medium as med
from ...ops import medium_kernel as mk
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...ops import sobol_kernel as sk
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import lights as lt
from .. import samplers as smpl
from .path import (DIM_CAMERA, SSS_EXTRA_DIMS, SSS_PAIRS, PathCfg, _add_emitted,
                   _light_select_dist, _shading_frame_du, _to_local, _to_world, sss_transport)

# dims a bounce: the path's 7, then +7 medium channel, +8 medium distance,
# +9,10 phase direction; subsurface appends its 8 at +11
DIMS_PER_BOUNCE = 11
# the offsets the JAX package reads as 2D draws (u2d, volpath.py:196-298):
# light u, bsdf u, phase direction; subsurface's three at +11
PAIRS = (1, 3, 9)
TRACK_SEED = 0x517  # the tracking RNG's seed (volpath.py:211)
RATIO_SALT = 0x5AD  # ratio tracking's salt (volpath.py:139)


def dims_per_bounce(scene: sa.Scene) -> int:
    return DIMS_PER_BOUNCE + (SSS_EXTRA_DIMS if scene.has_subsurface else 0)


def bounce_pairs(scene: sa.Scene) -> tuple:
    return PAIRS + (tuple(DIMS_PER_BOUNCE + k for k in SSS_PAIRS) if scene.has_subsurface
                    else ())


def _media_tables(scene: sa.Scene) -> tuple:
    """The tables M1 and M2 read, in their wrappers' order."""
    return (scene.med_grid, scene.med_w2m, scene.med_sigma_a, scene.med_sigma_s,
            scene.med_max_density)


def _prim_media(scene: sa.Scene, it: si.Interaction):
    """(inside, outside) medium ids of the hit primitives, -1 where none
    (volpath.py:110-129: a hit past the triangles reads the quadrics'
    columns)."""
    inside = torch.full_like(it.prim, -1)
    outside = torch.full_like(it.prim, -1)
    col = lambda rows, c: torch.round(rows[:, c]).to(torch.int32)
    if scene.n_tris > 0:
        is_tri = it.valid & (it.prim >= 0) & (it.prim < scene.n_tris)
        at = scene.tri_attr[torch.clamp(it.prim, 0, scene.n_tris - 1).long()]
        inside = torch.where(is_tri, col(at, sa.TA_MED_IN), inside)
        outside = torch.where(is_tri, col(at, sa.TA_MED_OUT), outside)
    if scene.n_spheres > 0:
        is_sph = it.valid & (it.prim >= scene.n_tris)
        sat = scene.sph_attr[torch.clamp(it.prim - scene.n_tris, 0, scene.n_spheres - 1).long()]
        inside = torch.where(is_sph, col(sat, sa.SP_MED_IN), inside)
        outside = torch.where(is_sph, col(sat, sa.SP_MED_OUT), outside)
    return inside, outside


def _shadow_tr(scene: sa.Scene, cur_med, p0, d, dist, ok, accel, lane_key):
    """(occluded, Tr (N, 3)) of the shadow segments of the lanes of ok
    (scene.rs:79 intersect_tr, simplified as in the JAX package: opaque
    occluders block; the current medium attenuates the whole segment, in
    closed form or by ratio tracking, M2).  Other lanes cast nothing."""
    occluded = si.scene_intersect_p(scene, p0, d, torch.where(ok, dist * (1.0 - 1e-3), -1.0),
                                    accel)
    mid = torch.clamp(cur_med, min=0)
    if scene.has_grid:
        tr1 = mk.ratio_track(*_media_tables(scene), mid, ok & (cur_med >= 0), p0.contiguous(),
                             d.contiguous(), dist.contiguous(), lane_key, RATIO_SALT, TRACK_SEED)
        return occluded, tr1[:, None].expand(-1, 3)
    sigma_t = scene.med_sigma_a[mid] + scene.med_sigma_s[mid]
    return occluded, torch.where((cur_med >= 0)[:, None], med.homogeneous_tr(sigma_t, dist), 1.0)


def radiance(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg, ctx: smpl.SampleCtx,
             ray_o: torch.Tensor, ray_d: torch.Tensor, accel=None, diffs=None) -> torch.Tensor:
    """(N, 3) radiance along N camera rays: max_depth + 1 bounces
    (volpath.py:149-368).  diffs: the camera rays' differentials, whose
    footprints filter the image maps at bounce 0 (later bounces read level
    0)."""
    si.check_supported(scene, accel)
    n, dev = ray_o.shape[0], ray_o.device
    light_dist = _light_select_dist(scene) if scene.n_lights > 0 else None
    dist_at = lambda p: light_dist
    dpb, pairs = dims_per_bounce(scene), bounce_pairs(scene)
    total_dims = dpb * (cfg.max_depth + 1)
    dyn = smpl.traced_route(sampler_cfg, total_dims)
    all_dims = (smpl.get_dims(sampler_cfg, ctx, DIM_CAMERA, total_dims,
                              smpl.repeat_pairs(pairs, dpb, cfg.max_depth + 1), dyn)
                if total_dims <= sk.MAX_DIMS else None)
    lane_key = torch.arange(n, dtype=torch.int32, device=dev) if scene.has_grid else None
    far = 2.0 * scene.world_radius * 4.0  # a miss's segment (world_radius is an f32)
    inf = float(vm.INFINITY)
    o, d = ray_o.contiguous(), ray_d.contiguous()
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(n, device=dev)
    cur_med = torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev)
    for bounce in range(cfg.max_depth + 1):
        # dead lanes cast with t_max = -1, which the traversal ends at once
        it = si.scene_intersect(scene, o, d, torch.where(alive, inf, -1.0), accel)
        dims = (all_dims[:, bounce * dpb:(bounce + 1) * dpb] if all_dims is not None else
                smpl.get_dims(sampler_cfg, ctx, DIM_CAMERA + bounce * dpb, dpb, pairs, dyn))

        # the medium's distance sample on the segment (volpath.rs:96-105)
        in_med = alive & (cur_med >= 0)
        mid = torch.clamp(cur_med, min=0)
        seg_t = torch.where(it.valid, it.t, far)
        if scene.has_grid:
            ms = med.MediumSample(*mk.delta_track(*_media_tables(scene), mid, in_med, o, d,
                                                  seg_t.contiguous(), lane_key, bounce,
                                                  TRACK_SEED))
        else:
            ms = med.homogeneous_sample(scene.med_sigma_a[mid], scene.med_sigma_s[mid],
                                        dims[:, 7], dims[:, 8], seg_t)
        med_scatter = in_med & ms.sampled
        beta = torch.where(in_med[:, None], beta * ms.weight, beta)

        # emission where the segment reaches the surface, the infinite
        # light's where it escapes
        L = _add_emitted(scene, dist_at, it, o, d, L, beta, alive & ~med_scatter,
                         specular_bounce, prev_pdf)
        alive = alive & (it.valid | med_scatter) & (bounce < cfg.max_depth)
        p_med = o + ms.t[:, None] * d
        g = scene.med_g[mid]
        b = bx.make_bsdf_at(scene, it, rd.bounce_width(scene, it, diffs, bounce))
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        wo_l = _to_local(it.wo, ss, ts, it.ns)

        # NEE from the medium point (the phase function) or the surface (the BSDF)
        if scene.n_lights > 0:
            li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(light_dist, dims[:, 0])
            ref_p = torch.where(med_scatter[:, None], p_med, it.p)
            ls = lt.sample_li(scene, li_idx, ref_p, dims[:, 1:3])
            wi_l = _to_local(ls.wi, ss, ts, it.ns)
            reflect = vm.dot(ls.wi, it.ng) * vm.dot(it.wo, it.ng) > 0.0
            fou = bx.fourier_terms(b, wo_l, wi_l)  # one F1 for f and pdf
            f_surf = bx.bsdf_f(b, wo_l, wi_l, reflect, fou) * bx.abs_cos_theta(wi_l)[:, None]
            pdf_surf = bx.bsdf_pdf(b, wo_l, wi_l, fou)
            ph = med.phase_hg(vm.dot(-d, ls.wi), g)
            f_scat = torch.where(med_scatter[:, None], ph[:, None], f_surf)
            pdf_scat = torch.where(med_scatter, ph, pdf_surf)
            p_shadow = torch.where(med_scatter[:, None], p_med,
                                   vm.offset_ray_origin(it.p, it.p_error, it.ng, ls.wi))
            delta_sh = ls.p_target - p_shadow
            dist = vm.length(delta_sh)
            sh_d = delta_sh / torch.clamp(dist, min=1e-12)[:, None]
            ok = alive & (ls.pdf > 0.0) & (ls.li > 0.0).any(-1) & (f_scat > 0.0).any(-1)
            occ, tr = _shadow_tr(scene, cur_med, p_shadow, sh_d, dist, ok, accel, lane_key)
            w_l = torch.where(ls.is_delta, 1.0, smp.power_heuristic(ls.pdf, pdf_scat))
            ld = beta * f_scat * tr * ls.li * (
                w_l / torch.clamp(ls.pdf * sel_pdf, min=1e-12))[:, None]
            L = L + torch.where((ok & ~occ)[:, None], ld, 0.0)

        # the continuation: a phase sample (which is its own pdf: beta
        # stays) or a BSDF sample
        wi_med, ph_pdf = med.hg_sample_phase(-d, dims[:, 9:11], g)
        bs = bx.bsdf_sample(b, wo_l, dims[:, 3:5], dims[:, 5])
        wi_surf = _to_world(bs.wi, ss, ts, it.ns)
        cos_wi = vm.absdot(wi_surf, it.ns)
        ok_surf = (bs.pdf > 0.0) & (bs.f > 0.0).any(-1)
        beta_surf = beta * bs.f * (cos_wi / torch.clamp(bs.pdf, min=1e-12))[:, None]
        new_d = torch.where(med_scatter[:, None], wi_med, wi_surf)
        new_beta = torch.where(med_scatter[:, None], beta, beta_surf)
        ok = med_scatter | ok_surf
        new_o = torch.where(med_scatter[:, None], p_med,
                            vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_surf))
        beta = torch.where((alive & ok)[:, None], new_beta, beta)
        o = torch.where(alive[:, None], new_o, o)
        d = torch.where(alive[:, None], new_d, d)
        alive = alive & ok
        specular_bounce = torch.where(alive, ~med_scatter & bs.is_specular, specular_bounce)
        prev_pdf = torch.where(alive, torch.where(med_scatter, ph_pdf,
                                                  torch.where(bs.is_specular, 1.0, bs.pdf)),
                               prev_pdf)

        # the BSSRDF at transmissive surface bounces (volpath.rs:191-249)
        if scene.has_subsurface:
            L, beta, o, d, alive, specular_bounce, prev_pdf = sss_transport(
                scene, accel, it, bs, ss, ts, beta, L, alive, o, d, specular_bounce, prev_pdf,
                light_dist, dims, DIMS_PER_BOUNCE, eligible=~med_scatter)

        # the medium changes only where the surface is a real interface
        # (medium.rs is_medium_transition): a plain surface in fog keeps it
        m_in, m_out = _prim_media(scene, it)
        crossed = alive & ~med_scatter & it.valid & (m_in != m_out)
        entering = vm.dot(new_d, it.ng) < 0.0
        cur_med = torch.where(crossed, torch.where(entering, m_in, m_out), cur_med)

        # Russian roulette after bounce 3
        if bounce > 2:
            rr_beta_max = beta.max(-1).values
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            consider = (rr_beta_max < cfg.rr_threshold) & alive
            kill = consider & (dims[:, 6] < q)
            beta = torch.where((consider & ~kill)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
            alive = alive & ~kill
    return L
