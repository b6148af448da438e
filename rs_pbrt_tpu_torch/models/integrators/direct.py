"""The direct-lighting estimators and the whitted and directlighting
integrators.

The port of the JAX package's ``models/integrators/direct.py`` (reference
src/integrators/whitted.rs, directlighting.rs and the estimators of
src/core/integrator.rs:300-570) for the scenes the port can intersect,
shade and light: triangles, spheres and curves, matte, mirror, glass and
hair materials, area, point, spot and distant lights.  The specular
continuation follows the sampled lobe: a mirror's reflection, or smooth
glass's reflection or transmission as Fresnel picks it (whitted.rs's
specular_reflect and specular_transmit).  Each depth intersects through K5 (``scene_intersect``), casts
one shadow ray per light sample through K4 (``scene_intersect_p``) and
draws its integrator dims in one K1 launch (``samplers.with_dims``); the
rest is plain PyTorch.  Scenes with a BVH (``accel``) intersect through
B1 and B2 instead of K5 and K4.  The ao integrator is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import bsdf as bx
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import lights as lt
from .. import samplers as smpl
from .path import _light_select_dist, _shading_frame_du, _to_local, _to_world

DIM_CAMERA = 5


def dims_per_depth(scene: sa.Scene) -> int:
    """Sampler dims of one depth: 2 per light (or the light pick and 2),
    then the bsdf sample's 2 and its lobe choice (direct.py:158)."""
    return 2 * max(scene.n_lights, 1) + 3


def _direct_one_light(scene, light_idx, sel_pdf, it, b, ss, ts, u_light, accel, mis=True):
    """estimate_direct's light-sampling half for a chosen light
    (integrator.rs:406): Li f |cos| / pdf, zero where the shadow ray is
    blocked; MIS against the bsdf pdf when mis."""
    wo_l = _to_local(it.wo, ss, ts, it.ns)
    ls = lt.sample_li(scene, light_idx, it.p, u_light)
    wi_l = _to_local(ls.wi, ss, ts, it.ns)
    reflect = vm.dot(ls.wi, it.ng) * vm.dot(it.wo, it.ng) > 0.0
    f = bx.bsdf_f(b, wo_l, wi_l, reflect) * bx.abs_cos_theta(wi_l)[:, None]
    scat_pdf = bx.bsdf_pdf(b, wo_l, wi_l)
    ok = it.valid & (ls.pdf > 0.0) & (ls.li > 0.0).any(-1) & (f > 0.0).any(-1)
    p_shadow = vm.offset_ray_origin(it.p, it.p_error, it.ng, ls.wi)
    delta_sh = ls.p_target - p_shadow
    dist = vm.length(delta_sh)
    sh_d = delta_sh / torch.clamp(dist, min=1e-12)[:, None]
    occluded = si.scene_intersect_p(scene, p_shadow, sh_d, dist * (1.0 - 1e-3), accel)
    if mis:
        w = torch.where(ls.is_delta, 1.0, smp.power_heuristic(ls.pdf, scat_pdf))
    else:
        w = torch.ones_like(ls.pdf)
    ld = f * ls.li * (w / torch.clamp(ls.pdf * sel_pdf, min=1e-12))[:, None]
    return torch.where((ok & ~occluded)[:, None], ld, 0.0)


def uniform_sample_all_lights(scene, cfg_s, ctx, it, b, ss, ts, dim0, accel=None):
    """One sample of every light, without MIS (integrator.rs:300)."""
    n = it.p.shape[0]
    L = torch.zeros((n, 3), device=it.p.device)
    one = torch.ones(n, device=it.p.device)
    for li in range(scene.n_lights):
        u_light = smpl.get_2d(cfg_s, ctx, dim0 + 2 * li)
        idx = torch.full((n,), li, dtype=torch.int32, device=it.p.device)
        L = L + _direct_one_light(scene, idx, one, it, b, ss, ts, u_light, accel, mis=False)
    return L


def uniform_sample_one_light(scene, cfg_s, ctx, it, b, ss, ts, dim0, light_dist, accel=None):
    """One light picked by power, with MIS (integrator.rs:359)."""
    u_sel = smpl.get_1d(cfg_s, ctx, dim0)
    u_light = smpl.get_2d(cfg_s, ctx, dim0 + 1)
    li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(light_dist, u_sel)
    return _direct_one_light(scene, li_idx, sel_pdf, it, b, ss, ts, u_light, accel, mis=True)


class WhittedCfg(NamedTuple):
    max_depth: int


class DirectLightingCfg(NamedTuple):
    max_depth: int
    sample_all: bool  # LightStrategy::UniformSampleAll, else one light by power


def check_supported(scene: sa.Scene, accel=None):
    """Raises NotImplementedError for what these integrators cannot render
    yet: the intersection, material and light checks, and environment light."""
    si.check_supported(scene, accel)
    bx.check_supported(scene)
    lt.check_supported(scene)
    if scene.has_env:
        raise NotImplementedError("environment lights are not ported yet (ROADMAP queue A)")


def _direct_radiance(scene, max_depth, sample_all, cfg_s, ctx, ray_o, ray_d, accel=None):
    """The loop whitted.rs and directlighting.rs share: at each depth the
    emission of a hit light, direct light at the hit (every light, or one
    by power), then the specular continuation only."""
    check_supported(scene, accel)
    n = ray_o.shape[0]
    dev = ray_o.device
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    o, d = ray_o.contiguous(), ray_d.contiguous()
    t_max = torch.full((n,), float(vm.INFINITY), device=dev)
    n_l = scene.n_lights
    light_dist = _light_select_dist(scene) if n_l > 0 and not sample_all else None
    n_dims = dims_per_depth(scene)
    for depth in range(max_depth):
        it = si.scene_intersect(scene, o, d, t_max, accel)
        if n_l > 0:
            hl = torch.where(it.valid & alive, it.light, -1)
            le = lt.area_light_emitted(scene, torch.clamp(hl, min=0), it.ns, it.wo)
            L = L + torch.where((hl >= 0)[:, None], beta * le, 0.0)
        alive = alive & it.valid

        b = bx.make_bsdf_at(scene, it)
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        dim0 = DIM_CAMERA + depth * n_dims
        ctx_d = smpl.with_dims(cfg_s, ctx, dim0, n_dims)
        if n_l > 0:
            if sample_all:
                ld = uniform_sample_all_lights(scene, cfg_s, ctx_d, it, b, ss, ts, dim0, accel)
            else:
                ld = uniform_sample_one_light(scene, cfg_s, ctx_d, it, b, ss, ts, dim0,
                                              light_dist, accel)
            L = L + torch.where(alive[:, None], beta * ld, 0.0)

        # the specular continuation only
        wo_l = _to_local(it.wo, ss, ts, it.ns)
        u2 = smpl.get_2d(cfg_s, ctx_d, dim0 + 2 * max(n_l, 1))
        uc = smpl.get_1d(cfg_s, ctx_d, dim0 + 2 * max(n_l, 1) + 2)
        bs = bx.bsdf_sample(b, wo_l, u2, uc)
        cont = alive & bs.is_specular & (bs.pdf > 0.0) & (bs.f > 0.0).any(-1)
        wi_w = _to_world(bs.wi, ss, ts, it.ns)
        scale = (vm.absdot(wi_w, it.ns) / torch.clamp(bs.pdf, min=1e-12))[:, None]
        beta = torch.where(cont[:, None], beta * bs.f * scale, beta)
        o = torch.where(cont[:, None], vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_w), o)
        d = torch.where(cont[:, None], wi_w, d)
        alive = cont
    return L


def whitted_radiance(scene, wcfg: WhittedCfg, cfg_s, ctx, ray_o, ray_d, accel=None):
    """Whitted (whitted.rs): direct light from every light without MIS and
    the specular recursion (integrator.rs:259-294)."""
    return _direct_radiance(scene, wcfg.max_depth, True, cfg_s, ctx, ray_o, ray_d, accel)


def directlighting_radiance(scene, dcfg: DirectLightingCfg, cfg_s, ctx, ray_o, ray_d,
                            accel=None):
    """DirectLighting (directlighting.rs) with the "all" or "one" strategy."""
    return _direct_radiance(scene, dcfg.max_depth, dcfg.sample_all, cfg_s, ctx, ray_o, ray_d,
                            accel)
