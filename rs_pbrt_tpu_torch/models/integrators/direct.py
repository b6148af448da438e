"""The direct-lighting estimators and the whitted, directlighting and ao
integrators.

The port of the JAX package's ``models/integrators/direct.py`` (reference
src/integrators/whitted.rs, directlighting.rs, ao.rs and the estimators of
src/core/integrator.rs:300-570) for the scenes the port can intersect,
shade and light: triangles, quadrics and curves, every material and
light, textures (image maps filtered by the camera rays' differentials at
the first hit).  The
specular continuation follows the sampled lobe: a mirror's reflection, or
smooth glass's reflection or transmission as Fresnel picks it (whitted.rs's
specular_reflect and specular_transmit).  Each depth intersects through K5
(``scene_intersect``), casts one shadow ray per light sample through K4
(``scene_intersect_p``) and draws its integrator dims in one K1 launch
(``samplers.with_dims``); the rest is plain PyTorch.  Scenes with a BVH
(``accel``) intersect through B1 and B2 instead of K5 and K4.  A ray that
escapes collects the infinite light's radiance.  As in the JAX package,
directlighting's estimator has only the light-sampling half (no
BSDF-sampled MIS half).  The ao integrator casts one closest hit a camera
ray and then its shadow rays (K4, or B2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import bsdf as bx
from ...ops import differentials as rd
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...ops import sobol_kernel as sk
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


def depth_pairs(scene: sa.Scene, sample_all: bool) -> tuple:
    """The offsets of one depth's 2D draws: each light's sample (or the
    picked light's, after the pick), then the bsdf sample."""
    n_l = scene.n_lights
    lights = tuple(range(0, 2 * n_l, 2)) if sample_all else ((1,) if n_l > 0 else ())
    return lights + (2 * max(n_l, 1),)


def _direct_one_light(scene, light_idx, sel_pdf, it, b, ss, ts, u_light, accel, mis=True):
    """estimate_direct's light-sampling half for a chosen light
    (integrator.rs:406): Li f |cos| / pdf, zero where the shadow ray is
    blocked; MIS against the bsdf pdf when mis."""
    wo_l = _to_local(it.wo, ss, ts, it.ns)
    ls = lt.sample_li(scene, light_idx, it.p, u_light)
    wi_l = _to_local(ls.wi, ss, ts, it.ns)
    reflect = vm.dot(ls.wi, it.ng) * vm.dot(it.wo, it.ng) > 0.0
    fou = bx.fourier_terms(b, wo_l, wi_l)  # one F1 for f and pdf
    f = bx.bsdf_f(b, wo_l, wi_l, reflect, fou) * bx.abs_cos_theta(wi_l)[:, None]
    scat_pdf = bx.bsdf_pdf(b, wo_l, wi_l, fou)
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
    yet: what scene intersection refuses."""
    si.check_supported(scene, accel)


def _direct_radiance(scene, max_depth, sample_all, cfg_s, ctx, ray_o, ray_d, accel=None,
                     diffs=None):
    """The loop whitted.rs and directlighting.rs share: at each depth the
    emission of a hit light or of the infinite light where the ray escapes,
    direct light at the hit (every light, or one by power), then the
    specular continuation only.  diffs: the camera rays' differentials
    (ops/differentials.py), whose footprints filter the image maps at the
    first hits; later depths read level 0."""
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
    n_dims, pairs = dims_per_depth(scene), depth_pairs(scene, sample_all)
    for depth in range(max_depth):
        it = si.scene_intersect(scene, o, d, t_max, accel)
        if n_l > 0:
            hl = torch.where(it.valid & alive, it.light, -1)
            le = lt.area_light_emitted(scene, torch.clamp(hl, min=0), it.ns, it.wo)
            L = L + torch.where((hl >= 0)[:, None], beta * le, 0.0)
        if scene.has_env:
            # the infinite light along a ray that escapes, unweighted
            L = L + torch.where((alive & ~it.valid)[:, None], beta * lt.env_le(scene, d), 0.0)
        alive = alive & it.valid

        width = None
        if diffs is not None and depth == 0:
            width = rd.duv_width_at_hit(scene, it, diffs)
        b = bx.make_bsdf_at(scene, it, width)
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        dim0 = DIM_CAMERA + depth * n_dims
        ctx_d = smpl.with_dims(cfg_s, ctx, dim0, n_dims, pairs)
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


def whitted_radiance(scene, wcfg: WhittedCfg, cfg_s, ctx, ray_o, ray_d, accel=None,
                     diffs=None):
    """Whitted (whitted.rs): direct light from every light without MIS and
    the specular recursion (integrator.rs:259-294)."""
    return _direct_radiance(scene, wcfg.max_depth, True, cfg_s, ctx, ray_o, ray_d, accel,
                            diffs)


def directlighting_radiance(scene, dcfg: DirectLightingCfg, cfg_s, ctx, ray_o, ray_d,
                            accel=None, diffs=None):
    """DirectLighting (directlighting.rs) with the "all" or "one" strategy."""
    return _direct_radiance(scene, dcfg.max_depth, dcfg.sample_all, cfg_s, ctx, ray_o, ray_d,
                            accel, diffs)


class AOCfg(NamedTuple):
    n_samples: int  # shadow rays a camera ray
    cos_sample: bool  # cosine-weighted directions, else uniform on the hemisphere


def ao_radiance(scene, acfg: AOCfg, cfg_s, ctx, ray_o, ray_d, accel=None):
    """Ambient occlusion (ao.rs): at the camera ray's hit, n_samples
    directions on the hemisphere of the geometric normal faced toward the
    ray (sample s from dims DIM_CAMERA + 2s and + 2s + 1), each shadow ray
    unbounded, adding dot(wi, n) / pdf where it escapes: no 1/pi, so an
    open plane gives pi (ao.rs:94).  The dims are drawn in launches of at
    most sobol_kernel.MAX_DIMS.  -> (N, 3), the value on every channel."""
    check_supported(scene, accel)
    n, dev = ray_o.shape[0], ray_o.device
    inf = torch.full((n,), float(vm.INFINITY), device=dev)
    it = si.scene_intersect(scene, ray_o.contiguous(), ray_d.contiguous(), inf, accel)
    nf = vm.face_forward(it.ng, -ray_d)
    ss, ts = vm.coordinate_system(nf)
    n_dims = 2 * acfg.n_samples
    dims = torch.cat([smpl.get_dims(cfg_s, ctx, DIM_CAMERA + k, min(sk.MAX_DIMS, n_dims - k),
                                    tuple(range(0, min(sk.MAX_DIMS, n_dims - k), 2)))
                      for k in range(0, n_dims, sk.MAX_DIMS)], 1)
    acc = torch.zeros(n, device=dev)
    for s in range(acfg.n_samples):
        u = dims[:, 2 * s:2 * s + 2]
        if acfg.cos_sample:
            wi_l = smp.cosine_sample_hemisphere(u)
            pdf = smp.cosine_hemisphere_pdf(wi_l[:, 2].abs())
        else:
            wi_l = smp.uniform_sample_hemisphere(u)
            pdf = torch.full((n,), smp.UNIFORM_HEMISPHERE_PDF, device=dev)
        wi = _to_world(wi_l, ss, ts, nf)
        o = vm.offset_ray_origin(it.p, it.p_error, nf, wi)
        occ = si.scene_intersect_p(scene, o, wi, inf, accel)
        acc = acc + torch.where((pdf > 0.0) & ~occ & it.valid,
                                vm.dot(wi, nf) / torch.clamp(pdf, min=1e-9), 0.0)
    return (acc / acfg.n_samples)[:, None].expand(-1, 3).contiguous()
