"""Path integrator with NEE, MIS and Russian roulette.

The port of the JAX package's ``models/integrators/path.py`` (reference
src/integrators/path.rs:59-281, integrator.rs:359-570) with its fixed-depth
loop (the JAX ``radiance(..., regen=False)``).  Scenes the bounce kernel
takes (all matte, triangles only, lit by triangle-range area lights, see
``ops/path_kernel.mega_cfg``) run one K2 launch per bounce.  Every other
ported scene takes the general wavefront bounce: each bounce intersects
(K5, or B1 through the scene's BVH), adds emission with MIS, samples one
light by power with a shadow ray (K4, or B2), samples the BSDF and plays
Russian roulette, in plain PyTorch around the kernels; the bounce dims of
all bounces are drawn in one K1 launch.  Lights are selected by power, or
by the shading point's voxel where a spatial distribution
(``models/lightdistrib.py``) is given.  Through a BVH, with more paths than
one lane width, ``radiance(..., regen=True)`` runs the regeneration loop of
``regen.py`` instead, the same estimator.  The Sobol' sampler's dims
come from K1, the random sampler's from its hash.  At a transmissive
bounce off a subsurface material, ``sss_transport`` (path.py:86-269 of the
JAX package, shared with ``volpath.py``) samples the exit point of the
BSSRDF by a probe chain of SSS_PROBE_HITS closest hits and continues the
path from there; a scene with subsurface materials draws 7 + 8 dims a
bounce.  A ray that escapes collects the infinite light's radiance,
MIS-weighted against its light sampling.  Textured parameters read their
textures through T1 (``ops/bsdf.make_bsdf_at``), the image maps filtered
by the camera rays' differentials at bounce 0 (``ops/differentials.py``;
later bounces read level 0), and bump maps perturb the shading frame
(``bsdf.apply_bump``); only this integrator bumps, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ...ops import bsdf as bx
from ...ops import bssrdf as bss
from ...ops import differentials as rd
from ...ops import path_kernel as pk
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...ops import sobol_kernel as sk
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import lights as lt
from .. import samplers as smpl

# per-bounce sampler dimensions after the camera's 0-4:
#   +0 light select, +1,2 light u, +3,4 bsdf u, +5 bsdf lobe choice, +6 rr
# scenes with subsurface materials append 8 more a bounce (sss_transport):
#   +7 probe axis/channel/pick, +8,9 probe r/phi, +10 sss light select,
#   +11,12 sss light u, +13,14 sss continuation direction
DIMS_PER_BOUNCE = pk.DIMS_PER_BOUNCE
SSS_EXTRA_DIMS = 8
# the offsets of a bounce's dims that the JAX package reads as 2D draws
# (u2d, path.py:118-248, 348-428): light u, bsdf u; and subsurface's probe
# r/phi, light u and continuation, from the start of its 8 dims
PAIRS = (1, 3)
SSS_PAIRS = (1, 4, 6)
DIM_CAMERA = 5
# the probe chain's length: the reference walks an unbounded chain of hits
# (bssrdf.rs:213-246); 4 covers a closed object's entry and exit and two
# sheets inside it.  Every probe is cast, a finished one with t_max 0.
SSS_PROBE_HITS = 4


def dims_per_bounce(scene: sa.Scene) -> int:
    """The path integrator's dims a bounce: 7, or 15 with subsurface."""
    return DIMS_PER_BOUNCE + (SSS_EXTRA_DIMS if scene.has_subsurface else 0)


def bounce_pairs(scene: sa.Scene) -> tuple:
    """The offsets of a bounce's 2D draws."""
    return PAIRS + (tuple(DIMS_PER_BOUNCE + k for k in SSS_PAIRS) if scene.has_subsurface
                    else ())


def _shading_frame(ns):
    """An arbitrary BSDF frame about ns (vm.coordinate_system): BDPT's
    connection vertices, which keep no u-tangent (the JAX path.py:54-55)."""
    return vm.coordinate_system(ns)


def _shading_frame_du(ns, dpdu):
    """BSDF frame with its x axis along the surface u-tangent
    (reflection.rs Bsdf::new: ss = normalize(dpdu)), orthogonalized against
    ns; an arbitrary frame where dpdu is degenerate.  Returns (ss, ts)."""
    ss = dpdu - ns * vm.dot(ns, dpdu)[..., None]
    degen = (vm.length_squared(ss) < 1e-14)[..., None]
    ss_fb, _ = vm.coordinate_system(ns)
    ss = torch.where(degen, ss_fb, vm.normalize(torch.where(degen, ss_fb, ss)))
    return ss, vm.cross(ns, ss)


def _to_local(v, ss, ts, ns):
    return torch.stack([vm.dot(v, ss), vm.dot(v, ts), vm.dot(v, ns)], -1)


def _to_world(v, ss, ts, ns):
    return v[..., 0:1] * ss + v[..., 1:2] * ts + v[..., 2:3] * ns


def _light_select_dist(scene: sa.Scene) -> smp.Distribution1D:
    """Light selection by power (integrator.rs:574)."""
    return smp.make_distribution_1d(scene.light_power)


class PathCfg(NamedTuple):
    max_depth: int  # reference default 5 (api.rs:248)
    rr_threshold: float  # Russian roulette after bounce 3 (path.rs:254)


def _dist_at(scene: sa.Scene, light_distrib=None):
    """dist_at(p): the light-selection distribution at points p (N, 3): the
    spatial lookup of light_distrib, one row a lane, or the power
    distribution shared by every lane."""
    if light_distrib is not None:
        from .. import lightdistrib as ldist

        return lambda p: ldist.lookup(light_distrib, p)
    light_dist = _light_select_dist(scene) if scene.n_lights > 0 else None
    return lambda p: light_dist


def sss_transport(scene: sa.Scene, accel, it, bs, ss, ts, beta, L, alive, o, d, specular_bounce,
                  prev_bsdf_pdf, light_dist, dims, k0: int, eligible=None):
    """BSSRDF transport after a transmissive bounce off a subsurface
    material (path.rs:191-249, bssrdf.rs; the JAX path.py:86-269, shared
    with volpath).  dims: this vertex's samples, whose k0.. are the 8 of
    the subsurface: the probe's axis, channel and pick (k0), its radius and
    angle (k0+1, k0+2), the exit point's light selection and light sample
    (k0+3..k0+5) and the continuation (k0+6, k0+7).  light_dist: the power
    distribution, which the exit point's NEE uses in every scene.
    eligible: lanes that may scatter below the surface (volpath: the lanes
    that did not scatter in a medium).  Returns (L, beta, o, d, alive,
    specular_bounce, prev_bsdf_pdf)."""
    u1s, u2s = dims[:, k0], dims[:, k0 + 1:k0 + 3]
    bss_id = torch.round(scene.mat_attr[it.mat.long(), sa.MA_PARAMS + sa.MP_BSSRDF]).long()
    do_sss = alive & (bss_id >= 0) & bs.is_transmission
    if eligible is not None:
        do_sss = do_sss & eligible
    bid = torch.clamp(bss_id, min=0)
    K = scene.bss_profile.shape[-1]
    prof_rows = scene.bss_profile.reshape(-1, K)
    cdf_rows = scene.bss_cdf.reshape(-1, K)
    rho_eff, sigma_t, eta_b = scene.bss_rho_eff[bid], scene.bss_sigma_t[bid], scene.bss_eta[bid]

    # the probe's axis, channel and chain pick (bssrdf.rs:150-179)
    ax_tan = u1s < 0.5
    ax_bi = (u1s >= 0.5) & (u1s < 0.75)
    u1r = torch.where(ax_tan, u1s * 2.0, torch.where(ax_bi, (u1s - 0.5) * 4.0, (u1s - 0.75) * 4.0))
    nsv = it.ns
    pick3 = lambda a, b_, c: torch.where(ax_tan[:, None], a, torch.where(ax_bi[:, None], b_, c))
    vx, vy, vz = pick3(ss, ts, nsv), pick3(ts, nsv, ss), pick3(nsv, ss, ts)
    ch = torch.clamp((u1r * 3.0).long(), 0, 2)
    u1r = u1r * 3.0 - ch.to(torch.float32)
    row = bid * 3 + ch
    sig_ch = torch.gather(sigma_t, 1, ch[:, None])[:, 0]
    r_s = bss.sample_sr_channel(prof_rows, cdf_rows, row, sig_ch, u2s[:, 0])
    r_max = bss.sample_sr_channel(prof_rows, cdf_rows, row, sig_ch, torch.full_like(u1r, 0.999))
    probe_ok = (r_s >= 0.0) & (r_s < r_max)
    half_l = torch.sqrt(torch.clamp(r_max * r_max - r_s * r_s, min=0.0))
    phi_s = 2.0 * math.pi * u2s[:, 1]
    base = (it.p + r_s[:, None] * (vx * torch.cos(phi_s)[:, None] + vy * torch.sin(phi_s)[:, None])
            - vz * half_l[:, None])

    # the probe chain (bssrdf.rs:209-246): a fixed-length walk along vz that
    # keeps the hits on the same material; lanes without a probe cast
    # nothing (t_max -1)
    cur_o, remaining = base, 2.0 * half_l
    probing = do_sss & probe_ok
    cand = []  # per probe: (kept, p, ns, ng, p_error)
    for _ in range(SSS_PROBE_HITS):
        pit = si.scene_intersect(scene, cur_o, vz,
                                 torch.where(probing, torch.clamp(remaining, min=0.0), -1.0), accel)
        good = pit.valid & (remaining > 1e-6) & probing
        cand.append((good & (pit.mat == it.mat), pit.p, pit.ns, pit.ng, pit.p_error))
        adv = torch.where(good, pit.t + 1e-4, remaining)
        cur_o = cur_o + vz * adv[:, None]
        remaining = remaining - adv
    cvalid = torch.stack([c[0] for c in cand], 1)
    n_found = cvalid.sum(1)
    sel = torch.minimum(torch.clamp((u1r * n_found.to(torch.float32)).long(), min=0),
                        torch.clamp(n_found - 1, min=0))
    pick_mask = cvalid & (torch.cumsum(cvalid.long(), 1) - 1 == sel[:, None])
    pickf = lambda j: sum(torch.where(pick_mask[:, k:k + 1], cand[k][j], 0.0)
                          for k in range(SSS_PROBE_HITS))
    pi_p, pi_ns, pi_ng, pi_perr = pickf(1), pickf(2), pickf(3), pickf(4)
    found = probing & (n_found > 0)

    # Sp and its pdf (bssrdf.rs:102-138, 295-340)
    r_hit = vm.length(pi_p - it.p)
    sp = bss.sr_eval(scene.bss_profile, bid, sigma_t, r_hit)
    dvec = it.p - pi_p
    d_local = _to_local(dvec, ss, ts, nsv)
    n_local = _to_local(pi_ns, ss, ts, nsv)
    r_proj = torch.stack([torch.sqrt(d_local[:, 1] ** 2 + d_local[:, 2] ** 2),
                          torch.sqrt(d_local[:, 2] ** 2 + d_local[:, 0] ** 2),
                          torch.sqrt(d_local[:, 0] ** 2 + d_local[:, 1] ** 2)], -1)
    pdf_sp = torch.zeros_like(r_hit)
    for axis, axis_prob in enumerate((0.25, 0.25, 0.5)):
        for c in range(3):
            pdf_sp = pdf_sp + (bss.pdf_sr_channel(prof_rows, bid * 3 + c, rho_eff[:, c],
                                                  sigma_t[:, c], r_proj[:, axis])
                               * n_local[:, axis].abs() * (1.0 / 3.0) * axis_prob)
    pdf_sp = pdf_sp / torch.clamp(n_found.to(torch.float32), min=1.0)
    ok_sss = found & (pdf_sp > 0.0) & (sp > 0.0).any(-1)
    beta_sss = beta * sp / torch.clamp(pdf_sp, min=1e-12)[:, None]

    # the exit point's adapter BxDF (SeparableBssrdfAdapter,
    # bssrdf.rs:489-514): f = Sw(wi) eta^2, cosine-sampled
    ss_pi, ts_pi = vm.coordinate_system(pi_ns)
    if scene.n_lights > 0:
        li2, selp2, _ = smp.sample_distribution_1d_discrete(light_dist, dims[:, k0 + 3])
        ls2 = lt.sample_li(scene, li2, pi_p, dims[:, k0 + 4:k0 + 6])
        wi2_l = _to_local(ls2.wi, ss_pi, ts_pi, pi_ns)
        f2 = bss.sw_factor(eta_b, wi2_l[:, 2]) * (eta_b * eta_b)
        cos2 = wi2_l[:, 2].abs()
        pdf_cos2 = cos2 * (1.0 / math.pi)
        p_sh2 = vm.offset_ray_origin(pi_p, pi_perr, pi_ng, ls2.wi)
        dsh2 = ls2.p_target - p_sh2
        dist2 = vm.length(dsh2)
        cast2 = ok_sss & (ls2.pdf > 0.0) & (wi2_l[:, 2] > 0.0)
        occ2 = si.scene_intersect_p(scene, p_sh2, dsh2 / torch.clamp(dist2, min=1e-12)[:, None],
                                    torch.where(cast2, dist2 * (1.0 - 1e-3), -1.0), accel)
        w_l2 = torch.where(ls2.is_delta, 1.0, smp.power_heuristic(ls2.pdf, pdf_cos2))
        contrib2 = (beta_sss * (f2 * cos2)[:, None] * ls2.li
                    * ((w_l2 / torch.clamp(selp2, min=1e-12))
                       / torch.clamp(ls2.pdf, min=1e-12))[:, None])
        L = L + torch.where((cast2 & ~occ2)[:, None], contrib2, 0.0)

    # the continuation: cosine-distributed about the exit normal; f |cos| /
    # pdf = f pi
    wi_c_l = smp.cosine_sample_hemisphere(dims[:, k0 + 6:k0 + 8])
    wi_c = _to_world(wi_c_l, ss_pi, ts_pi, pi_ns)
    pdf_c = torch.clamp(wi_c_l[:, 2], min=0.0) * (1.0 / math.pi)
    f_c = bss.sw_factor(eta_b, wi_c_l[:, 2]) * (eta_b * eta_b)
    beta_sss = beta_sss * (f_c * math.pi)[:, None]
    ok_sss = ok_sss & (pdf_c > 0.0)

    # subsurface lanes take the exit point's ray; a failed one dies
    beta = torch.where(ok_sss[:, None], beta_sss, beta)
    o = torch.where(ok_sss[:, None], vm.offset_ray_origin(pi_p, pi_perr, pi_ng, wi_c), o)
    d = torch.where(ok_sss[:, None], wi_c, d)
    specular_bounce = torch.where(do_sss, False, specular_bounce)
    prev_bsdf_pdf = torch.where(do_sss, pdf_c, prev_bsdf_pdf)
    alive = alive & (~do_sss | ok_sss)
    return L, beta, o, d, alive, specular_bounce, prev_bsdf_pdf


def _add_emitted(scene, dist_at, it, o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf):
    """Emitted radiance at a hit, and the infinite light's along rays d that
    escape, each MIS-weighted against light sampling from the previous
    vertex o (path.rs:97-116)."""
    if scene.n_lights > 0:
        hit_light = torch.where(it.valid & alive, it.light, -1)
        light = torch.clamp(hit_light, min=0)
        le = lt.area_light_emitted(scene, light, it.ns, it.wo)
        le = torch.where((hit_light >= 0)[:, None], le, 0.0)
        light_pdf = (smp.distribution_1d_discrete_pdf(dist_at(o), light)
                     * lt.pdf_li_area(scene, light, o, it.p, it.ns))
        w_bsdf = torch.where(specular_bounce, 1.0, smp.power_heuristic(prev_bsdf_pdf, light_pdf))
        L = L + beta * le * w_bsdf[:, None]
    if scene.has_env:
        escaped = alive & ~it.valid
        env = torch.full_like(it.light, scene.env_light)
        env_pdf = (smp.distribution_1d_discrete_pdf(dist_at(o), env)
                   * lt.pdf_li_env(scene, d))
        w_env = torch.where(specular_bounce, 1.0, smp.power_heuristic(prev_bsdf_pdf, env_pdf))
        L = L + torch.where(escaped[:, None], beta * lt.env_le(scene, d) * w_env[:, None], 0.0)
    return L


def _shade_and_extend(scene, cfg: PathCfg, accel, dist_at, dims, bounce, it, state,
                      light_dist=None, width=None, time=None):
    """One vertex's shading: the BSDF, NEE with MIS, the BSDF-sampled
    extension, the BSSRDF's transport where the scene has subsurface
    materials (light_dist: the power distribution it selects lights by)
    and Russian roulette (path.rs:117-262).  dims: (N, dims_per_bounce)
    this vertex's samples.  bounce: the fixed-depth loop's int, or (N,) int, each
    lane's own bounce in the regeneration loop.  eta_scale tracks the
    radiance scaling of refraction, which Russian roulette divides out
    (path.rs:174-187).  width: the hits' texture footprints (the camera
    rays' differentials' at bounce 0), or None.  A bump map perturbs the
    shading frame after the BSDF is made (path.py:339-342 of the JAX
    package), and the rest of the vertex shades with its normal.  time: the
    lanes' ray times, at which the shadow rays see moving meshes (None:
    0); the subsurface probes see them at 0, as in the JAX package."""
    o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf, eta_scale = state
    b = bx.make_bsdf_at(scene, it, width)
    ss, ts = _shading_frame_du(it.ns, it.dpdu)
    ns_b, ss, ts = bx.apply_bump(scene, it, ss, ts)
    it = it._replace(ns=ns_b)
    wo_l = _to_local(it.wo, ss, ts, it.ns)

    if scene.n_lights > 0:
        li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(dist_at(it.p), dims[:, 0])
        ls = lt.sample_li(scene, li_idx, it.p, dims[:, 1:3])
        wi_l = _to_local(ls.wi, ss, ts, it.ns)
        reflect = vm.dot(ls.wi, it.ng) * vm.dot(it.wo, it.ng) > 0.0
        fou = bx.fourier_terms(b, wo_l, wi_l)  # one F1 for f and pdf
        f = bx.bsdf_f(b, wo_l, wi_l, reflect, fou) * bx.abs_cos_theta(wi_l)[:, None]
        scat_pdf = bx.bsdf_pdf(b, wo_l, wi_l, fou)
        contrib_ok = (alive & bx.has_nonspecular(b) & (ls.pdf > 0.0) & (ls.li > 0.0).any(-1)
                      & (f > 0.0).any(-1))
        p_shadow = vm.offset_ray_origin(it.p, it.p_error, it.ng, ls.wi)
        delta_sh = ls.p_target - p_shadow
        dist = vm.length(delta_sh)
        sh_d = delta_sh / torch.clamp(dist, min=1e-12)[:, None]
        # lanes without a contribution cast nothing: t_max = -1
        sh_t = torch.where(contrib_ok, dist * (1.0 - 1e-3), -1.0)
        occluded = si.scene_intersect_p(scene, p_shadow, sh_d, sh_t, accel, time)
        w_light = torch.where(ls.is_delta, 1.0, smp.power_heuristic(ls.pdf, scat_pdf))
        inv_pdf = (w_light / torch.clamp(sel_pdf, min=1e-12)) / torch.clamp(ls.pdf, min=1e-12)
        ld = beta * f * ls.li * inv_pdf[:, None]
        L = L + torch.where((contrib_ok & ~occluded)[:, None], ld, 0.0)

    bs = bx.bsdf_sample(b, wo_l, dims[:, 3:5], dims[:, 5])
    wi_w = _to_world(bs.wi, ss, ts, it.ns)
    cos_wi = vm.absdot(wi_w, it.ns)
    ok = (bs.pdf > 0.0) & (bs.f > 0.0).any(-1)
    beta_next = beta * bs.f * (cos_wi / torch.clamp(bs.pdf, min=1e-12))[:, None]
    beta = torch.where((alive & ok)[:, None], beta_next, beta)
    alive = alive & ok
    specular_bounce = torch.where(alive, bs.is_specular, specular_bounce)
    prev_bsdf_pdf = torch.where(alive, torch.where(bs.is_specular, 1.0, bs.pdf), prev_bsdf_pdf)
    etas = torch.where(bs.is_transmission, b.eta * b.eta, torch.ones_like(b.eta))
    eta_scale = eta_scale * torch.where(bs.is_transmission & (bx.cos_theta(wo_l) > 0),
                                        1.0 / torch.clamp(etas, min=1e-6), etas)
    o = torch.where(alive[:, None], vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_w), o)
    d = torch.where(alive[:, None], wi_w, d)
    if scene.has_subsurface:
        L, beta, o, d, alive, specular_bounce, prev_bsdf_pdf = sss_transport(
            scene, accel, it, bs, ss, ts, beta, L, alive, o, d, specular_bounce, prev_bsdf_pdf,
            light_dist, dims, DIMS_PER_BOUNCE)

    # Russian roulette after bounce 3 (path.rs:253-262); the fixed-depth
    # loop skips it before then
    if not isinstance(bounce, int) or bounce > 2:
        rr_beta_max = (beta * eta_scale[:, None]).max(-1).values
        q = torch.clamp(1.0 - rr_beta_max, min=0.05)
        consider = (bounce > 2) & (rr_beta_max < cfg.rr_threshold) & alive
        kill = consider & (dims[:, 6] < q)
        beta = torch.where((consider & ~kill)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
        alive = alive & ~kill
    return o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf, eta_scale


def general_radiance(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg,
                     ctx: smpl.SampleCtx, ray_o: torch.Tensor, ray_d: torch.Tensor,
                     accel=None, light_distrib=None, diffs=None, time=None) -> torch.Tensor:
    """(N, 3) radiance along N camera rays through the general wavefront
    bounce, max_depth bounces and then a pass that only collects emission
    (path.py:474-592 with regen=False).  light_distrib: a spatial light
    distribution (lightdistrib.build_spatial), else selection by power.
    diffs: the camera rays' differentials (ops/differentials.py), or
    None.  time: the rays' times (N,) in the shutter, at which every cast
    of a path sees the moving meshes (None: 0)."""
    si.check_supported(scene, accel)
    n, dev = ray_o.shape[0], ray_o.device
    dist_at = _dist_at(scene, light_distrib)
    light_dist = _light_select_dist(scene) if scene.n_lights > 0 else None
    dpb, pairs = dims_per_bounce(scene), bounce_pairs(scene)
    # every bounce's dims in one K1 or H1 launch where it takes them all
    # (up to 128 dims, as the JAX package hoists them: depth 18, or 8 with
    # subsurface), else one a bounce; the JAX package's traced-dim route
    # where it takes it
    total_dims = dpb * cfg.max_depth
    dyn = smpl.traced_route(sampler_cfg, total_dims)
    all_dims = (smpl.get_dims(sampler_cfg, ctx, DIM_CAMERA, total_dims,
                              smpl.repeat_pairs(pairs, dpb, cfg.max_depth), dyn)
                if 0 < total_dims <= sk.MAX_DIMS else None)
    o, d = ray_o.contiguous(), ray_d.contiguous()
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.ones(n, device=dev)
    eta_scale = torch.ones(n, device=dev)
    inf = float(vm.INFINITY)
    for bounce in range(cfg.max_depth):
        # dead lanes cast with t_max = -1, which the traversal ends at once
        it = si.scene_intersect(scene, o, d, torch.where(alive, inf, -1.0), accel, time)
        L = _add_emitted(scene, dist_at, it, o, d, L, beta, alive, specular_bounce,
                         prev_bsdf_pdf)
        alive = alive & it.valid
        k0 = bounce * dpb
        dims = (all_dims[:, k0:k0 + dpb] if all_dims is not None else
                smpl.get_dims(sampler_cfg, ctx, DIM_CAMERA + k0, dpb, pairs, dyn))
        width = rd.bounce_width(scene, it, diffs, bounce)
        o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf, eta_scale = _shade_and_extend(
            scene, cfg, accel, dist_at, dims, bounce, it,
            (o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf, eta_scale), light_dist, width,
            time)
    # the last vertex only collects emission
    it = si.scene_intersect(scene, o, d, torch.where(alive, inf, -1.0), accel, time)
    return _add_emitted(scene, dist_at, it, o, d, L, beta, alive, specular_bounce,
                        prev_bsdf_pdf)


def radiance(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg,
             ctx: smpl.SampleCtx, ray_o: torch.Tensor, ray_d: torch.Tensor,
             mega: Optional[pk.MegaCfg] = None, accel=None, light_distrib=None,
             regen: bool = False, stats: Optional[dict] = None, diffs=None,
             time=None) -> torch.Tensor:
    """(N, 3) radiance along N camera rays.  mega: the scene's MegaCfg when
    the caller has it already; as in the JAX package, a scene passed with an
    accel or a spatial light distribution never takes the bounce kernel.
    K2 where the scene qualifies; else, with regen, the regeneration loop
    where ``regen.eligible`` takes the call (stats goes to
    ``regen.radiance_regen``); else the general bounce.  diffs: the camera
    rays' differentials, where the scene needs them (regeneration is not
    eligible then).  time: the rays' times in the shutter (None: 0); K2
    takes no scene that reads them (mega_cfg refuses moving meshes)."""
    if mega is None and accel is None:
        mega = pk.mega_cfg(scene, light_distrib)
    if mega is not None and cfg.max_depth > 0 and sampler_cfg.kind == smpl.SOBOL:
        return pk.mega_radiance(scene, mega, cfg.max_depth, cfg.rr_threshold, ctx.global_index,
                                smpl.index_bits(sampler_cfg), DIM_CAMERA, ray_o, ray_d)
    if regen:
        from . import regen as regen_mod

        if regen_mod.eligible(scene, cfg, sampler_cfg, accel, ray_o.shape[0]):
            return regen_mod.radiance_regen(scene, cfg, sampler_cfg, ctx, ray_o, ray_d, accel,
                                            light_distrib, stats=stats, time=time)
    return general_radiance(scene, cfg, sampler_cfg, ctx, ray_o, ray_d, accel, light_distrib,
                            diffs, time)
