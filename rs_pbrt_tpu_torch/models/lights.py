"""Light sampling and emission, photon emission, and the light power for
light selection.

The port of the JAX package's ``models/lights.py`` for every light it
has: point, spot, projection, goniometric, distant and infinite lights and
diffuse area lights on triangle ranges, spheres, cylinders and disks
(reference src/core/light.rs, lights/point.rs, spot.rs, projection.rs,
goniometric.rs, distant.rs, infinite.rs, diffuse.rs, shapes/triangle.rs,
sphere.rs, cylinder.rs and disk.rs sample).  The infinite light is an
equirect map, importance-sampled by its luminance x sin theta
(``ops/sampling.sample_distribution_2d``) and read bilinearly
(``_env_lookup``).  The projection and goniometric lights read their
image in the texture atlas (``_angular_map_factors``, through the plain
``ops/texture.atlas_lookup``).  Table reads are plain indexing where the
TPU used one-hot matmuls.  ``compute_light_power`` is host-side numpy that
runs once when a scene is finalized; as in the JAX package it gives the
projection and goniometric lights no power of their own (1e-9), so
selection by power rarely picks them.  ``sample_le`` emits photons
(light.rs sample_le) for SPPM.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import sampling as smp
from ..ops import texture as tx
from ..ops.autodiff import rows
from ..scene import arrays as sa
from ..utils import transform as tr
from ..utils import vecmath as vm


class LiSample(NamedTuple):
    wi: torch.Tensor  # (N,3) toward the light
    li: torch.Tensor  # (N,3) incident radiance
    pdf: torch.Tensor  # (N,) solid-angle pdf
    p_target: torch.Tensor  # (N,3) the shadow ray's target point
    n_light: torch.Tensor  # (N,3) normal at the light sample
    is_delta: torch.Tensor  # (N,) bool: a point, spot, projection, goniometric or distant light


# the solid-angle pdf of an equirect map's direction is its pdf over the
# unit square divided by 2 pi^2 sin theta (infinite.rs pdf_li)
_EQUIRECT_JACOBIAN = 2.0 * math.pi * math.pi


class LeSample(NamedTuple):
    """An emitted ray (light.rs sample_le :118-156)."""

    o: torch.Tensor  # (N,3) origin on or near the light
    d: torch.Tensor  # (N,3) direction
    n_light: torch.Tensor  # (N,3)
    le: torch.Tensor  # (N,3)
    pdf_pos: torch.Tensor  # (N,)
    pdf_dir: torch.Tensor  # (N,)


def _area_sample_tri(scene: sa.Scene, la, light_idx, u2):
    """Uniform-by-area point on a triangle-range area light: the light's
    area CDF picks the triangle and recycles u2[:, 0], then uniform
    barycentrics.  Returns (p, n)."""
    cdf = scene.alight_tri_cdf[light_idx.long()]  # (N, A+1)
    o, c0, c1 = smp.bracket_cdf(cdf, u2[:, 0])
    u_remap = torch.clamp((u2[:, 0] - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0 - 1e-7)
    tri = torch.round(la[:, sa.LA_TRI_START]).to(torch.int64) + o
    at = rows(scene.tri_attr, torch.clamp(tri, 0, scene.n_tris - 1))
    b = smp.uniform_sample_triangle(torch.stack([u_remap, u2[:, 1]], -1))
    b0, b1 = b[:, 0:1], b[:, 1:2]
    b2 = 1.0 - b0 - b1
    p0, p1, p2 = (at[:, c:c + 3] for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2))
    p = b0 * p0 + b1 * p1 + b2 * p2
    ng = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    # oriented by the shading normals where the mesh has them (triangle.rs)
    ns = (b0 * at[:, sa.TA_N0:sa.TA_N0 + 3] + b1 * at[:, sa.TA_N1:sa.TA_N1 + 3]
          + b2 * at[:, sa.TA_N2:sa.TA_N2 + 3])
    ng = torch.where((at[:, sa.TA_HAS_N] > 0.5)[:, None], vm.face_forward(ng, ns), ng)
    ng = torch.where((at[:, sa.TA_REVERSE] > 0.5)[:, None], -ng, ng)
    return p, ng


def _sphere_light_geom(scene: sa.Scene, la):
    """World-space (center, radius, reverse) of each lane's sphere light;
    the world radius folds in the o2w scale (norm of its first column)."""
    sidx = torch.clamp(torch.round(la[:, sa.LA_SHAPE_IDX]).long(), 0, scene.sph_attr.shape[0] - 1)
    sat = scene.sph_attr[sidx]
    o2w = sat[:, sa.SP_O2W:sa.SP_O2W + 16]
    center = o2w[:, [3, 7, 11]]
    scale = torch.sqrt(o2w[:, 0] ** 2 + o2w[:, 4] ** 2 + o2w[:, 8] ** 2)
    return center, sat[:, sa.SP_PARAMS] * scale, sat[:, sa.SP_REVERSE] > 0.5


def _area_sample_sphere(scene: sa.Scene, la, ref_p, u2):
    """Solid-angle sphere sampling (sphere.rs:391-480): a uniform cone
    toward the sphere from outside, uniform by area from inside.  Returns
    (p, n, pdf) with the pdf already per solid angle."""
    center, radius, reverse = _sphere_light_geom(scene, la)
    r2 = radius * radius
    wc_vec = center - ref_p
    dc2 = torch.clamp(vm.length_squared(wc_vec), min=1e-20)
    inside = dc2 <= r2

    # outside: cone sampling (sphere.rs:432-480)
    dc = torch.sqrt(dc2)
    wc = wc_vec / dc[:, None]
    wcx, wcy = vm.coordinate_system(wc)
    sin2_t_max = torch.clamp(r2 / dc2, 0.0, 1.0)
    cos_t_max = torch.sqrt(torch.clamp(1.0 - sin2_t_max, min=0.0))
    cos_t = (1.0 - u2[:, 0]) + u2[:, 0] * cos_t_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2[:, 1] * 2.0 * np.pi
    ds = dc * cos_t - torch.sqrt(torch.clamp(r2 - dc2 * sin_t * sin_t, min=0.0))
    cos_a = (dc2 + r2 - ds * ds) / torch.clamp(2.0 * dc * radius, min=1e-12)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    # the normal in the frame (-wcx, -wcy, -wc) (sphere.rs SphericalDirection)
    n_cone = ((sin_a * torch.cos(phi))[:, None] * -wcx + (sin_a * torch.sin(phi))[:, None] * -wcy
              + cos_a[:, None] * -wc)
    p_cone = center + radius[:, None] * n_cone
    pdf_cone = smp.uniform_cone_pdf(cos_t_max)

    # inside: uniform by area, the pdf converted to solid angle
    n_in = smp.uniform_sample_sphere(u2)
    p_in = center + radius[:, None] * n_in
    to_in = p_in - ref_p
    d2_in = torch.clamp(vm.length_squared(to_in), min=1e-12)
    wi_in = to_in / torch.sqrt(d2_in)[:, None]
    cos_in = vm.dot(n_in, -wi_in).abs()
    area_w = 4.0 * np.pi * torch.clamp(r2, min=1e-20)
    pdf_in = torch.where(cos_in < 1e-7, 0.0, d2_in / torch.clamp(cos_in * area_w, min=1e-20))

    p = torch.where(inside[:, None], p_in, p_cone)
    nrm = torch.where(inside[:, None], n_in, n_cone)
    nrm = torch.where(reverse[:, None], -nrm, nrm)
    return p, nrm, torch.where(inside, pdf_in, pdf_cone)


def _quadric_light_sample(scene: sa.Scene, la, u2):
    """Uniform-by-area point on a disk or cylinder area light (disk.rs and
    cylinder.rs sample; as in the reference, a disk's sample covers the
    whole disk even for an annulus or a partial phi, while its pdf takes
    the true area).  Returns (p, n, is_quadric)."""
    sidx = torch.clamp(torch.round(la[:, sa.LA_SHAPE_IDX]).long(), 0, scene.sph_attr.shape[0] - 1)
    sat = scene.sph_attr[sidx]
    o2w = sat[:, sa.SP_O2W:sa.SP_O2W + 16].reshape(-1, 4, 4)
    w2o = sat[:, sa.SP_W2O:sa.SP_W2O + 16].reshape(-1, 4, 4)
    prm = sat[:, sa.SP_PARAMS:sa.SP_PARAMS + 4]
    geom = torch.round(la[:, sa.LA_GEOM])
    is_cyl, is_dsk = geom == sa.ALG_CYLINDER, geom == sa.ALG_DISK
    radius = prm[:, 0]
    # a disk (radius, inner, height, phi_max): the concentric disk
    cd = smp.concentric_sample_disk(u2)
    p_dsk = torch.stack([cd[:, 0] * radius, cd[:, 1] * radius, prm[:, 2]], -1)
    n_dsk = torch.zeros_like(p_dsk)
    n_dsk[:, 2] = 1.0
    # a cylinder (radius, z_min, z_max, phi_max)
    z = vm.lerp(u2[:, 0], prm[:, 1], prm[:, 2])
    phi = u2[:, 1] * prm[:, 3]
    p_cyl = torch.stack([radius * torch.cos(phi), radius * torch.sin(phi), z], -1)
    n_cyl = torch.stack([torch.cos(phi), torch.sin(phi), torch.zeros_like(phi)], -1)
    p = tr.xform_point(o2w, torch.where(is_cyl[:, None], p_cyl, p_dsk))
    nrm = vm.normalize(tr.xform_normal(w2o, torch.where(is_cyl[:, None], n_cyl, n_dsk)))
    flip = (sat[:, sa.SP_REVERSE] > 0.5) ^ tr.swaps_handedness(o2w)
    return p, torch.where(flip[:, None], -nrm, nrm), is_cyl | is_dsk


def _env_lookup(scene: sa.Scene, uv):
    """The equirect map at uv (N, 2), bilinear, the azimuth wrapping and
    the polar angle clamped (infinite.rs:339 reads level 0 of its MIP map,
    which a bilinear lookup matches)."""
    img = scene.inf_radiance
    h, w = img.shape[:2]
    fx = uv[:, 0] * w - 0.5
    fy = uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    xw0, xw1 = torch.remainder(x0i, w), torch.remainder(x0i + 1, w)
    yc0, yc1 = torch.clamp(y0i, 0, h - 1), torch.clamp(y0i + 1, 0, h - 1)
    top = img[yc0, xw0] * (1.0 - tx) + img[yc0, xw1] * tx
    bot = img[yc1, xw0] * (1.0 - tx) + img[yc1, xw1] * tx
    return top * (1.0 - ty) + bot * ty


def _env_uv(scene: sa.Scene, w):
    """(uv (N, 2) of world directions w in the map, sin theta)."""
    dl = vm.normalize(tr.xform_vector(scene.inf_w2l, w))
    theta = vm.spherical_theta(dl)
    uv = torch.stack([vm.spherical_phi(dl) * float(vm.INV_2_PI), theta * float(vm.INV_PI)], -1)
    return uv, torch.sin(theta)


def _env_sample(scene: sa.Scene, u2):
    """A map direction by importance (infinite.rs sample_li): (world
    direction toward the map, its solid-angle pdf, the map's radiance)."""
    uv, map_pdf = smp.sample_distribution_2d(scene.inf_dist, u2)
    theta = uv[:, 1] * math.pi
    st = torch.sin(theta)
    d_light = vm.spherical_direction(st, torch.cos(theta), uv[:, 0] * 2.0 * math.pi)
    wi = vm.normalize(tr.xform_vector(scene.inf_l2w, d_light))
    pdf = torch.where(st > 1e-9, map_pdf / (_EQUIRECT_JACOBIAN * torch.clamp(st, min=1e-9)), 0.0)
    return wi, pdf, _env_lookup(scene, uv)


def pdf_li_env(scene: sa.Scene, wi):
    """The solid-angle pdf with which sample_li on the infinite light picks
    direction wi (N, 3) (infinite.rs pdf_li); 0 without one."""
    if not scene.has_env:
        return torch.zeros(wi.shape[:-1], device=wi.device)
    uv, st = _env_uv(scene, wi)
    map_pdf = smp.distribution_2d_pdf(scene.inf_dist, uv)
    return torch.where(st > 1e-9, map_pdf / (_EQUIRECT_JACOBIAN * torch.clamp(st, min=1e-9)), 0.0)


def env_le(scene: sa.Scene, d):
    """The radiance of the infinite light along escaped rays d (N, 3)
    (infinite.rs le); 0 without one."""
    if not scene.has_env:
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)
    return _env_lookup(scene, _env_uv(scene, d)[0])


def _angular_map_factors(scene: sa.Scene, la, spot_dir, dl):
    """The projection and goniometric factors of directions dl (N, 3) from
    the light (projection.rs projection, goniometric.rs scale), in the
    frame about spot_dir: the image on the square window of half-angle
    tan LP_TAN_FOV, 0 outside it, and the equirect map at (phi / 2 pi,
    theta / pi).  Returns (proj (N, 3), gonio (N, 3)); sample_li and
    sample_le share them."""
    tex_id = torch.clamp(la[:, sa.LP_TEX].to(torch.int32), 0, scene.tex_rect.shape[0] - 1).long()
    rect = scene.tex_rect[tex_id]
    w_l = vm.normalize(spot_dir)
    s1, s2 = vm.coordinate_system(w_l)
    x_l, y_l, z_l = vm.dot(dl, s1), vm.dot(dl, s2), vm.dot(dl, w_l)
    tan_fov = torch.clamp(la[:, sa.LP_TAN_FOV], min=1e-6)
    up = 0.5 * (x_l / torch.clamp(z_l, min=1e-6) / tan_fov + 1.0)
    vp = 0.5 * (y_l / torch.clamp(z_l, min=1e-6) / tan_fov + 1.0)
    inside = (z_l > 0) & (up >= 0) & (up < 1) & (vp >= 0) & (vp < 1)
    proj = torch.where(inside[:, None], tx.atlas_lookup(scene.tex_atlas, rect, up, vp), 0.0)
    theta_g = torch.arccos(torch.clamp(z_l, -1, 1))
    phi_g = torch.atan2(y_l, x_l)
    phi_g = torch.where(phi_g < 0, phi_g + 2 * float(vm.PI), phi_g)
    gonio = tx.atlas_lookup(scene.tex_atlas, rect, phi_g * float(vm.INV_2_PI),
                            theta_g * float(vm.INV_PI))
    return proj, gonio


def sample_li(scene: sa.Scene, light_idx, ref_p, u2) -> LiSample:
    """Light light_idx ((N,) int) as seen from ref_p (N,3), from u2 (N,2)
    (light.rs sample_li): a point on an area light; the position of a point
    or spot light, with its falloff; a point 2 world radii away along a
    distant light's direction, or along a direction of the infinite light's
    map drawn by its importance; a projection or goniometric light's
    position, its image's factor on the point light's radiance.  The delta
    lights' pdf is 1."""
    la = rows(scene.light_attr, light_idx)
    intensity = la[:, sa.LP_I:sa.LP_I + 3]
    ltype = torch.round(la[:, sa.LA_TYPE])
    if scene.n_tris > 0:
        p_area, n_area = _area_sample_tri(scene, la, light_idx, u2)
    else:
        p_area, n_area = ref_p, torch.zeros_like(ref_p)
    if scene.has_sphere_lights:
        p_sph, n_sph, pdf_sph = _area_sample_sphere(scene, la, ref_p, u2)
        is_sph = torch.round(la[:, sa.LA_GEOM]) == sa.ALG_SPHERE
        p_area = torch.where(is_sph[:, None], p_sph, p_area)
        n_area = torch.where(is_sph[:, None], n_sph, n_area)
    if scene.has_quadric_lights:
        p_qd, n_qd, is_qd = _quadric_light_sample(scene, la, u2)
        p_area = torch.where(is_qd[:, None], p_qd, p_area)
        n_area = torch.where(is_qd[:, None], n_qd, n_area)
    to_a = p_area - ref_p
    d2a = torch.clamp(vm.length_squared(to_a), min=1e-12)
    wi = to_a / torch.sqrt(d2a)[:, None]
    cos_l = vm.dot(n_area, -wi)
    emits = (la[:, sa.LP_TWO_SIDED] > 0.5) | (cos_l > 0.0)
    li = torch.where(emits[:, None], intensity, 0.0)
    area = torch.clamp(la[:, sa.LP_AREA], min=1e-12)
    # solid-angle pdf dist^2 / (|cos| A) (shape.rs pdf_with_ref_point)
    pdf = d2a / torch.clamp(cos_l.abs() * area, min=1e-12)
    pdf = torch.where(cos_l.abs() < 1e-7, 0.0, pdf)
    if scene.has_sphere_lights:
        pdf = torch.where(is_sph, pdf_sph, pdf)
    is_area = ltype == sa.LIGHT_AREA
    if scene.light_type_mask == 1 << sa.LIGHT_AREA:
        return LiSample(wi, li, pdf, p_area, n_area, ~is_area)

    # point (lights/point.rs sample_li): I / d^2 from the light's position
    pos = la[:, sa.LP_P:sa.LP_P + 3]
    to_l = pos - ref_p
    d2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
    wi_point = to_l / torch.sqrt(d2)[:, None]
    li_point = intensity / d2[:, None]
    # spot (lights/spot.rs): the point's radiance times the falloff; the
    # spot's direction rides the world-center slot
    spot_dir = la[:, sa.LP_WORLD_CENTER:sa.LP_WORLD_CENTER + 3]
    cos_t = vm.dot(-wi_point, spot_dir)
    ct_total, ct_fall = la[:, sa.LP_COS_TOTAL], la[:, sa.LP_COS_FALLOFF]
    delta = torch.clamp((cos_t - ct_total) / torch.clamp(ct_fall - ct_total, min=1e-7), 0.0, 1.0)
    falloff = torch.where(cos_t < ct_total, 0.0,
                          torch.where(cos_t > ct_fall, 1.0, (delta * delta) * (delta * delta)))
    # distant (lights/distant.rs): the position slot holds the direction
    # toward the light
    wi_dist = vm.normalize(pos)
    p_far = ref_p + wi_dist * (2.0 * la[:, sa.LP_WORLD_RADIUS])[:, None]

    is_point, is_spot = ltype == sa.LIGHT_POINT, ltype == sa.LIGHT_SPOT
    is_dist = ltype == sa.LIGHT_DISTANT
    is_delta = is_point | is_spot
    angular = scene.light_type_mask & ((1 << sa.LIGHT_PROJECTION) | (1 << sa.LIGHT_GONIO))
    if angular:
        is_proj, is_gonio = ltype == sa.LIGHT_PROJECTION, ltype == sa.LIGHT_GONIO
        is_delta = is_delta | is_proj | is_gonio
    positional = is_delta[:, None]
    wi = torch.where(positional, wi_point, torch.where(is_dist[:, None], wi_dist, wi))
    li = torch.where(is_point[:, None], li_point,
                     torch.where(is_spot[:, None], li_point * falloff[:, None],
                                 torch.where(is_dist[:, None], intensity, li)))
    if angular:
        # the maps apply only where the atlas holds an image (lights.py:172-179)
        if scene.tex_atlas.shape[0] > 1:
            proj, gonio = _angular_map_factors(scene, la, spot_dir, -wi_point)
            li_proj, li_gonio = li_point * proj, li_point * gonio
        else:
            li_proj, li_gonio = li_point * 0.0, li_point
        li = torch.where(is_proj[:, None], li_proj, torch.where(is_gonio[:, None], li_gonio, li))
    pdf = torch.where(is_area, pdf, 1.0)
    p_target = torch.where(positional, pos, torch.where(is_dist[:, None], p_far, p_area))
    if scene.has_env:
        # infinite (infinite.rs sample_li): a map direction by importance, the
        # shadow ray's target 2 world radii along it
        is_inf = ltype == sa.LIGHT_INFINITE
        wi_inf, pdf_inf, li_inf = _env_sample(scene, u2)
        wi = torch.where(is_inf[:, None], wi_inf, wi)
        li = torch.where(is_inf[:, None], li_inf, li)
        pdf = torch.where(is_inf, pdf_inf, pdf)
        p_far_inf = ref_p + wi_inf * (2.0 * la[:, sa.LP_WORLD_RADIUS])[:, None]
        p_target = torch.where(is_inf[:, None], p_far_inf, p_target)
    n_light = torch.where(is_area[:, None], n_area, 0.0)
    return LiSample(wi, li, pdf, p_target, n_light, is_delta | is_dist)


def sample_le(scene: sa.Scene, light_idx, u_pos, u_dir) -> LeSample:
    """An emitted photon ray of light light_idx ((N,) int) from u_pos and
    u_dir (N, 2) (lights.py sample_le, lights/*.rs sample_le): a point
    light's uniform sphere, a spot's uniform cone with its falloff, a
    distant light's disk of the world radius, an area light's point by area
    (a triangle range's CDF, a sphere's uniform sphere, a disk's or
    cylinder's uniform point) and cosine hemisphere about its normal, the
    infinite light's map direction by importance from a disk of the world
    radius, a projection light's uniform cone over its window and a
    goniometric light's uniform sphere, each with its map's factor.  Both
    pdfs are floored at 1e-20."""
    la = rows(scene.light_attr, light_idx)
    n = light_idx.shape[0]
    pos = la[:, sa.LP_P:sa.LP_P + 3]
    intensity = la[:, sa.LP_I:sa.LP_I + 3]
    world_r = la[:, sa.LP_WORLD_RADIUS]
    world_c = la[:, sa.LP_WORLD_CENTER:sa.LP_WORLD_CENTER + 3]
    ltype = torch.round(la[:, sa.LA_TYPE])
    one = torch.ones(n, device=pos.device)
    # point: a uniform sphere direction
    d_pt = smp.uniform_sample_sphere(u_dir)
    # spot: a uniform cone about its direction (the world-center slot)
    ct_total = la[:, sa.LP_COS_TOTAL]
    cone = smp.uniform_sample_cone(u_dir, ct_total)
    spot_dir = vm.normalize(world_c)
    s1, s2 = vm.coordinate_system(spot_dir)
    d_spot = cone[:, 0:1] * s1 + cone[:, 1:2] * s2 + cone[:, 2:3] * spot_dir
    # distant: the origin on a disk of the world radius, the direction fixed
    w = vm.normalize(pos)
    v1, v2 = vm.coordinate_system(w)
    cd = smp.concentric_sample_disk(u_pos)
    o_dist = (world_c + world_r[:, None] * (cd[:, 0:1] * v1 + cd[:, 1:2] * v2)
              + world_r[:, None] * w)
    # area: a point by area and a cosine hemisphere direction about its normal
    if scene.n_tris > 0:
        p_area, n_area = _area_sample_tri(scene, la, light_idx, u_pos)
    else:
        p_area, n_area = pos, torch.zeros_like(pos)
    if scene.has_sphere_lights:
        center, radius, reverse = _sphere_light_geom(scene, la)
        dir_s = smp.uniform_sample_sphere(u_pos)
        is_sph = torch.round(la[:, sa.LA_GEOM]) == sa.ALG_SPHERE
        p_area = torch.where(is_sph[:, None], center + radius[:, None] * dir_s, p_area)
        n_area = torch.where(is_sph[:, None], torch.where(reverse[:, None], -dir_s, dir_s),
                             n_area)
    if scene.has_quadric_lights:
        p_qd, n_qd, is_qd = _quadric_light_sample(scene, la, u_pos)
        p_area = torch.where(is_qd[:, None], p_qd, p_area)
        n_area = torch.where(is_qd[:, None], n_qd, n_area)
    d_cos = smp.cosine_sample_hemisphere(u_dir)
    a1, a2 = vm.coordinate_system(n_area)
    d_area = d_cos[:, 0:1] * a1 + d_cos[:, 1:2] * a2 + d_cos[:, 2:3] * n_area

    is_pt, is_spot = ltype == sa.LIGHT_POINT, ltype == sa.LIGHT_SPOT
    is_dist, is_area = ltype == sa.LIGHT_DISTANT, ltype == sa.LIGHT_AREA
    o = torch.where(is_area[:, None], p_area, pos)
    o = torch.where(is_dist[:, None], o_dist, o)
    d = torch.where(is_spot[:, None], d_spot, d_pt)
    d = torch.where(is_dist[:, None], -w, d)
    d = torch.where(is_area[:, None], d_area, d)
    n_light = torch.where(is_area[:, None], n_area, d)
    # the spot's falloff (spot.rs sample_le: I falloff(w))
    cos_sp = vm.dot(d_spot, spot_dir)
    ct_fall = la[:, sa.LP_COS_FALLOFF]
    delta = torch.clamp((cos_sp - ct_total) / torch.clamp(ct_fall - ct_total, min=1e-7), 0.0, 1.0)
    fall = torch.where(cos_sp < ct_total, 0.0,
                       torch.where(cos_sp > ct_fall, 1.0, (delta * delta) ** 2))
    le = torch.where(is_spot[:, None], intensity * fall[:, None], intensity)
    pdf_pos = torch.where(is_area, 1.0 / torch.clamp(la[:, sa.LP_AREA], min=1e-12), one)
    pdf_pos = torch.where(is_dist, 1.0 / torch.clamp(float(np.pi) * world_r * world_r, min=1e-12),
                          pdf_pos)
    pdf_dir = torch.where(is_pt, smp.UNIFORM_SPHERE_PDF, one)
    pdf_dir = torch.where(is_spot, smp.uniform_cone_pdf(ct_total), pdf_dir)
    if scene.light_type_mask & ((1 << sa.LIGHT_PROJECTION) | (1 << sa.LIGHT_GONIO)):
        # projection: a uniform cone over the window, whose corner direction
        # (tan, tan, 1) sets its cosine (projection.rs:408-435); goniometric:
        # the point light's uniform sphere (goniometric.rs:290-312)
        is_proj, is_gonio = ltype == sa.LIGHT_PROJECTION, ltype == sa.LIGHT_GONIO
        tan_fov = torch.clamp(la[:, sa.LP_TAN_FOV], min=1e-6)
        ct_proj = 1.0 / torch.sqrt(1.0 + 2.0 * tan_fov * tan_fov)
        cone_p = smp.uniform_sample_cone(u_dir, ct_proj)
        d_proj = cone_p[:, 0:1] * s1 + cone_p[:, 1:2] * s2 + cone_p[:, 2:3] * spot_dir
        if scene.tex_atlas.shape[0] > 1:
            proj_f = _angular_map_factors(scene, la, world_c, d_proj)[0]
            gonio_f = _angular_map_factors(scene, la, world_c, d_pt)[1]
        else:
            proj_f = gonio_f = torch.ones_like(intensity)
        d = torch.where(is_proj[:, None], d_proj, d)
        n_light = torch.where(is_proj[:, None], d_proj, n_light)
        le = torch.where(is_proj[:, None], intensity * proj_f,
                         torch.where(is_gonio[:, None], intensity * gonio_f, le))
        pdf_dir = torch.where(is_gonio, smp.UNIFORM_SPHERE_PDF, pdf_dir)
        pdf_dir = torch.where(is_proj, smp.uniform_cone_pdf(ct_proj), pdf_dir)
    pdf_dir = torch.where(is_area, smp.cosine_hemisphere_pdf(d_cos[:, 2].abs()), pdf_dir)
    pdf_dir = torch.where(is_dist, one, pdf_dir)
    if scene.has_env:
        # infinite (infinite.rs sample_le): a map direction by importance,
        # emitted into the scene from a disk of the world radius behind it
        is_inf = ltype == sa.LIGHT_INFINITE
        w_env, pdf_dir_inf, le_inf = _env_sample(scene, u_dir)
        d_inf = -w_env
        v1e, v2e = vm.coordinate_system(-d_inf)
        cd_e = smp.concentric_sample_disk(u_pos)
        p_disk = world_c + world_r[:, None] * (cd_e[:, 0:1] * v1e + cd_e[:, 1:2] * v2e)
        o = torch.where(is_inf[:, None], p_disk - d_inf * world_r[:, None], o)
        d = torch.where(is_inf[:, None], d_inf, d)
        n_light = torch.where(is_inf[:, None], d_inf, n_light)
        le = torch.where(is_inf[:, None], le_inf, le)
        pdf_pos = torch.where(is_inf, 1.0 / torch.clamp(math.pi * world_r * world_r, min=1e-12),
                              pdf_pos)
        pdf_dir = torch.where(is_inf, pdf_dir_inf, pdf_dir)
    return LeSample(o, d, n_light, le, torch.clamp(pdf_pos, min=1e-20),
                    torch.clamp(pdf_dir, min=1e-20))


def pdf_li_area(scene: sa.Scene, light_idx, ref_p, p_hit, n_hit):
    """The solid-angle pdf with which sample_li on area light light_idx
    would have picked the direction from ref_p toward p_hit (with normal
    n_hit there), for BSDF-sampling MIS (shape.rs pdf_with_ref_point)."""
    la = rows(scene.light_attr, light_idx)
    d = p_hit - ref_p
    d2 = torch.clamp(vm.length_squared(d), min=1e-12)
    wi = d / torch.sqrt(d2)[:, None]
    cos_l = vm.dot(n_hit, wi).abs()
    area = torch.clamp(la[:, sa.LP_AREA], min=1e-12)
    pdf = d2 / torch.clamp(cos_l * area, min=1e-12)
    pdf = torch.where(cos_l < 1e-7, 0.0, pdf)
    if scene.has_sphere_lights:
        # sphere lights sample a uniform cone from outside (sphere.rs),
        # as _area_sample_sphere does
        center, radius, _ = _sphere_light_geom(scene, la)
        dc2 = torch.clamp(vm.length_squared(center - ref_p), min=1e-20)
        r2 = radius * radius
        cos_t_max = torch.sqrt(torch.clamp(1.0 - torch.clamp(r2 / dc2, 0.0, 1.0), min=0.0))
        is_sph = torch.round(la[:, sa.LA_GEOM]) == sa.ALG_SPHERE
        pdf = torch.where(is_sph & (dc2 > r2), smp.uniform_cone_pdf(cos_t_max), pdf)
    return pdf


def area_light_emitted(scene: sa.Scene, light_idx, n_hit, wo):
    """L() of a hit area light (lights/diffuse.rs l()): its radiance where
    wo leaves the emitting side, for light_idx >= 0."""
    lp = rows(scene.light_attr, light_idx)
    emits = (lp[:, sa.LP_TWO_SIDED] > 0.5) | (vm.dot(n_hit, wo) > 0.0)
    return torch.where((emits & (light_idx >= 0))[:, None], lp[:, sa.LP_I:sa.LP_I + 3], 0.0)


def compute_light_power(light_type, light_params, env_total: float = 0.0) -> np.ndarray:
    """(L,) approximate power of each light, floored at 1e-9."""
    lp = np.asarray(light_params, np.float32)
    light_type = np.asarray(light_type)
    lum = lp[:, sa.LP_I:sa.LP_I + 3].sum(-1)
    area = lp[:, sa.LP_AREA]
    wr = lp[:, sa.LP_WORLD_RADIUS]
    power = np.zeros(len(light_type), np.float32)
    power = np.where(light_type == sa.LIGHT_POINT, 4 * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_SPOT, 2 * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_DISTANT, np.pi * wr * wr * lum, power)
    two = 1.0 + (lp[:, sa.LP_TWO_SIDED] > 0.5)
    power = np.where(light_type == sa.LIGHT_AREA, two * area * np.pi * lum, power)
    power = np.where(light_type == sa.LIGHT_INFINITE, np.pi * wr * wr * env_total, power)
    return np.maximum(power, 1e-9).astype(np.float32)
