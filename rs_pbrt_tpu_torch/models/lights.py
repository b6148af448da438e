"""Light sampling and emission, and the light power for light selection.

The port of the JAX package's ``models/lights.py`` for diffuse area lights
on triangle ranges and on spheres (reference src/core/light.rs,
lights/diffuse.rs, shapes/triangle.rs and sphere.rs sample).  Table reads
are plain indexing where the TPU used one-hot matmuls.  Point, spot,
distant, projection, goniometric and infinite lights and area lights on
disks and cylinders are not ported yet: ``check_supported`` raises for
them.  ``compute_light_power`` is host-side numpy that runs once when a
scene is finalized.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import sampling as smp
from ..scene import arrays as sa
from ..utils import vecmath as vm


class LiSample(NamedTuple):
    wi: torch.Tensor  # (N,3) toward the light
    li: torch.Tensor  # (N,3) incident radiance
    pdf: torch.Tensor  # (N,) solid-angle pdf
    p_target: torch.Tensor  # (N,3) the shadow ray's target point
    n_light: torch.Tensor  # (N,3) normal at the light sample
    is_delta: torch.Tensor  # (N,) bool (no delta lights are ported: all False)


def check_supported(scene: sa.Scene):
    """Raises NotImplementedError for the lights the port cannot sample yet."""
    if scene.light_type_mask & ~(1 << sa.LIGHT_AREA):
        raise NotImplementedError("point, spot, distant, projection, goniometric and infinite "
                                  "lights are not ported yet (ROADMAP queue A)")
    if scene.has_quadric_lights:
        raise NotImplementedError("area lights on disks and cylinders are not ported yet "
                                  "(ROADMAP queue A)")


def _area_sample_tri(scene: sa.Scene, la, light_idx, u2):
    """Uniform-by-area point on a triangle-range area light: the light's
    area CDF picks the triangle and recycles u2[:, 0], then uniform
    barycentrics.  Returns (p, n)."""
    cdf = scene.alight_tri_cdf[light_idx.long()]  # (N, A+1)
    o, c0, c1 = smp.bracket_cdf(cdf, u2[:, 0])
    u_remap = torch.clamp((u2[:, 0] - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0 - 1e-7)
    tri = torch.round(la[:, sa.LA_TRI_START]).to(torch.int64) + o
    at = scene.tri_attr[torch.clamp(tri, 0, scene.n_tris - 1)]
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


def sample_li(scene: sa.Scene, light_idx, ref_p, u2) -> LiSample:
    """A point on light light_idx ((N,) int) as seen from ref_p (N,3), from
    u2 (N,2) (light.rs sample_li of a diffuse area light)."""
    check_supported(scene)
    la = scene.light_attr[light_idx.long()]
    intensity = la[:, sa.LP_I:sa.LP_I + 3]
    if scene.n_tris > 0:
        p_area, n_area = _area_sample_tri(scene, la, light_idx, u2)
    else:
        p_area, n_area = ref_p, torch.zeros_like(ref_p)
    if scene.has_sphere_lights:
        p_sph, n_sph, pdf_sph = _area_sample_sphere(scene, la, ref_p, u2)
        is_sph = torch.round(la[:, sa.LA_GEOM]) == sa.ALG_SPHERE
        p_area = torch.where(is_sph[:, None], p_sph, p_area)
        n_area = torch.where(is_sph[:, None], n_sph, n_area)
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
    is_delta = torch.zeros(ref_p.shape[0], dtype=torch.bool, device=ref_p.device)
    return LiSample(wi, li, pdf, p_area, n_area, is_delta)


def area_light_emitted(scene: sa.Scene, light_idx, n_hit, wo):
    """L() of a hit area light (lights/diffuse.rs l()): its radiance where
    wo leaves the emitting side, for light_idx >= 0."""
    lp = scene.light_attr[light_idx.long()]
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
