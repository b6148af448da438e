"""Ray differentials and the texture-space footprints they give for MIP
filtering.

The port of the JAX package's ``ops/differentials.py`` (reference
src/core/camera.rs:28 generate_ray_differential, interaction.rs:388-470
compute_differentials, and the width mipmap.rs:233-270 reads).  Only camera
rays carry differentials, as in the reference's path integrator: the
renders generate them where ``needs_diffs`` holds (an image map bound to a
material slot), and later bounces read the finest level (width 0).  Plain
PyTorch, elementwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import cameras as cam
from ..scene import arrays as sa
from ..utils import vecmath as vm
from . import texture as tx


class RayDiffs(NamedTuple):
    rx_o: torch.Tensor  # (N, 3) the origin of the ray one pixel over in x
    rx_d: torch.Tensor  # (N, 3)
    ry_o: torch.Tensor  # (N, 3) one pixel over in y
    ry_d: torch.Tensor  # (N, 3)


def needs_diffs(scene: sa.Scene) -> bool:
    """Whether the scene has an image map and binds a material slot to a
    texture: footprints feed only the image maps' MIP selection, and an
    image map a light alone reads does not need them."""
    return bool(scene.tex_kind_mask & (1 << tx.TEX_IMAGEMAP)) and bool(scene.tex_slot_mask)


def camera_differentials(camera: cam.Camera, rays: cam.CameraRays, p_film, u_lens, u_time,
                         spp: int) -> RayDiffs:
    """The rays one pixel over in x and in y (camera.rs:28 shifts the film
    sample so), pulled toward the base rays by max(1/8, 1/sqrt(spp)) as the
    reference's scale_differentials (integrator.rs:139-141)."""
    dx = torch.tensor([1.0, 0.0], device=p_film.device)
    dy = torch.tensor([0.0, 1.0], device=p_film.device)
    rx = cam.generate_rays(camera, p_film + dx, u_lens, u_time)
    ry = cam.generate_rays(camera, p_film + dy, u_lens, u_time)
    s = max(0.125, 1.0 / float(spp) ** 0.5)
    sx = lambda a, b: a + (b - a) * s
    return RayDiffs(sx(rays.o, rx.o), sx(rays.d, rx.d), sx(rays.o, ry.o), sx(rays.d, ry.d))


def bounce_width(scene: sa.Scene, it, diffs, bounce: int):
    """The footprints the path and volpath loops shade bounce `bounce` with
    (path.py:331-338 of the JAX package): None without differentials, the
    hits' duv_width_at_hit at bounce 0, else 0 (the finest level)."""
    if diffs is None:
        return None
    if bounce == 0:
        return duv_width_at_hit(scene, it, diffs)
    return torch.zeros(it.t.shape, device=it.t.device)


def _tri_dpdv(scene: sa.Scene, it):
    """dpdv of triangle hits, the uv parameterization's second column
    (triangle.rs:300-330); cross(ng, dpdu) elsewhere and where it is
    degenerate."""
    fallback = vm.cross(it.ng, it.dpdu)
    if scene.n_tris == 0:
        return fallback
    is_tri = it.valid & (it.prim >= 0) & (it.prim < scene.n_tris)
    at = scene.tri_attr[torch.clamp(it.prim, 0, scene.n_tris - 1).long()]
    col = lambda c, k: at[:, c:c + k]
    p0, p1, p2 = col(sa.TA_P0, 3), col(sa.TA_P1, 3), col(sa.TA_P2, 3)
    uv0, uv1, uv2 = col(sa.TA_UV0, 2), col(sa.TA_UV1, 2), col(sa.TA_UV2, 2)
    duv02, duv12 = uv0 - uv2, uv1 - uv2
    dp02, dp12 = p0 - p2, p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv_det[:, None]
    degen = vm.length_squared(dpdv) < 1e-16
    return torch.where((is_tri & ~degen)[:, None], dpdv, fallback)


def duv_width_at_hit(scene: sa.Scene, it, diffs: RayDiffs):
    """The texture-space footprint at the hits of the rays diffs offsets
    (interaction.rs:388-470): the offset rays meet the tangent plane, a 2x2
    solve in the two axes where the normal is smallest gives (du, dv) per
    pixel step, and the width is the largest |partial| (what mipmap.rs
    feeds the trilinear lookup).  (N,); 0 where the footprint is invalid."""
    n, p = it.ng, it.p
    nd = vm.dot(n, p)

    def plane_hit(ro, rd):
        # a lane whose offset ray misses the plane divides by 1: its width
        # is dropped below, and a finite t keeps its gradient 0, not NaN
        denom = vm.dot(n, rd)
        ok = denom.abs() > 1e-12
        t = (nd - vm.dot(n, ro)) / torch.where(ok, denom, 1.0)
        return ro + t[:, None] * rd - p, ok

    dpdx, okx = plane_hit(diffs.rx_o, diffs.rx_d)
    dpdy, oky = plane_hit(diffs.ry_o, diffs.ry_d)
    dpdu, dpdv = it.dpdu, _tri_dpdv(scene, it)
    # the two axes where |n| is smallest (interaction.rs:430-443)
    big = torch.argmax(n.abs(), dim=-1)
    dims = torch.stack([(big + 1) % 3, (big + 2) % 3], -1)
    ax3 = torch.arange(3, device=n.device)

    def pick(v, k):  # the one-hot sum of the JAX package
        return torch.where(dims[:, k:k + 1] == ax3, v, 0.0).sum(-1)

    a00, a01, a10, a11 = pick(dpdu, 0), pick(dpdv, 0), pick(dpdu, 1), pick(dpdv, 1)
    det = a00 * a11 - a01 * a10
    ok_det = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok_det, det, 1.0)

    def solve(dp):
        b0, b1 = pick(dp, 0), pick(dp, 1)
        return (a11 * b0 - a01 * b1) * inv, (a00 * b1 - a10 * b0) * inv

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    width = torch.maximum(torch.maximum(dudx.abs(), dvdx.abs()),
                          torch.maximum(dudy.abs(), dvdy.abs()))
    ok = it.valid & okx & oky & ok_det & torch.isfinite(width)
    return torch.where(ok, width, 0.0)
