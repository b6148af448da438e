"""Scene intersection: triangles and spheres -> Interaction records.

The port of the JAX package's ``ops/scene_intersect.py`` (reference
src/core/scene.rs:55-106, interaction.rs) for scenes of triangles and
analytic spheres.  Triangles go through the sweep kernels of
``ops/intersect_kernel.py``, as they go through the Pallas kernels on the
TPU: the closest hit with its record through K5 (``full_sweep``), shadow
rays through K4 (``any_sweep``); K3 (``closest_sweep``) serves
``dense_tri_hit``.  Spheres are tested in plain PyTorch, as the JAX
package tests them in XLA.  Curves, instances, animated triangles, alpha
masks, cylinders, disks and scenes past the brute-force limit raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import arrays as sa
from ..utils import transform as tr
from ..utils import vecmath as vm
from . import intersect as isect
from . import intersect_kernel as ik

# below this triangle count the JAX package sweeps densely; above it, it
# traverses a BVH (not ported yet)
BRUTE_FORCE_MAX_TRIS = 4096


class Interaction(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,)
    p: torch.Tensor  # (N,3)
    p_error: torch.Tensor  # (N,3)
    ng: torch.Tensor  # (N,3) geometric normal
    ns: torch.Tensor  # (N,3) shading normal
    uv: torch.Tensor  # (N,2)
    wo: torch.Tensor  # (N,3)
    mat: torch.Tensor  # (N,) int32
    light: torch.Tensor  # (N,) int32 area light id or -1
    prim: torch.Tensor  # (N,) int32: triangle id, or n_tris + sphere id, or -1
    dpdu: torch.Tensor  # (N,3) surface u-tangent (the BSDF frame's x axis)


def check_supported(scene: sa.Scene):
    """Raises NotImplementedError for what the port cannot intersect yet."""
    missing = [name for name, present in (
        ("curves", scene.n_curve_segs), ("instances", scene.n_instances),
        ("animated triangles", scene.n_anim_tris), ("alpha masks", scene.has_alpha),
        ("cylinders", scene.quad_kind_mask & (1 << sa.QK_CYLINDER)),
        ("disks", scene.quad_kind_mask & (1 << sa.QK_DISK)),
        (f"more than {BRUTE_FORCE_MAX_TRIS} triangles (the BVH)",
         scene.n_tris > BRUTE_FORCE_MAX_TRIS),
    ) if present]
    if missing:
        raise NotImplementedError(f"scene intersection of {', '.join(missing)} is not ported "
                                  "yet (ROADMAP queue A)")


def dense_tri_hit(scene: sa.Scene, o, d, t_max) -> isect.TriHit:
    """Closest triangle hit over the whole table (K3)."""
    return ik.closest_sweep(o, d, t_max, scene.tri_attr, scene.n_tris)


def dense_tri_hit_p(scene: sa.Scene, o, d, t_max) -> torch.Tensor:
    """Any triangle hit before t_max (K4)."""
    return ik.any_sweep(o, d, t_max, scene.tri_attr, scene.n_tris)


def sphere_hits(scene: sa.Scene, o, d, t_max):
    """Closest hit over every sphere, tested in object space:
    (valid, t (t_max where none), sphere index, object-space point, phi)."""
    n_s = scene.n_spheres
    sat = scene.sph_attr[:n_s]
    w2o = sat[:, sa.SP_W2O:sa.SP_W2O + 16].reshape(n_s, 4, 4)
    o_obj = tr.xform_point(w2o, o[:, None, :])  # (N, S, 3)
    d_obj = tr.xform_vector(w2o, d[:, None, :])
    prm = sat[:, sa.SP_PARAMS:sa.SP_PARAMS + 4]
    qh = isect.intersect_sphere(o_obj, d_obj, t_max[:, None], prm[:, 0], prm[:, 1], prm[:, 2],
                                prm[:, 3])
    t = torch.where(qh.valid, qh.t, float(isect.BIG_T))
    best = torch.argmin(t, dim=1)
    best_t = t.gather(1, best[:, None])[:, 0]
    valid = best_t < isect.BIG_T
    lane = torch.arange(o.shape[0], device=o.device)
    return (valid, torch.where(valid, best_t, t_max), best.to(torch.int32),
            qh.p_obj[lane, best], qh.phi[lane, best])


def sphere_interaction(scene: sa.Scene, sph_idx, p_obj, phi):
    """(p, p_err, ng, ns, uv, mat, light, dpdu) of sphere hits
    (sphere.rs interaction; ns = ng)."""
    at = scene.sph_attr[sph_idx.long()]
    radius = at[:, sa.SP_PARAMS]
    z_min = at[:, sa.SP_PARAMS + 1]
    z_max = at[:, sa.SP_PARAMS + 2]
    phi_max = at[:, sa.SP_PARAMS + 3]
    o2w = at[:, sa.SP_O2W:sa.SP_O2W + 16].reshape(-1, 4, 4)
    w2o = at[:, sa.SP_W2O:sa.SP_W2O + 16].reshape(-1, 4, 4)
    acos = lambda x: torch.arccos(torch.clamp(x, -1.0, 1.0))
    theta = acos(p_obj[:, 2] / radius)
    theta_min = acos(z_min / radius)
    theta_max = acos(z_max / radius)
    u = phi / phi_max
    v = (theta - theta_min) / torch.where(theta_max == theta_min, 1.0, theta_max - theta_min)
    n_obj = vm.normalize(p_obj)
    p, p_err_local = tr.xform_point_with_error(o2w, p_obj)
    # the object-space hit error gamma(5) |p_obj|, carried conservatively
    p_err = p_err_local + float(vm.gamma(5.0)) * p.abs()
    ng = vm.normalize(tr.xform_normal(w2o, n_obj))
    flip = (at[:, sa.SP_REVERSE] > 0.5) ^ tr.swaps_handedness(o2w)
    ng = torch.where(flip[:, None], -ng, ng)
    # dpdu = (-phi_max y, phi_max x, 0) in object space (sphere.rs)
    dpdu_obj = torch.stack([-phi_max * p_obj[:, 1], phi_max * p_obj[:, 0],
                            torch.zeros_like(phi_max)], -1)
    dpdu = tr.xform_vector(o2w, dpdu_obj)
    dpdu_fb, _ = vm.coordinate_system(ng)
    dpdu = torch.where((vm.length_squared(dpdu) < 1e-16)[:, None], dpdu_fb, dpdu)
    mat = torch.round(at[:, sa.SP_MAT]).to(torch.int32)
    light = torch.round(at[:, sa.SP_LIGHT]).to(torch.int32)
    return p, p_err, ng, ng, torch.stack([u, v], -1), mat, light, dpdu


def scene_intersect(scene: sa.Scene, o, d, t_max) -> Interaction:
    """Closest hit of rays o, d (N, 3) within t_max (N,): triangles through
    K5, then spheres against the triangle hit's distance."""
    check_supported(scene)
    n = o.shape[0]
    dev = o.device
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if scene.n_tris > 0:
        fh = ik.full_sweep(o, d, t_max, scene.tri_attr, scene.n_tris)
        tv, tt, tprim = fh.valid, fh.rows[ik.F_T], fh.ids[ik.I_PRIM]
        tp, tperr, tng, tns = (fh.vec(ik.F_P), fh.vec(ik.F_P_ERR), fh.vec(ik.F_NG),
                               fh.vec(ik.F_NS))
        tuv, tdpdu = fh.vec(ik.F_UV, 2), fh.vec(ik.F_DPDU)
        tmat, tlight = fh.ids[ik.I_MAT], fh.ids[ik.I_LIGHT]
    else:
        tv = torch.zeros(n, dtype=torch.bool, device=dev)
        tt, tprim = t_max, torch.full((n,), -1, dtype=torch.int32, device=dev)
        tp = tperr = tng = tns = tdpdu = zero3
        tuv = torch.zeros((n, 2), device=dev)
        tmat = torch.zeros(n, dtype=torch.int32, device=dev)
        tlight = torch.full((n,), -1, dtype=torch.int32, device=dev)

    if scene.n_spheres == 0:
        valid = tv
        mat, light = torch.where(valid, tmat, 0), torch.where(valid, tlight, -1)
        return Interaction(valid, tt, tp, tperr, tng, tns, tuv, -vm.normalize(d), mat, light,
                           torch.where(valid, tprim, -1), tdpdu)

    sv, st, sidx, p_obj, phi = sphere_hits(scene, o, d, torch.where(tv, tt, t_max))
    use_sph = sv & (~tv | (st < tt))
    valid = tv | sv
    t = torch.where(use_sph, st, tt)
    sp, sperr, sng, sns, suv, smat, slight, sdpdu = sphere_interaction(scene, sidx, p_obj, phi)
    sel = lambda a, b: torch.where(use_sph[:, None], a, b)
    mat = torch.where(use_sph, smat, tmat)
    light = torch.where(use_sph, slight, tlight)
    prim = torch.where(use_sph, scene.n_tris + sidx, tprim)
    return Interaction(
        valid, t, sel(sp, tp), sel(sperr, tperr), sel(sng, tng), sel(sns, tns), sel(suv, tuv),
        -vm.normalize(d), torch.where(valid, mat, 0), torch.where(valid, light, -1),
        torch.where(valid, prim, -1), sel(sdpdu, tdpdu),
    )


def scene_intersect_p(scene: sa.Scene, o, d, t_max) -> torch.Tensor:
    """Any hit (shadow ray) within t_max: triangles through K4, then the
    spheres."""
    check_supported(scene)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if scene.n_tris > 0:
        occ = occ | dense_tri_hit_p(scene, o, d, t_max)
    if scene.n_spheres > 0:
        occ = occ | sphere_hits(scene, o, d, t_max)[0]
    return occ
