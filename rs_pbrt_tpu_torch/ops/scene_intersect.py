"""Scene intersection: triangles, quadrics, curves, instances and moving
meshes -> Interaction records.

The port of the JAX package's ``ops/scene_intersect.py`` (reference
src/core/scene.rs:55-106, interaction.rs).  Up to
``BRUTE_FORCE_MAX_TRIS`` triangles go through the sweep kernels of
``ops/intersect_kernel.py``, as they go through the Pallas kernels on the
TPU: the closest hit with its record through K5 (``full_sweep``), shadow
rays through K4 (``any_sweep``); K3 (``closest_sweep``) serves
``dense_tri_hit``.  Larger triangle sets go through their 12-wide BVH
(``build_accel``): the closest hit through B1 and shadow rays through B2
(``ops/bvh.py``), or, built with ``kind="kdtree"``, through their
kd-tree, D1 and D2 (``ops/kdtree_kernel.py``); the hit record from
``ops/record.tri_record``.  The
quadrics are tested in plain PyTorch, every ray against every quadric of
the kinds the scene has, as the JAX package tests them in XLA.  Curve
segments go through the curve kernels of ``ops/curve_kernel.py``: up to
``BRUTE_FORCE_MAX_CURVES`` the dense sweeps C3 (closest) and C4 (shadow
rays), above it the walks C1 and C2 through the curves' binary tree; their
hit record is ``curves.curve_interaction``.  Where triangles carry alpha
masks, a hit whose mask is 0 at its uv is skipped by casting again from
just past it (``alpha_recast_loop``), the mask tests through T1
(``ops/texture_kernel.py``); shadow rays then take the closest hit and the
same loop with the shadow-alpha masks too.  Instances go through the
two-level walk I1 and I2 (``ops/instance_kernel.py``; the accel's
``inst``), against the nearest of the hits above, and animated meshes
through the moving-mesh sweep V1 (``ops/motion_kernel.py``) at each ray's
time, against the nearest of all the others (the JAX order,
scene_intersect.py:689-730 and :768-773); their records are
``instance_interaction`` and ``anim_interaction``, and neither carries an
area light.  ``time`` (N,) is each ray's time in the shutter; None is
time 0, as every integrator but path passes it.

Where autograd records through the rays or the triangle table (a camera
or geometry gradient), the closest triangle hit is differentiable: the
walk the scene uses (K3 for the dense table, B1, D1) runs on detached
rays inside ``hit_grad_kernel.TriHitFn``, whose backward is G1, and the
record is ``tri_record``'s, differentiable in the table, as the JAX
package rebuilds its record from the hit (``_tri_interaction``).  So is
the closest curve hit (C1 or C3 on detached rays, C5 its backward,
``curve_kernel.diff_curve_hit``) and the closest moving-mesh hit (V1 on
detached rays, G1 in the mesh's object space at the ray's time,
``hit_grad_kernel.diff_anim_hit``).  Shadow rays' any hits are discrete,
so their kernels take the rays detached.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve
from ..scene import arrays as sa
from ..utils import transform as tr
from ..utils import vecmath as vm
from ..utils import animated as an
from . import bvh
from . import bvh_native
from . import curve_kernel as ck
from . import curves as cv
from . import hit_grad_kernel as hg
from . import instance_kernel as ink
from . import instancing as inst
from . import intersect as isect
from . import intersect_kernel as ik
from . import kdtree as kdmod
from . import kdtree_kernel as kdk
from . import motion_kernel as mok
from . import texture as tx
from . import texture_kernel as tk
from .autodiff import tracks
from .record import tri_record

# up to this triangle count the triangles are swept densely; above it they
# are traversed through their BVH
BRUTE_FORCE_MAX_TRIS = 4096
# up to this many segments the curves are swept densely; above it they are
# walked through their tree
BRUTE_FORCE_MAX_CURVES = 1024


ACCELERATORS = ("bvh", "kdtree")


class Accel(NamedTuple):
    """The triangle family's 12-wide BVH (scene_intersect.Accel of the JAX
    package, with its wide12 rows) or its kd-tree, the curves' binary tree
    and the instances' trees; tri and kd None: the triangles are swept, crv
    None: the curves are."""

    tri: Optional[torch.Tensor] = None  # (M, 128) f32 wide12 rows
    tri_depth: int = 0  # the wide tree's depth (its traversal stack size)
    crv: Optional[cv.CurveBVH] = None
    inst: Optional[inst.InstanceAccel] = None
    kd: Optional[kdmod.KdTree] = None
    kd_tris: Optional[torch.Tensor] = None  # (T, 9) f32 the triangles' vertices, for the kd walk


def build_accel(scene: sa.Scene, kind: str = "bvh", device="cuda") -> Accel:
    """The scene's accelerator on `device`, built on the host (the JAX
    build_accel, scene_intersect.py:796-842): for more than
    BRUTE_FORCE_MAX_TRIS triangles an SAH BVH collapsed into 12-wide rows
    (ops/bvh_native.py), or with kind "kdtree" the SAH kd-tree
    (ops/kdtree.py); the curves' binary tree above BRUTE_FORCE_MAX_CURVES;
    and the instances' top and prototype trees (ops/instancing.py).  kind:
    "bvh" (the reference's default, api.rs:528) or "kdtree"."""
    if kind not in ACCELERATORS:
        raise ValueError(f"accelerator {kind!r}: the port builds {ACCELERATORS}")
    dev = resolve(device)
    accel = Accel()
    if scene.n_tris > BRUTE_FORCE_MAX_TRIS:
        tris = scene.tri_attr[:scene.n_tris, sa.TA_P0:sa.TA_P0 + 9].cpu().numpy()
        p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
        bmin = np.minimum(np.minimum(p0, p1), p2)
        bmax = np.maximum(np.maximum(p0, p1), p2)
        if kind == "kdtree":
            accel = accel._replace(
                kd=kdmod.kdtree_from_numpy(kdmod.build_kdtree(bmin, bmax), dev),
                kd_tris=torch.as_tensor(np.ascontiguousarray(tris), device=dev))
        else:
            rows, depth = bvh_native.build_lbvh_native(bmin, bmax, (p0, p1, p2))
            accel = accel._replace(tri=torch.as_tensor(rows, device=dev), tri_depth=depth)
    if scene.n_curve_segs > BRUTE_FORCE_MAX_CURVES:
        tree = bvh_native.build_binary_native(*cv.segment_boxes(scene.crv_attr.cpu().numpy()))
        accel = accel._replace(crv=cv.curve_bvh_from_numpy(**tree, device=dev))
    if scene.n_instances > 0:
        tris = scene.proto_attr[:scene.n_proto_tris, sa.TA_P0:sa.TA_P0 + 9].cpu().numpy()
        p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
        pr = scene.proto_range.cpu().numpy()
        pb = np.stack([np.stack([np.minimum(np.minimum(p0[a:b], p1[a:b]), p2[a:b]).min(0),
                                 np.maximum(np.maximum(p0[a:b], p1[a:b]), p2[a:b]).max(0)])
                       for a, b in pr])  # (P, 2, 3)
        accel = accel._replace(inst=inst.build_instance_accel(
            [tuple(r) for r in pr], pb, scene.inst_proto.cpu().numpy(),
            scene.inst_o2w.cpu().numpy(), tris, dev))
    return accel


def accel_from_numpy(rows, depth: int, device="cuda") -> Accel:
    """Accel from wide12 rows and depth built elsewhere, as the JAX package
    holds them: ``rows = build_accel(...).tri.wide128`` and ``depth =
    wide128_dflag.shape[0]`` (scene_from_numpy's counterpart for the tree)."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[1] != bvh.W12_COLS:
        raise ValueError(f"wide12 rows must be (M, {bvh.W12_COLS}), not {rows.shape}")
    return Accel(torch.tensor(rows, device=resolve(device)), int(depth))


def uses_bvh(scene: sa.Scene, accel: Optional[Accel]) -> bool:
    """Whether the scene's triangles are traversed through accel's BVH."""
    return accel is not None and accel.tri is not None and scene.n_tris > BRUTE_FORCE_MAX_TRIS


def uses_kd(scene: sa.Scene, accel: Optional[Accel]) -> bool:
    """Whether the scene's triangles are walked through accel's kd-tree."""
    return accel is not None and accel.kd is not None and scene.n_tris > BRUTE_FORCE_MAX_TRIS


def uses_tree(scene: sa.Scene, accel: Optional[Accel]) -> bool:
    """Whether any of the scene's families is walked through a tree of
    accel: the triangles' BVH or kd-tree, the curves' tree or the
    instances' trees (path regeneration's gate, regen.eligible)."""
    return (uses_bvh(scene, accel) or uses_kd(scene, accel) or uses_curve_bvh(scene, accel)
            or (scene.n_instances > 0 and accel is not None and accel.inst is not None))


def uses_curve_bvh(scene: sa.Scene, accel: Optional[Accel]) -> bool:
    """Whether the scene's curves are walked through accel's curve tree."""
    return (accel is not None and accel.crv is not None
            and scene.n_curve_segs > BRUTE_FORCE_MAX_CURVES)


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
    prim: torch.Tensor  # (N,) int32: triangle id, n_tris + sphere id,
    #                     n_tris + n_spheres + curve segment id, then + n_curve_segs
    #                     the prototype triangle of an instance hit, then + n_proto_tris
    #                     the animated triangle, or -1
    dpdu: torch.Tensor  # (N,3) surface u-tangent (the BSDF frame's x axis)


def _need_instance_accel(scene: sa.Scene, accel: Optional[Accel]):
    if scene.n_instances > 0 and (accel is None or accel.inst is None):
        raise ValueError("scene has instanced geometry; build the accelerator first "
                         "(ops.scene_intersect.build_accel) and pass it to "
                         "scene_intersect/render")


def check_supported(scene: sa.Scene, accel: Optional[Accel] = None):
    """Raises NotImplementedError for what the port cannot intersect yet,
    and ValueError for a scene whose instances or triangles need the accel
    it was not given."""
    _need_instance_accel(scene, accel)
    if scene.n_tris > BRUTE_FORCE_MAX_TRIS and not (uses_bvh(scene, accel)
                                                     or uses_kd(scene, accel)):
        raise NotImplementedError(f"more than {BRUTE_FORCE_MAX_TRIS} triangles need their BVH: "
                                  "pass accel=build_accel(scene)")
    if scene.n_curve_segs > BRUTE_FORCE_MAX_CURVES and not uses_curve_bvh(scene, accel):
        raise NotImplementedError(f"more than {BRUTE_FORCE_MAX_CURVES} curve segments need their "
                                  "tree: pass accel=build_accel(scene)")
    if accel is not None:
        for t in (accel.tri, None if accel.crv is None else accel.crv.box,
                  None if accel.inst is None else accel.inst.top_box,
                  None if accel.kd is None else accel.kd.axis):
            if t is not None and t.device != scene.device:
                raise ValueError(f"the accel lies on {t.device}, the scene on {scene.device}")


def tri_hit(scene: sa.Scene, o, d, t_max, accel: Optional[Accel] = None) -> isect.TriHit:
    """Closest triangle hit: B1 through the BVH, D1 through the kd-tree,
    else K3 over the whole table; differentiable in o, d and the table's
    vertices through G1 (hit_grad_kernel.diff_tri_hit) where autograd
    records through any of them."""
    if uses_bvh(scene, accel):
        walk = lambda o_, d_, t_: bvh.bvh12_intersect_tris(o_, d_, t_, accel.tri, accel.tri_depth)
    elif uses_kd(scene, accel):
        walk = lambda o_, d_, t_: kdk.kd_intersect(o_.contiguous(), d_.contiguous(),
                                                   t_.contiguous(), accel.kd, accel.kd_tris)
    else:
        walk = lambda o_, d_, t_: dense_tri_hit(scene, o_, d_, t_)
    if tracks(o, d, scene.tri_attr):
        return hg.diff_tri_hit(o, d, t_max, scene.tri_attr, walk)
    return walk(o, d, t_max)


def dense_tri_hit(scene: sa.Scene, o, d, t_max) -> isect.TriHit:
    """Closest triangle hit over the whole table (K3)."""
    return ik.closest_sweep(o.contiguous(), d.contiguous(), t_max.contiguous(), scene.tri_attr,
                            scene.n_tris)


def dense_tri_hit_p(scene: sa.Scene, o, d, t_max) -> torch.Tensor:
    """Any triangle hit before t_max (K4).  The rays may be views of a hit
    record's rows (a triangle-only scene's hit points), which the kernel
    takes only contiguous."""
    return ik.any_sweep(o.contiguous(), d.contiguous(), t_max.contiguous(), scene.tri_attr,
                        scene.n_tris)


def _has_kind(scene: sa.Scene, kind: int) -> bool:
    """Whether quadrics of `kind` (QK_*) may exist: its bit of the scene's
    quad_kind_mask, or every kind where the mask is 0 (as the JAX package
    reads it)."""
    return scene.quad_kind_mask == 0 or bool(scene.quad_kind_mask & (1 << kind))


def sphere_hits(scene: sa.Scene, o, d, t_max):
    """Closest hit over every quadric (sphere, cylinder, disk), each tested
    in object space by its kind's test; the kinds quad_kind_mask says are
    absent are not tested.  -> (valid, t (t_max where none), quadric index,
    object-space point, phi)."""
    n_s = scene.n_spheres
    sat = scene.sph_attr[:n_s]
    w2o = sat[:, sa.SP_W2O:sa.SP_W2O + 16].reshape(n_s, 4, 4)
    o_obj = tr.xform_point(w2o, o[:, None, :])  # (N, S, 3)
    d_obj = tr.xform_vector(w2o, d[:, None, :])
    prm = sat[:, sa.SP_PARAMS:sa.SP_PARAMS + 4]
    kind = torch.round(sat[:, sa.SP_KIND])
    tm = t_max[:, None]
    t = torch.full(o_obj.shape[:-1], float(isect.BIG_T), device=o.device)
    p_obj = torch.zeros_like(o_obj)
    phi = torch.zeros_like(t)
    tests = (
        (sa.QK_SPHERE, lambda: isect.intersect_sphere(o_obj, d_obj, tm, *prm.unbind(-1))),
        (sa.QK_CYLINDER, lambda: isect.intersect_cylinder(o_obj, d_obj, tm, *prm.unbind(-1))),
        # a disk's params are (radius, inner radius, height, phi_max)
        (sa.QK_DISK, lambda: isect.intersect_disk(o_obj, d_obj, tm, prm[:, 2], prm[:, 0],
                                                  prm[:, 1], prm[:, 3])),
    )
    for k, test in tests:
        if _has_kind(scene, k):
            qh = test()
            sel = (kind == k) & qh.valid
            t = torch.where(sel, qh.t, t)
            p_obj = torch.where(sel[..., None], qh.p_obj, p_obj)
            phi = torch.where(sel, qh.phi, phi)
    best = torch.argmin(t, dim=1)
    best_t = t.gather(1, best[:, None])[:, 0]
    valid = best_t < isect.BIG_T
    lane = torch.arange(o.shape[0], device=o.device)
    return (valid, torch.where(valid, best_t, t_max), best.to(torch.int32),
            p_obj[lane, best], phi[lane, best])


def sphere_interaction(scene: sa.Scene, sph_idx, p_obj, phi):
    """(p, p_err, ng, ns, uv, mat, light, dpdu) of quadric hits (sphere.rs,
    cylinder.rs, disk.rs interaction; ns = ng): a sphere's normal is its
    point, a cylinder's (x, y, 0) with v along z, a disk's +z with v from
    the rim inward."""
    at = scene.sph_attr[sph_idx.long()]
    radius = at[:, sa.SP_PARAMS]
    z_min = at[:, sa.SP_PARAMS + 1]  # a disk's inner radius
    z_max = at[:, sa.SP_PARAMS + 2]
    phi_max = at[:, sa.SP_PARAMS + 3]
    kind = torch.round(at[:, sa.SP_KIND])
    o2w = at[:, sa.SP_O2W:sa.SP_O2W + 16].reshape(-1, 4, 4)
    w2o = at[:, sa.SP_W2O:sa.SP_W2O + 16].reshape(-1, 4, 4)
    acos = lambda x: torch.arccos(torch.clamp(x, -1.0, 1.0))
    theta = acos(p_obj[:, 2] / radius)
    theta_min = acos(z_min / radius)
    theta_max = acos(z_max / radius)
    u = phi / phi_max
    v = (theta - theta_min) / torch.where(theta_max == theta_min, 1.0, theta_max - theta_min)
    n_obj = vm.normalize(p_obj)
    if _has_kind(scene, sa.QK_CYLINDER):
        is_cyl = kind == sa.QK_CYLINDER
        n_cyl = vm.normalize(torch.stack([p_obj[:, 0], p_obj[:, 1], torch.zeros_like(phi)], -1))
        n_obj = torch.where(is_cyl[:, None], n_cyl, n_obj)
        v = torch.where(is_cyl, (p_obj[:, 2] - z_min) / torch.clamp(z_max - z_min, min=1e-12), v)
    if _has_kind(scene, sa.QK_DISK):
        is_dsk = kind == sa.QK_DISK
        r_hit = torch.sqrt(torch.clamp(p_obj[:, 0] ** 2 + p_obj[:, 1] ** 2, min=1e-20))
        n_dsk = torch.cat([torch.zeros_like(p_obj[:, :2]), torch.ones_like(phi)[:, None]], -1)
        n_obj = torch.where(is_dsk[:, None], n_dsk, n_obj)
        v = torch.where(is_dsk, (radius - r_hit) / torch.clamp(radius - z_min, min=1e-12), v)
    p, p_err_local = tr.xform_point_with_error(o2w, p_obj)
    # the object-space hit error gamma(5) |p_obj|, carried conservatively
    p_err = p_err_local + float(vm.gamma(5.0)) * p.abs()
    ng = vm.normalize(tr.xform_normal(w2o, n_obj))
    flip = (at[:, sa.SP_REVERSE] > 0.5) ^ tr.swaps_handedness(o2w)
    ng = torch.where(flip[:, None], -ng, ng)
    # dpdu = (-phi_max y, phi_max x, 0) in object space (every kind)
    dpdu_obj = torch.stack([-phi_max * p_obj[:, 1], phi_max * p_obj[:, 0],
                            torch.zeros_like(phi_max)], -1)
    dpdu = tr.xform_vector(o2w, dpdu_obj)
    dpdu_fb, _ = vm.coordinate_system(ng)
    dpdu = torch.where((vm.length_squared(dpdu) < 1e-16)[:, None], dpdu_fb, dpdu)
    mat = torch.round(at[:, sa.SP_MAT]).to(torch.int32)
    light = torch.round(at[:, sa.SP_LIGHT]).to(torch.int32)
    return p, p_err, ng, ng, torch.stack([u, v], -1), mat, light, dpdu


def curve_hit(scene: sa.Scene, o, d, t_max, accel: Optional[Accel]) -> cv.CurveHit:
    """The closest curve segment within t_max: C1 through the curve tree,
    else the sweep C3; differentiable in o and d through C5
    (curve_kernel.diff_curve_hit) where autograd records through them."""
    if uses_curve_bvh(scene, accel):
        walk = lambda o_, d_, t_: ck.walk_closest(o_, d_, t_, accel.crv, scene.crv_attr)
    else:
        walk = lambda o_, d_, t_: ck.sweep_closest(o_, d_, t_, scene.crv_attr)
    if tracks(o, d, t_max):
        return ck.diff_curve_hit(o, d, t_max, scene.crv_attr, walk)
    return walk(o, d, t_max)


def _object_record(attr, tri, b0, b1, o2w, w2o, reverse: bool):
    """(p, p_err, ng, ns, uv, dpdu, rows) of triangle hits stored in object
    space (rows tri of attr, at barycentrics b0, b1 (N,)), carried to the
    world by o2w (N, 4, 4), the normals by its inverse w2o, the error bound
    through o2w too (primitive.rs:236-265); reverse: a reversed triangle's
    normals flip (the animated meshes; the JAX instances keep theirs)."""
    at = attr[torch.clamp(tri, 0, attr.shape[0] - 1).long()]
    col = lambda c, w=3: at[:, c:c + w]
    b0, b1 = b0[:, None], b1[:, None]
    b2 = 1.0 - b0 - b1
    p0, p1, p2 = col(sa.TA_P0), col(sa.TA_P1), col(sa.TA_P2)
    p_obj = b0 * p0 + b1 * p1 + b2 * p2
    perr_obj = float(vm.gamma(7.0)) * ((b0 * p0).abs() + (b1 * p1).abs() + (b2 * p2).abs())
    ng_obj = vm.normalize(vm.cross(p0 - p2, p1 - p2))
    ns_obj = b0 * col(sa.TA_N0) + b1 * col(sa.TA_N1) + b2 * col(sa.TA_N2)
    ns_len = torch.sqrt(torch.clamp(vm.length_squared(ns_obj), min=1e-20))
    has_n = (at[:, sa.TA_HAS_N] > 0.5) & (ns_len > 1e-8)
    ns_obj = torch.where(has_n[:, None], ns_obj / torch.clamp(ns_len, min=1e-8)[:, None], ng_obj)
    ng_flat = ng_obj  # the geometric normal where no shading normal turns it
    if reverse:
        rev = (at[:, sa.TA_REVERSE] > 0.5)[:, None]
        ns_obj = torch.where(rev, -ns_obj, ns_obj)
        ng_flat = torch.where(rev, -ng_obj, ng_obj)
    ng_obj = torch.where(has_n[:, None], vm.face_forward(ng_obj, ns_obj), ng_flat)
    uv = b0 * col(sa.TA_UV0, 2) + b1 * col(sa.TA_UV1, 2) + b2 * col(sa.TA_UV2, 2)
    p, terr = tr.xform_point_with_error(o2w, p_obj)
    p_err = terr + tr.xform_vector(o2w.abs(), perr_obj).abs()
    ng = vm.normalize(tr.xform_normal(w2o, ng_obj))
    ns = vm.normalize(tr.xform_normal(w2o, ns_obj))
    dpdu = tr.xform_vector(o2w, p1 - p0)
    dpdu_fb, _ = vm.coordinate_system(ng)
    dpdu = torch.where((vm.length_squared(dpdu) < 1e-16)[:, None], dpdu_fb, dpdu)
    return p, p_err, ng, ns, uv, dpdu, at


def instance_interaction(scene: sa.Scene, ih: inst.InstanceHit) -> dict:
    """The fields of instance hits (the JAX _instance_interaction,
    scene_intersect.py:397): the prototype triangle's record in object
    space carried to the world by the instance's transform; the instance's
    material where it names one (>= 0)."""
    ii = torch.clamp(ih.inst, 0, scene.n_instances - 1).long()
    p, p_err, ng, ns, uv, dpdu, at = _object_record(
        scene.proto_attr, ih.tri, ih.b0, ih.b1, scene.inst_o2w[ii], scene.inst_w2o[ii], False)
    mat_ov = scene.inst_mat[ii]
    mat = torch.where(mat_ov >= 0, mat_ov, torch.round(at[:, sa.TA_MAT]).to(torch.int32))
    return dict(p=p, p_err=p_err, ng=ng, ns=ns, uv=uv, dpdu=dpdu, mat=mat)


def instance_hit(scene: sa.Scene, o, d, t_cur, accel: Optional[Accel], any_hit: bool = False):
    """I1 (or I2, any_hit) through accel's instance trees (the JAX
    _instance_hit, scene_intersect.py:453, which raises without them)."""
    _need_instance_accel(scene, accel)
    return ink.instance_intersect(o.contiguous(), d.contiguous(), t_cur.contiguous(), accel.inst,
                                  any_hit=any_hit)


def anim_hits(scene: sa.Scene, o, d, t_cur, time, any_hit: bool = False):
    """V1 over the animated meshes at each ray's time (None: 0); the
    closest hit differentiable in o, d and time through G1
    (hit_grad_kernel.diff_anim_hit) where autograd records through them."""
    launch = lambda o_, d_, t_, time_: mok.anim_hits(
        o_.contiguous(), d_.contiguous(), t_.contiguous(),
        None if time_ is None else time_.contiguous(), scene, any_hit=any_hit)
    if not any_hit and tracks(o, d, t_cur, time):
        return hg.diff_anim_hit(o, d, t_cur, time, scene.anim_xf, scene.anim_attr, launch)
    return launch(o, d, t_cur, time)


def anim_interaction(scene: sa.Scene, ah: dict, time) -> dict:
    """The fields of animated-mesh hits (the JAX _anim_interaction,
    scene_intersect.py:528): the triangle's object-space record through its
    group's transform interpolated at the ray's time, the normals through
    its inverse; a reversed triangle's normals flip."""
    n = ah["t"].shape[0]
    t_lane = torch.zeros(n, device=ah["t"].device) if time is None else time
    m = an.interpolate(t_lane, *an.xf_parts(scene.anim_xf[ah["grp"].long()]))
    p, p_err, ng, ns, uv, dpdu, at = _object_record(
        scene.anim_attr, ah["tri"], ah["b0"], ah["b1"], m, an.inverse_affine(m), True)
    return dict(p=p, p_err=p_err, ng=ng, ns=ns, uv=uv, dpdu=dpdu,
                mat=torch.round(at[:, sa.TA_MAT]).to(torch.int32))


def _merge(hit: dict, use, new: dict) -> dict:
    """hit's fields (Interaction's names, those the record carries) with
    new's where use (N,) is set; valid gains use."""
    out = {k: torch.where(use[:, None] if v.dim() == 2 else use, new[k], v) if k in new else v
           for k, v in hit.items()}
    out["valid"] = hit["valid"] | use
    return out


def _scene_intersect_once(scene: sa.Scene, o, d, t_max, accel: Optional[Accel],
                          time=None) -> Interaction:
    """Closest hit of rays o, d (N, 3) within t_max (N,), masks aside:
    triangles through K5, or through B1 (D1) and the record where the
    scene has its BVH (kd-tree), then spheres against the triangle hit's
    distance, then curves against the nearer of the two, then instances
    (I1) and animated meshes (V1, at time) each against the nearest so far
    (scene_intersect.py:626-730 of the JAX package)."""
    n = o.shape[0]
    dev = o.device
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    tree = uses_bvh(scene, accel) or uses_kd(scene, accel)
    if tree or (scene.n_tris > 0 and tracks(o, d, scene.tri_attr)):
        th = tri_hit(scene, o, d, t_max, accel)
        rec = tri_record(scene.tri_attr, th.tri, th.b0, th.b1)
        tv, tt, tprim = th.valid, th.t, th.tri
        tp, tperr, tng, tns, tuv, tdpdu = (torch.stack(v, -1) for v in (
            rec.p, rec.p_err, rec.ng, rec.ns, rec.uv, rec.dpdu))
        tmat, tlight = torch.where(tv, rec.mat, 0), torch.where(tv, rec.light, -1)
    elif scene.n_tris > 0:
        fh = ik.full_sweep(o.contiguous(), d.contiguous(), t_max.contiguous(), scene.tri_attr,
                           scene.n_tris)
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

    hit = dict(valid=tv, t=tt, p=tp, p_err=tperr, ng=tng, ns=tns, uv=tuv, dpdu=tdpdu, mat=tmat,
               light=tlight, prim=tprim)
    if scene.n_spheres > 0:
        sv, st, sidx, p_obj, phi = sphere_hits(scene, o, d, torch.where(tv, tt, t_max))
        sp, sperr, sng, sns, suv, smat, slight, sdpdu = sphere_interaction(scene, sidx, p_obj,
                                                                           phi)
        hit = _merge(hit, sv & (~tv | (st < tt)), dict(
            t=st, p=sp, p_err=sperr, ng=sng, ns=sns, uv=suv, dpdu=sdpdu, mat=smat, light=slight,
            prim=scene.n_tris + sidx))
        t_so_far = torch.minimum(torch.where(tv, tt, t_max), torch.where(sv, st, t_max))
    else:
        t_so_far = torch.where(tv, tt, t_max)
    no_light = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if scene.n_curve_segs > 0:
        # the curves against the nearer of the triangle and sphere hits; a
        # curve wins only nearer, its geometric normal is its shading normal
        ch = curve_hit(scene, o, d, t_so_far, accel)
        cp_, cperr, cdpdu, cns, cuv, cmat = cv.curve_interaction(o, d, scene.crv_attr, ch)
        hit = _merge(hit, ch.valid & (~hit["valid"] | (ch.t < hit["t"])), dict(
            t=ch.t, p=cp_, p_err=cperr, ng=cns, ns=cns, uv=cuv, dpdu=cdpdu, mat=cmat,
            light=no_light, prim=scene.n_tris + scene.n_spheres + ch.seg))
    # instances, then moving meshes, each against the nearest hit so far;
    # neither carries an area light
    offset = scene.n_tris + scene.n_spheres + scene.n_curve_segs
    if scene.n_instances:
        ih = instance_hit(scene, o, d, hit["t"], accel)
        hit = _merge(hit, ih.valid & (~hit["valid"] | (ih.t < hit["t"])), dict(
            instance_interaction(scene, ih), t=ih.t, light=no_light, prim=offset + ih.tri))
    if scene.n_anim_tris:
        ah = anim_hits(scene, o, d, hit["t"], time)
        hit = _merge(hit, ah["valid"] & (~hit["valid"] | (ah["t"] < hit["t"])), dict(
            anim_interaction(scene, ah, time), t=ah["t"], light=no_light,
            prim=offset + scene.n_proto_tris + ah["tri"]))
    valid = hit["valid"]
    return Interaction(valid, hit["t"], hit["p"], hit["p_err"], hit["ng"], hit["ns"], hit["uv"],
                       -vm.normalize(d), torch.where(valid, hit["mat"], 0),
                       torch.where(valid, hit["light"], -1), torch.where(valid, hit["prim"], -1),
                       hit["dpdu"])


# recasts of a masked hit at most; a lane masked after them is a miss
MAX_ALPHA_RECASTS = 16


def alpha_masked(scene: sa.Scene, it: Interaction, shadow: bool) -> torch.Tensor:
    """Lanes whose triangle hit has its alpha mask (and, for shadow rays,
    its shadow-alpha mask) 0 at the hit's uv (triangle.rs:313-327,
    :593-650): one T1 launch for the masks the test reads."""
    is_tri = it.valid & (it.prim >= 0) & (it.prim < scene.n_tris)
    at = scene.tri_attr[torch.clamp(it.prim, 0, max(scene.n_tris - 1, 0)).long()]
    cols = [sa.TA_ALPHA, sa.TA_SALPHA] if shadow else [sa.TA_ALPHA]
    tid = torch.round(at[:, cols]).to(torch.int32).t()  # (masks, N)
    with torch.no_grad():  # the test is discrete
        a = tk.texture_eval(tx.tables_of(scene), tid, it.uv, it.p)[..., 0]
    return is_tri & ((tid >= 0) & (a == 0.0)).any(0)


def alpha_recast_loop(scene: sa.Scene, o, d, t_max, accel, it: Interaction, shadow: bool,
                      stats: Optional[dict] = None, time=None) -> Interaction:
    """Casts the masked lanes again from just past their hit until they
    find a hit that stays or escape, MAX_ALPHA_RECASTS times at most
    (the JAX _alpha_recast_loop, scene_intersect.py:334-383; the reference
    skips a masked hit inside its traversal).  The loop's condition is read
    on the host; only the masked lanes are cast, each at its time (time,
    or 0 where None).  A lane still masked at the end is a miss.  stats, when given, gains the trips (``alpha_trips``)
    and the lanes still masked (``alpha_left``)."""
    o_cur, t_rem = o, t_max
    t_base = torch.zeros_like(t_max)
    trips = 0
    masked = alpha_masked(scene, it, shadow)
    while trips < MAX_ALPHA_RECASTS and bool(masked.any()):
        idx = torch.nonzero(masked).flatten()
        d_m = d[idx]
        # t is the total length; the current segment's is t - t_base
        t_seg = it.t[idx] - t_base[idx]
        t_eps = t_seg + torch.clamp(1e-4 * t_seg.abs(), min=1e-5)
        o_new = o_cur[idx] + d_m * t_eps[:, None]
        base_new = t_base[idx] + t_eps
        rem_new = torch.clamp(t_rem[idx] - t_eps, min=0.0)
        it2 = _scene_intersect_once(scene, o_new, d_m, rem_new, accel,
                                    None if time is None else time[idx])
        it2 = it2._replace(t=it2.t + base_new)
        it = Interaction(*(a.index_copy(0, idx, b) for a, b in zip(it, it2)))
        o_cur = o_cur.index_copy(0, idx, o_new)
        t_base = t_base.index_copy(0, idx, base_new)
        t_rem = t_rem.index_copy(0, idx, rem_new)
        trips += 1
        masked = alpha_masked(scene, it, shadow)
    if stats is not None:
        stats["alpha_trips"] = stats.get("alpha_trips", 0) + trips
        stats["alpha_left"] = stats.get("alpha_left", 0) + int(masked.sum())
    return it._replace(valid=it.valid & ~masked)


def scene_intersect(scene: sa.Scene, o, d, t_max, accel: Optional[Accel] = None,
                    time=None) -> Interaction:
    """Closest hit of rays o, d (N, 3) within t_max (N,) at times time (N,)
    (None: 0; only animated meshes read it) (the JAX scene_intersect):
    _scene_intersect_once, then, where triangles carry alpha masks,
    alpha_recast_loop."""
    check_supported(scene, accel)
    it = _scene_intersect_once(scene, o, d, t_max, accel, time)
    if scene.has_alpha:
        it = alpha_recast_loop(scene, o, d, t_max, accel, it, shadow=False, time=time)
    return it


@torch.no_grad()  # the occlusion bit is discrete: no gradient reaches the rays
def scene_intersect_p(scene: sa.Scene, o, d, t_max, accel: Optional[Accel] = None,
                      time=None) -> torch.Tensor:
    """Any hit (shadow ray) within t_max: triangles through K4, or B2 (D2)
    where the scene has its BVH (kd-tree), then the spheres, then the
    curves (C2 through their tree, else C4), then the instances (I2) and
    the animated meshes at time (V1's any hit).  Where triangles carry
    alpha masks a masked hit must not occlude: the closest hit and
    alpha_recast_loop with both masks (the JAX scene_intersect_p)."""
    check_supported(scene, accel)
    if scene.has_alpha:
        it = _scene_intersect_once(scene, o, d, t_max, accel, time)
        return alpha_recast_loop(scene, o, d, t_max, accel, it, shadow=True, time=time).valid
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if uses_bvh(scene, accel):
        occ = occ | bvh.bvh12_intersect_tris(o, d, t_max, accel.tri, accel.tri_depth,
                                             any_hit=True)
    elif uses_kd(scene, accel):
        occ = occ | kdk.kd_intersect(o.contiguous(), d.contiguous(), t_max.contiguous(),
                                     accel.kd, accel.kd_tris, any_hit=True)
    elif scene.n_tris > 0:
        occ = occ | dense_tri_hit_p(scene, o, d, t_max)
    if scene.n_spheres > 0:
        occ = occ | sphere_hits(scene, o, d, t_max)[0]
    if scene.n_curve_segs > 0:
        if uses_curve_bvh(scene, accel):
            occ = occ | ck.walk_any(o, d, t_max, accel.crv, scene.crv_attr)
        else:
            occ = occ | ck.sweep_any(o, d, t_max, scene.crv_attr)
    if scene.n_instances > 0:
        occ = occ | instance_hit(scene, o, d, t_max, accel, any_hit=True)
    if scene.n_anim_tris > 0:
        occ = occ | anim_hits(scene, o, d, t_max, time, any_hit=True)
    return occ
