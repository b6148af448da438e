"""V1: the moving-mesh sweep as a CUDA kernel, and its plain version.

``anim_hits`` is the port of the JAX package's XLA function
``rs_pbrt_tpu/ops/scene_intersect.py:467`` ``_anim_hits`` (reference
primitive.rs:236-265, TransformedPrimitive::intersect with an
AnimatedTransform): for each ray and each animated mesh (a group), the
group's transform interpolated at the ray's time (``utils/animated``), its
inverse, and the ray carried into the group's object space (its direction
unnormalized, so object t is world t); then every triangle of every group
tested against the ray's own t_max, the nearest hit kept, the first
triangle among equal t.  For CUDA tensors it launches ``csrc/motion.cu``
(closest hit, or with any_hit the occlusion, each ray stopping at its
first hit); for CPU tensors it runs ``anim_hits_plain``, term by term the
kernel's arithmetic.  It never falls back.

The JAX form builds (N, A, 3) object-space rays through a one-hot einsum;
the plain version tests one group's triangles against a block of rays at
a time (``PLAIN_BLOCK`` tests a block), so 4.19M rays against 1,280
triangles fit in memory.  A hit whose t is NaN is not kept (jnp.min would
keep it and void the lane).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from ..scene import arrays as sa
from ..utils import animated as an
from ..utils import transform as tr
from . import _build
from .autodiff import refuse_grad
from .bvh import ray_shear, tri_test_soa

launches = {"closest": 0, "any": 0}  # kernel launches; the plain version does not count
PLAIN_BLOCK = 1 << 24  # ray-triangle tests a block of the plain version


def anim_hits_plain(o, d, t_max, time, scene: sa.Scene, any_hit: bool = False,
                    work: Optional[dict] = None):
    """Closest hit of rays o, d (N, 3) within t_max (N,) at times time (N,)
    (None: 0) over scene's animated meshes -> dict(valid, t (t_max where
    none), tri (N,) int32 row of anim_attr, grp (N,) int32 its group, b0,
    b1), zeros where none; any_hit: the (N,) bool occlusion.  Rays with
    t_max < 0 or NaN can hit nothing and are skipped.  work, when given,
    gains the rays tested ("rays"), the groups' set-ups (an interpolation
    and an inverse a ray and group, "setups") and the ray-triangle tests
    ("tests"); for any_hit, those a walk that stops at each ray's first hit
    (in group and triangle order) needs."""
    n, dev = o.shape[0], o.device
    inf = float("inf")
    best_t = torch.full((n,), inf, device=dev)
    best_i = torch.zeros(n, dtype=torch.int64, device=dev)
    best_g = torch.zeros(n, dtype=torch.int64, device=dev)
    best_b0 = torch.zeros(n, device=dev)
    best_b1 = torch.zeros(n, device=dev)
    live = torch.nonzero(t_max >= 0.0)[:, 0]
    t_lane = (torch.zeros(live.shape[0], device=dev) if time is None else time[live])
    ranges = scene.anim_range.cpu().tolist()
    tests = setups = 0
    done = torch.zeros(n, dtype=torch.bool, device=dev)  # any_hit: a first hit found
    for g, (a, b) in enumerate(ranges):
        if b <= a or not live.numel():
            continue
        setups += int((~done[live]).sum())
        mi = an.inverse_affine(an.interpolate(t_lane, *an.xf_parts(scene.anim_xf[g])))
        o_obj = tr.xform_point(mi, o[live])
        d_obj = tr.xform_vector(mi, d[live])
        shear = tuple(s[:, None] for s in ray_shear(o_obj, d_obj))
        v = scene.anim_attr[a:b, sa.TA_P0:sa.TA_P0 + 9]
        cols = [v[None, :, c] for c in range(9)]
        step = max(1, PLAIN_BLOCK // (b - a))
        for s in range(0, live.shape[0], step):
            r = slice(s, s + step)
            lanes = live[r]
            hit, t, b0, b1 = tri_test_soa(o_obj[r], t_max[lanes, None], tuple(x[r] for x in shear),
                                          *cols)
            if any_hit:
                first = hit & (t < t_max[lanes, None])
                found = first.any(1)
                upto = torch.where(found, first.int().argmax(1) + 1, b - a)
                tests += int(upto[~done[lanes]].sum())
                done[lanes] |= found
            else:
                tests += hit.numel()
            t_m = torch.where(hit & ~torch.isnan(t), t, inf)
            t_new, bi = torch.min(t_m, dim=1)
            upd = t_new < best_t[lanes]
            u = lanes[upd]
            best_t[u] = t_new[upd]
            best_i[u] = a + bi[upd]
            best_g[u] = g
            best_b0[u] = b0.gather(1, bi[:, None])[:, 0][upd]
            best_b1[u] = b1.gather(1, bi[:, None])[:, 0][upd]
    valid = best_t < t_max
    if work is not None:
        work.update(rays=int(live.numel()), setups=setups, tests=tests)
    if any_hit:
        return valid
    z = torch.zeros_like(best_t)
    return dict(valid=valid, t=torch.where(valid, best_t, t_max),
                tri=torch.where(valid, best_i, 0).to(torch.int32),
                grp=torch.where(valid, best_g, 0).to(torch.int32),
                b0=torch.where(valid, best_b0, z), b1=torch.where(valid, best_b1, z))


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, time, n, xf, range, groups, tris, cols, [valid, t, tri, grp, b0, b1 | occ],
    # stream
    "rs_motion_closest": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I] + [_P] * 6 + [_P],
    "rs_motion_any": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("motion"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"anim_hits: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"anim_hits: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def anim_hits(o, d, t_max, time, scene: sa.Scene, any_hit: bool = False):
    """V1 for CUDA tensors (closest hit -> dict as anim_hits_plain's, or
    any_hit -> (N,) bool); anim_hits_plain for CPU ones."""
    if not any_hit:
        refuse_grad("anim_hits (V1; the differentiable hit is scene_intersect.anim_hits)", o, d,
                    t_max, time, scene.anim_attr, scene.anim_xf)
    if o.device.type == "cpu":
        return anim_hits_plain(o, d, t_max, time, scene, any_hit)
    n, g = o.shape[0], scene.anim_xf.shape[0]
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    if time is not None:
        _check("time", time, torch.float32, (n,))
    _check("anim_xf", scene.anim_xf, torch.float32, (g, 32))
    _check("anim_range", scene.anim_range, torch.int32, (g, 2))
    _check("anim_attr", scene.anim_attr, torch.float32, (scene.anim_attr.shape[0], sa.N_TRI_ATTR))
    if scene.anim_attr.shape[0] < scene.n_anim_tris:
        raise ValueError("anim_hits: anim_attr holds fewer rows than the groups name")
    if n >= 1 << 31:
        raise ValueError("anim_hits: at most 2^31 - 1 rays per launch")
    args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            None if time is None else time.data_ptr(), n, scene.anim_xf.data_ptr(),
            scene.anim_range.data_ptr(), g, scene.anim_attr.data_ptr(), sa.N_TRI_ATTR]
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with torch.cuda.device(o.device):
        if any_hit:
            occ = torch.empty(n, dtype=torch.bool, device=o.device)
            err = _kernel("rs_motion_any")(*args, occ.data_ptr(), stream)
            _build.check(err, "moving-mesh any-hit kernel launch")
            launches["any"] += 1
            return occ
        valid = torch.empty(n, dtype=torch.bool, device=o.device)
        t = torch.empty_like(t_max)
        tri = torch.empty(n, dtype=torch.int32, device=o.device)
        grp = torch.empty(n, dtype=torch.int32, device=o.device)
        b0 = torch.empty_like(t_max)
        b1 = torch.empty_like(t_max)
        err = _kernel("rs_motion_closest")(*args, valid.data_ptr(), t.data_ptr(), tri.data_ptr(),
                                           grp.data_ptr(), b0.data_ptr(), b1.data_ptr(), stream)
    _build.check(err, "moving-mesh closest-hit kernel launch")
    launches["closest"] += 1
    return dict(valid=valid, t=t, tri=tri, grp=grp, b0=b0, b1=b1)
