"""D1, D2: the kd-tree walk as CUDA kernels (closest hit, any hit).

The wrapper of ``csrc/kdtree.cu``, which replaces the JAX package's XLA
loop ``rs_pbrt_tpu/ops/kdtree.py:174`` ``kdtree_intersect_tris``.
``kd_intersect`` launches D1 (closest hit -> TriHit) or D2 (any hit ->
(N,) bool) for CUDA tensors and runs the plain version,
``kdtree.kdtree_intersect_plain``, for CPU ones; it never falls back.
``overflow_counter(device)`` holds the far children the kernels' full
stacks overwrote since it was last zeroed, as ``bvh.overflow_counter``
does for B1 and B2.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..device import resolve
from . import _build
from .autodiff import refuse_grad
from .intersect import TriHit
from .kdtree import KdTree, kdtree_intersect_plain

launches = {"closest": 0, "any": 0}  # kernel launches; the plain version does not count
_overflow = {}  # per device: a (1,) int32 count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, axis, split, above, start, count, prim_ids, n_prims, world, tris,
    # [t, tri, b0, b1 | occ], overflow, stream
    "rs_kd_closest": [_P, _P, _P, _I] + [_P] * 6 + [_I, _P, _P] + [_P] * 4 + [_P, _P],
    "rs_kd_any": [_P, _P, _P, _I] + [_P] * 6 + [_I, _P, _P] + [_P, _P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("kdtree"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def overflow_counter(device) -> torch.Tensor:
    """The (1,) int32 count of stack entries the kernels dropped on
    `device` since it was last zeroed (``.zero_()``)."""
    dev = resolve(device)
    if dev not in _overflow:
        _overflow[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _overflow[dev]


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"kd_intersect: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"kd_intersect: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def kd_intersect(o, d, t_max, kt: KdTree, tris, any_hit: bool = False):
    """D1 (closest hit -> TriHit) or D2 (any_hit -> (N,) bool occlusion)
    of rays o, d (N, 3) within t_max (N,) over triangles tris (T, 9) f32
    for CUDA tensors; kdtree_intersect_plain for CPU ones."""
    if not any_hit:
        refuse_grad("kd_intersect (D1; the differentiable hit is scene_intersect.tri_hit)",
                    o, d, t_max, tris)
    if o.device.type == "cpu":
        hit = kdtree_intersect_plain(o, d, t_max, kt, tris, any_hit)
        return hit.valid if any_hit else hit
    n, m = o.shape[0], kt.axis.shape[0]
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    _check("tris", tris, torch.float32, (tris.shape[0], 9))
    for name, dt in (("axis", torch.int32), ("split", torch.float32), ("above", torch.int32),
                     ("start", torch.int32), ("count", torch.int32)):
        _check(name, getattr(kt, name), dt, (m,))
    _check("prim_ids", kt.prim_ids, torch.int32, (kt.prim_ids.shape[0],))
    _check("world", kt.world, torch.float32, (6,))
    if n >= 1 << 31:
        raise ValueError("kd_intersect: at most 2^31 - 1 rays per launch")
    ovf = overflow_counter(o.device)
    args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, kt.axis.data_ptr(),
            kt.split.data_ptr(), kt.above.data_ptr(), kt.start.data_ptr(), kt.count.data_ptr(),
            kt.prim_ids.data_ptr(), kt.prim_ids.shape[0], kt.world.data_ptr(), tris.data_ptr()]
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with torch.cuda.device(o.device):
        if any_hit:
            occ = torch.empty(n, dtype=torch.bool, device=o.device)
            err = _kernel("rs_kd_any")(*args, occ.data_ptr(), ovf.data_ptr(), stream)
            _build.check(err, "kd-tree any-hit kernel launch")
            launches["any"] += 1
            return occ
        t = torch.empty_like(t_max)
        tri = torch.empty(n, dtype=torch.int32, device=o.device)
        b0 = torch.empty_like(t_max)
        b1 = torch.empty_like(t_max)
        err = _kernel("rs_kd_closest")(*args, t.data_ptr(), tri.data_ptr(), b0.data_ptr(),
                                       b1.data_ptr(), ovf.data_ptr(), stream)
    _build.check(err, "kd-tree closest-hit kernel launch")
    launches["closest"] += 1
    return TriHit(tri >= 0, t, tri, b0, b1)
