"""I1, I2: the two-level instance walk as CUDA kernels (closest hit, any hit).

The wrapper of ``csrc/instance.cu``, which replaces the JAX package's XLA
loops ``rs_pbrt_tpu/ops/instancing.py:256`` ``instance_intersect``
(``_collect_candidates`` and ``_inner_traverse``).  ``instance_intersect``
launches I1 (closest hit -> ``instancing.InstanceHit``) or I2 (any hit ->
(N,) bool) for CUDA tensors and runs the plain version,
``instancing.instance_intersect_plain``, for CPU ones; it never falls back.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .autodiff import refuse_grad
from .instancing import InstanceAccel, InstanceHit, instance_intersect_plain

launches = {"closest": 0, "any": 0}  # kernel launches; the plain version does not count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, top_box, top_child, top_prim, in_box, in_child, w2o, root, tris,
    # [t, tri, inst, b0, b1 | occ], stream
    "rs_instance_closest": [_P, _P, _P, _I] + [_P] * 8 + [_P] * 5 + [_P],
    "rs_instance_any": [_P, _P, _P, _I] + [_P] * 8 + [_P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("instance"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"instance_intersect: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"instance_intersect: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def check_accel(acc: InstanceAccel):
    """Raises unless the accel's tensors are what the kernels read."""
    n_top, n_in, n_inst = acc.top_box.shape[0], acc.inner_box.shape[0], acc.w2o.shape[0]
    _check("top_box", acc.top_box, torch.float32, (n_top, 12))
    _check("top_child", acc.top_child, torch.int32, (n_top, 2))
    _check("top_prim", acc.top_prim, torch.int32, (acc.top_prim.shape[0],))
    _check("inner_box", acc.inner_box, torch.float32, (n_in, 12))
    _check("inner_child", acc.inner_child, torch.int32, (n_in, 2))
    _check("w2o", acc.w2o, torch.float32, (n_inst, 4, 4))
    _check("root", acc.root, torch.int32, (n_inst,))
    _check("tris", acc.tris, torch.float32, (acc.tris.shape[0], 9))
    if n_top < 1 or n_in < 1 or n_inst < 1:
        raise ValueError("instance_intersect: the accel has an empty tree")


def instance_intersect(o, d, t_max, acc: InstanceAccel, any_hit: bool = False):
    """I1 (closest hit -> InstanceHit) or I2 (any_hit -> (N,) bool
    occlusion) of rays o, d (N, 3) within t_max (N,) for CUDA tensors;
    instance_intersect_plain for CPU ones."""
    if not any_hit:
        refuse_grad("instance_intersect (I1)", o, d, t_max)
    if o.device.type == "cpu":
        return instance_intersect_plain(o, d, t_max, acc, any_hit)
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    check_accel(acc)
    if n >= 1 << 31:
        raise ValueError("instance_intersect: at most 2^31 - 1 rays per launch")
    trees = [acc.top_box, acc.top_child, acc.top_prim, acc.inner_box, acc.inner_child, acc.w2o,
             acc.root, acc.tris]
    ptrs = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n] + [t.data_ptr() for t in trees]
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with torch.cuda.device(o.device):
        if any_hit:
            occ = torch.empty(n, dtype=torch.bool, device=o.device)
            err = _kernel("rs_instance_any")(*ptrs, occ.data_ptr(), stream)
            _build.check(err, "instance any-hit kernel launch")
            launches["any"] += 1
            return occ
        t = torch.empty_like(t_max)
        tri = torch.empty(n, dtype=torch.int32, device=o.device)
        inst = torch.empty(n, dtype=torch.int32, device=o.device)
        b0 = torch.empty_like(t_max)
        b1 = torch.empty_like(t_max)
        err = _kernel("rs_instance_closest")(*ptrs, t.data_ptr(), tri.data_ptr(),
                                             inst.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                                             stream)
    _build.check(err, "instance closest-hit kernel launch")
    launches["closest"] += 1
    return InstanceHit(tri >= 0, t, tri, inst, b0, b1)
