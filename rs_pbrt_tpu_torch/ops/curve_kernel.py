"""C1-C4: the curve intersection kernels' wrappers.

The port of the JAX package's XLA curve intersection (ops/curves.py
``bvh_intersect_curves`` and ``intersect_curves_brute``).  Each wrapper
launches its CUDA kernel (``csrc/curves.cu``, the leaf test in
``csrc/curve.cuh``) for CUDA tensors and runs its plain version
(``ops/curves.py``) for CPU tensors:

- C1 ``walk_closest``: the closest hit through the curves' binary tree;
- C2 ``walk_any``: the same tree's any hit (shadow rays);
- C3 ``sweep_closest``: the closest hit over every segment (up to
  ``scene_intersect.BRUTE_FORCE_MAX_CURVES`` rows);
- C4 ``sweep_any``: the sweep's any hit.

The closest hits return ``curves.CurveHit`` (seg 0 where nothing is hit,
as the JAX functions report it), the any hits (N,) bool.  The walk's
stack clamps at ``curves.STACK_DEPTH`` entries, as the JAX walk's does;
the kernels count the pushes it overwrote in ``clamp_counter(device)``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..device import resolve
from ..scene.arrays import N_CURVE_ATTR
from . import _build
from .autodiff import refuse_grad
from . import curves as cv

# kernel launches of each wrapper; the plain versions do not count
launches = {"curve_walk_closest": 0, "curve_walk_any": 0, "curve_sweep_closest": 0,
            "curve_sweep_any": 0}
_clamped = {}  # per device: a (1,) int32 count of the pushes the walk's stack clamp overwrote

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, child, box, prim, rows, any_hit, t, seg, w, u, v, occ, clamped, stream
    "rs_curve_walk": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # o, d, tmax, n, rows, n_segs, any_hit, t, seg, w, u, v, occ, stream
    "rs_curve_sweep": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("curves"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def clamp_counter(device) -> torch.Tensor:
    """The (1,) int32 count of the walk's pushes onto a full stack on
    `device` since it was last zeroed (``.zero_()``)."""
    dev = resolve(device)  # "cuda" and "cuda:0" name one counter
    if dev not in _clamped:
        _clamped[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _clamped[dev]


def _check(what, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def _check_rays(what, o, d, t_max, rows):
    n = o.shape[0]
    _check(what, "o", o, torch.float32, (n, 3))
    _check(what, "d", d, torch.float32, (n, 3))
    _check(what, "t_max", t_max, torch.float32, (n,))
    _check(what, "rows", rows, torch.float32, (rows.shape[0], N_CURVE_ATTR))
    if not 0 < rows.shape[0] < (1 << 31) // N_CURVE_ATTR:
        raise ValueError(f"{what}: {rows.shape[0]} segment rows")
    if n >= 1 << 31:
        raise ValueError(f"{what}: at most 2^31 - 1 rays per launch")
    return n


def _outputs(t_max, any_hit):
    n, dev = t_max.shape[0], t_max.device
    if any_hit:
        return dict(occ=torch.empty(n, dtype=torch.bool, device=dev))
    return dict(t=torch.empty_like(t_max), seg=torch.empty(n, dtype=torch.int32, device=dev),
                w=torch.empty_like(t_max), u=torch.empty_like(t_max), v=torch.empty_like(t_max))


def _ptrs(out, any_hit):
    if any_hit:
        return [None] * 5 + [out["occ"].data_ptr()]
    return [out[k].data_ptr() for k in ("t", "seg", "w", "u", "v")] + [None]


def _result(out, any_hit):
    if any_hit:
        return out["occ"]
    seg = out["seg"]
    return cv.CurveHit(seg >= 0, out["t"], torch.clamp(seg, min=0), out["w"], out["u"], out["v"])


def _walk(o, d, t_max, tree: cv.CurveBVH, rows, any_hit: bool):
    what = "curve walk"
    n = _check_rays(what, o, d, t_max, rows)
    s = tree.prim.shape[0]
    _check(what, "tree.child", tree.child, torch.int32, (max(s - 1, 1), 2))
    _check(what, "tree.box", tree.box, torch.float32, (max(s - 1, 1), 12))
    _check(what, "tree.prim", tree.prim, torch.int32, (s,))
    out = _outputs(t_max, any_hit)
    with torch.cuda.device(o.device):
        err = _kernel("rs_curve_walk")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, tree.child.data_ptr(),
            tree.box.data_ptr(), tree.prim.data_ptr(), rows.data_ptr(), int(any_hit),
            *_ptrs(out, any_hit), clamp_counter(o.device).data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "curve walk kernel launch")
    launches["curve_walk_any" if any_hit else "curve_walk_closest"] += 1
    return _result(out, any_hit)


def _sweep(o, d, t_max, rows, any_hit: bool):
    what = "curve sweep"
    n = _check_rays(what, o, d, t_max, rows)
    out = _outputs(t_max, any_hit)
    with torch.cuda.device(o.device):
        err = _kernel("rs_curve_sweep")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, rows.data_ptr(), rows.shape[0],
            int(any_hit), *_ptrs(out, any_hit), torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "curve sweep kernel launch")
    launches["curve_sweep_any" if any_hit else "curve_sweep_closest"] += 1
    return _result(out, any_hit)


def walk_closest(o, d, t_max, tree: cv.CurveBVH, rows) -> cv.CurveHit:
    """C1: the closest hit of rays o, d (N, 3) within t_max (N,) over
    segment rows (S, 26) through their tree."""
    refuse_grad("walk_closest (C1)", o, d, t_max, rows)
    if o.device.type == "cpu":
        return cv.bvh_intersect_curves_plain(o, d, t_max, tree, rows)
    return _walk(o, d, t_max, tree, rows, False)


def walk_any(o, d, t_max, tree: cv.CurveBVH, rows) -> torch.Tensor:
    """C2: whether any segment lies on each ray within t_max, through the
    tree."""
    if o.device.type == "cpu":
        return cv.bvh_intersect_curves_plain(o, d, t_max, tree, rows, any_hit=True)
    return _walk(o, d, t_max, tree, rows, True)


def sweep_closest(o, d, t_max, rows) -> cv.CurveHit:
    """C3: the closest hit over every segment row."""
    refuse_grad("sweep_closest (C3)", o, d, t_max, rows)
    if o.device.type == "cpu":
        return cv.intersect_curves_plain(o, d, t_max, rows)
    return _sweep(o, d, t_max, rows, False)


def sweep_any(o, d, t_max, rows) -> torch.Tensor:
    """C4: whether any segment row lies on each ray within t_max."""
    if o.device.type == "cpu":
        return cv.intersect_curves_plain(o, d, t_max, rows, any_hit=True)
    return _sweep(o, d, t_max, rows, True)
