"""B1, B2: ordered traversal of the 12-wide BVH (closest hit, any hit).

The port of the JAX package's wide12 traversal, ``ops/bvh.py``
``bvh12_intersect_tris`` -> ``_bvhw_intersect_tris`` and ``_tri_test_soa``
(reference bvh.rs:401-514 stack machine, triangle.rs:154-449 watertight
test), over the rows of ``csrc/lbvh.cpp``'s ``rs_wide12_build``
(``ops/bvh_native.py``).  ``bvh12_intersect_tris`` launches the CUDA kernel
(``csrc/bvh12.cu``: B1 closest hit and B2 any hit, each ray walked by a
group of 16 lanes) for CUDA tensors and runs ``bvh12_intersect_plain`` for
CPU tensors.

The walk, the same in the kernels and the plain version, step by step as
the JAX loop: each step visits one row.  When the current group has no
pending child bit, pop a (base, mask) pair from the stack; visit the
lowest pending bit's row.  An internal row tests its 12 child boxes
(slabs widened by eps = 1 + 2 gamma(3)), masked to the row's child count;
on a hit, descend into the nearest child (the lowest slot among equal
entry distances), pushing first the rest of the current group (resume),
then the other hit children (defer).  A leaf row tests its 12 triangles
and takes the nearest hit only when it is strictly nearer than the best so
far.  The order decides which of two triangles at equal t wins, so it is
followed exactly.  The stack holds K = max(2 depth + 4, 8) entries; a push
onto a full stack drops the bottom entry as the JAX roll stack does, and
is counted (``overflows``), so a run can show that none was lost.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..utils import vecmath as vm
from . import _build
from .autodiff import refuse_grad
from .intersect import TriHit

W12 = 12
W12_COLS = 128
# wide12 row layout (csrc/lbvh.cpp): internal rows hold 12 child boxes as
# bmin_x, bmin_y, bmin_z, bmax_x, bmax_y, bmax_z blocks of 12, the child
# group's base row and the child count; leaf rows hold 12 triangles as
# p0x, p0y, p0z, p1x, ..., p2z blocks of 12 and their primitive ids
_W12_BASE = 72
_W12_COUNT = 73
_W12_PRIM = 108
_W12_FLAG = 127  # 0 internal, 1 leaf

GAMMA2 = float(vm.gamma(2.0))
GAMMA3 = float(vm.gamma(3.0))
GAMMA5 = float(vm.gamma(5.0))
SLAB_EPS = float(np.float32(1.0 + 2.0 * vm.gamma(3.0)))
# the stack entries K a ray may have: the kernels' block of 8 groups keeps
# 8 K-entry stacks of 8-byte entries in the 48 KB of shared memory a kernel
# has without opting in
MAX_STACK = 48 * 1024 // (8 * 8)

# kernel launches of each wrapper; the plain versions do not count
launches = {"closest": 0, "any": 0}
_overflow = {}  # per device: a (1,) int32 count of stack entries dropped by the kernels


def stack_size(depth: int) -> int:
    """The traversal stack's entries for a wide tree of `depth` (JAX :1039)."""
    return max(2 * depth + 4, 8)


def ray_shear(o, d):
    """Per-ray permutation and shear (triangle.rs:154-192): (kx, ky, kz) the
    axes, kz the largest |d| (the first on ties), and (sx, sy, sz)."""
    kz = torch.argmax(d.abs(), dim=-1)
    kx = torch.where(kz + 1 == 3, 0, kz + 1)
    ky = torch.where(kx + 1 == 3, 0, kx + 1)
    comp = lambda k: d.gather(-1, k[:, None])[:, 0]
    inv_dz = 1.0 / comp(kz)
    return kx, ky, kz, -comp(kx) * inv_dz, -comp(ky) * inv_dz, inv_dz


def tri_test_soa(o, t_max, shear, X0, Y0, Z0, X1, Y1, Z1, X2, Y2, Z2, scaled: bool = False):
    """Watertight test of each lane's ray against K triangles given as
    component slices (lanes, K) (ops/bvh.py:_tri_test_soa): the vertices
    relative to the origin, permuted and sheared, the edge functions, det,
    the scaled t and its conservative error bound (triangle.rs:421-449).
    o (lanes, 3), t_max (lanes, 1), shear = ray_shear columns as (lanes, 1).
    Returns (hit, t, b0, b1), each (lanes, K); scaled: (hit, t, b0, b1,
    t_scaled, det), so that a caller that tested with t_max = inf can apply
    a smaller t_lim's range test, the only term t_max enters
    (range_hit)."""
    kx, ky, kz, sx, sy, sz = shear
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]

    def perm(k, ax, ay, az):
        return torch.where(k == 0, ax, torch.where(k == 1, ay, az))

    def permuted(X, Y, Z):
        px, py, pz = X - ox, Y - oy, Z - oz
        return perm(kx, px, py, pz), perm(ky, px, py, pz), perm(kz, px, py, pz)

    x0, y0, z0 = permuted(X0, Y0, Z0)
    x1, y1, z1 = permuted(X1, Y1, Z1)
    x2, y2, z2 = permuted(X2, Y2, Z2)
    x0 = x0 + sx * z0
    y0 = y0 + sy * z0
    x1 = x1 + sx * z1
    y1 = y1 + sy * z1
    x2 = x2 + sx * z2
    y2 = y2 + sy * z2

    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    miss_sign = neg & pos
    det = e0 + e1 + e2
    miss_det = det == 0.0

    z0s = sz * z0
    z1s = sz * z1
    z2s = sz * z2
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    miss_range = torch.where(det < 0.0, (t_scaled >= 0.0) | (t_scaled < t_max * det),
                             (t_scaled <= 0.0) | (t_scaled > t_max * det))

    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    t = t_scaled * inv_det

    max_zt = torch.maximum(torch.maximum(z0s.abs(), z1s.abs()), z2s.abs())
    delta_z = GAMMA3 * max_zt
    max_xt = torch.maximum(torch.maximum(x0.abs(), x1.abs()), x2.abs())
    max_yt = torch.maximum(torch.maximum(y0.abs(), y1.abs()), y2.abs())
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = torch.maximum(torch.maximum(e0.abs(), e1.abs()), e2.abs())
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * inv_det.abs()
    miss_eps = t <= delta_t

    hit = ~(miss_sign | miss_det | miss_range | miss_eps)
    return (hit, t, b0, b1, t_scaled, det) if scaled else (hit, t, b0, b1)


def range_hit(hit_inf, t_scaled, det, t_lim):
    """tri_test_soa's hit at t_lim from its hit at t_max = inf: the range
    test's upper end, t_scaled against t_lim det, term for term."""
    return hit_inf & ~torch.where(det < 0.0, t_scaled < t_lim * det, t_scaled > t_lim * det)


def _round_i32(x):
    return torch.round(x).to(torch.int32)


def bvh12_intersect_plain(o, d, t_max, rows, depth: int, any_hit: bool = False,
                          work: Optional[dict] = None) -> TriHit:
    """Traversal of rays o, d (N, 3), t_max (N,) over wide12 rows (M, 128)
    of a tree of `depth` -> TriHit (valid, t (t_max on a miss), tri, b0, b1).
    any_hit: stop each ray at its first hit (B2; its tri is that hit's).

    Lanes whose walk has ended, and lanes with t_max < 0 (dead paths, which
    can hit nothing), leave the wavefront, so each step runs the live lanes
    only; that changes no result.  work, when given, is filled with the
    per-ray counts of internal and leaf rows visited ("internal", "leaf",
    (N,) int64), the number of distinct rows visited ("rows"), and the
    stack entries dropped on overflow ("overflow")."""
    n, dev = o.shape[0], o.device
    K = stack_size(depth)
    bits = torch.bitwise_left_shift(torch.ones(W12, dtype=torch.int32, device=dev),
                                    torch.arange(W12, dtype=torch.int32, device=dev))
    full = (1 << W12) - 1
    slot = torch.arange(W12, device=dev)
    inf = float("inf")

    out_t = t_max.clone()
    out_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_b0 = torch.zeros(n, dtype=torch.float32, device=dev)
    out_b1 = torch.zeros(n, dtype=torch.float32, device=dev)
    n_int = torch.zeros(n, dtype=torch.int64, device=dev)
    n_leaf = torch.zeros(n, dtype=torch.int64, device=dev)
    touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    # the live wavefront: lane ids and their state
    lane = torch.nonzero(t_max >= 0.0)[:, 0]
    lo, ld = o[lane], d[lane]
    inv_d = 1.0 / torch.where(ld == 0.0, 1e-20, ld)
    shear = tuple(s[:, None] for s in ray_shear(lo, ld))
    best_t = t_max[lane].clone()
    best_tri = torch.full_like(lane, -1, dtype=torch.int32)
    best_b0 = torch.zeros_like(best_t)
    best_b1 = torch.zeros_like(best_t)
    cur_b = torch.zeros_like(best_tri)
    cur_m = torch.ones_like(best_tri)  # base 0, mask {bit 0}: the root row
    # ring stack: top index and entry count per lane
    stk_b = torch.zeros((lane.shape[0], K), dtype=torch.int32, device=dev)
    stk_m = torch.zeros_like(stk_b)
    top = torch.zeros_like(lane)
    cnt = torch.zeros_like(lane)

    def push(sel, b, m):
        nonlocal top, cnt, overflow, stk_b, stk_m
        new_top = torch.where(sel, (top + 1) % K, top)
        at = new_top[:, None]
        stk_b = torch.where(sel[:, None] & (slot_k == at), b[:, None], stk_b)
        stk_m = torch.where(sel[:, None] & (slot_k == at), m[:, None], stk_m)
        overflow = overflow + (sel & (cnt == K)).sum()
        cnt = torch.where(sel, torch.clamp(cnt + 1, max=K), cnt)
        top = new_top

    slot_k = torch.arange(K, device=dev)[None, :]
    while lane.numel():
        live = (cur_m != 0) | (cnt > 0)
        if any_hit:
            live &= best_tri < 0
        if not bool(live.all()):
            done = ~live
            ids = lane[done]
            out_t[ids], out_tri[ids] = best_t[done], best_tri[done]
            out_b0[ids], out_b1[ids] = best_b0[done], best_b1[done]
            lane, lo, ld, inv_d = lane[live], lo[live], ld[live], inv_d[live]
            shear = tuple(s[live] for s in shear)
            best_t, best_tri, best_b0, best_b1 = (best_t[live], best_tri[live], best_b0[live],
                                                  best_b1[live])
            cur_b, cur_m, stk_b, stk_m = cur_b[live], cur_m[live], stk_b[live], stk_m[live]
            top, cnt = top[live], cnt[live]
            if not lane.numel():
                break
        # pop where the current group has no pending bit
        need = cur_m == 0
        pb = stk_b.gather(1, top[:, None])[:, 0]
        pm = stk_m.gather(1, top[:, None])[:, 0]
        cur_b = torch.where(need, pb, cur_b)
        cur_m = torch.where(need, pm, cur_m)
        top = torch.where(need, (top - 1) % K, top)
        cnt = torch.where(need, cnt - 1, cnt)
        # visit the lowest pending bit's row
        low = cur_m & -cur_m
        biti = (low.to(torch.float32).view(torch.int32) >> 23) - 127
        row_id = cur_b + biti
        cur_m = cur_m ^ low
        touched[row_id.long()] = True
        row = rows[row_id.long()]
        is_leaf = row[:, _W12_FLAG] > 0.5
        n_leaf[lane] += is_leaf
        n_int[lane] += ~is_leaf

        # internal rows: 12 slab tests, the nearest hit child first
        ii = torch.nonzero(~is_leaf)[:, 0]
        if ii.numel():
            r, oi, idv = row[ii], lo[ii], inv_d[ii]

            def axis_slab(c_min, c_max, a):
                t1 = (r[:, c_min:c_min + W12] - oi[:, a:a + 1]) * idv[:, a:a + 1]
                t2 = (r[:, c_max:c_max + W12] - oi[:, a:a + 1]) * idv[:, a:a + 1]
                return torch.minimum(t1, t2), torch.maximum(t1, t2)

            tnx, tfx = axis_slab(0, 3 * W12, 0)
            tny, tfy = axis_slab(W12, 4 * W12, 1)
            tnz, tfz = axis_slab(2 * W12, 5 * W12, 2)
            tn = torch.maximum(torch.maximum(tnx, tny), tnz)
            tf = torch.minimum(torch.minimum(tfx, tfy), tfz) * SLAB_EPS
            hit12 = (tn <= tf) & (tf > 0.0) & (tn < best_t[ii, None])
            # slots past the child count hold inverted boxes, which the
            # per-axis min/max would turn into hits
            hit12 &= slot[None, :] < _round_i32(r[:, _W12_COUNT])[:, None]
            child_base = _round_i32(r[:, _W12_BASE])
            near = torch.argmin(torch.where(hit12, tn, inf), dim=1).to(torch.int32)
            near_bit = torch.bitwise_left_shift(torch.ones_like(near), near)
            hit_bits = torch.where(hit12, bits[None, :], 0).sum(1, dtype=torch.int32)
            rest = hit_bits & (full ^ near_bit)
            descend = torch.zeros_like(is_leaf)
            descend[ii] = hit12.any(1)
            full_rest = torch.zeros_like(cur_m)
            full_rest[ii] = rest
            full_base = torch.zeros_like(cur_b)
            full_base[ii] = child_base
            full_near = torch.zeros_like(cur_m)
            full_near[ii] = near_bit
            push(descend & (cur_m != 0), cur_b, cur_m)  # resume
            push(descend & (full_rest != 0), full_base, full_rest)  # defer
            cur_b = torch.where(descend, full_base, cur_b)
            cur_m = torch.where(descend, full_near, cur_m)

        # leaf rows: 12 triangle tests, the nearest strictly nearer hit
        li = torch.nonzero(is_leaf)[:, 0]
        if li.numel():
            r = row[li]
            th, tt, tb0, tb1 = tri_test_soa(
                lo[li], best_t[li, None], tuple(s[li] for s in shear),
                *[r[:, c * W12:(c + 1) * W12] for c in range(9)])
            tt_m = torch.where(th, tt, inf)
            t_new, bi = torch.min(tt_m, dim=1)
            upd = th.any(1) & (t_new < best_t[li])
            take = lambda a: a.gather(1, bi[:, None])[:, 0]
            prim = _round_i32(take(r[:, _W12_PRIM:_W12_PRIM + W12]))
            u = li[upd]
            best_t[u] = t_new[upd]
            best_tri[u] = prim[upd]
            best_b0[u] = take(tb0)[upd]
            best_b1[u] = take(tb1)[upd]

    if work is not None:
        work.update(internal=n_int, leaf=n_leaf, rows=int(touched.sum()),
                    overflow=int(overflow))
    return TriHit(out_tri >= 0, out_t, out_tri, out_b0, out_b1)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, rows, n_rows, stack, [t, tri, b0, b1, | occ,] overflow, next_ray, stream
    "rs_bvh12_closest": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "rs_bvh12_any": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
}


@lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("bvh12"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def overflow_counter(device) -> torch.Tensor:
    """The (1,) int32 count of stack entries the kernels dropped on
    `device` since it was last zeroed (``.zero_()``)."""
    dev = resolve(device)  # "cuda" and "cuda:0" name one counter
    if dev not in _overflow:
        _overflow[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _overflow[dev]


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"bvh12_intersect_tris: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"bvh12_intersect_tris: {name} must be a contiguous {dtype} tensor "
                         f"of shape {tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def bvh12_intersect_tris(o, d, t_max, rows, depth: int, any_hit: bool = False):
    """B1 (closest hit -> TriHit) or B2 (any_hit -> (N,) bool occlusion)
    for CUDA tensors; bvh12_intersect_plain for CPU ones."""
    if not any_hit:
        refuse_grad("bvh12_intersect_tris (B1; the differentiable hit is "
                    "scene_intersect.tri_hit)", o, d, t_max)
    if o.device.type == "cpu":
        hit = bvh12_intersect_plain(o, d, t_max, rows, depth, any_hit)
        return hit.valid if any_hit else hit
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    _check("rows", rows, torch.float32, (rows.shape[0], W12_COLS))
    K = stack_size(depth)
    if K > MAX_STACK:
        raise ValueError(f"bvh12_intersect_tris: a tree of depth {depth} needs a stack of {K} "
                         f"entries, the kernels' shared memory holds {MAX_STACK}")
    if not 0 < rows.shape[0] < (1 << 24):
        raise ValueError(f"bvh12_intersect_tris: {rows.shape[0]} rows (1 .. 2^24 - 1 allowed)")
    if n >= 1 << 31:
        raise ValueError("bvh12_intersect_tris: at most 2^31 - 1 rays per launch")
    ovf = overflow_counter(o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with torch.cuda.device(o.device):
        # the persistent groups' ray counter, this launch's own on its stream
        next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
        if any_hit:
            occ = torch.empty(n, dtype=torch.bool, device=o.device)  # one byte, 0 or 1
            err = _kernel("rs_bvh12_any")(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n,
                                          rows.data_ptr(), rows.shape[0], K, occ.data_ptr(),
                                          ovf.data_ptr(), next_ray.data_ptr(), stream)
            _build.check(err, "bvh12 any-hit kernel launch")
            launches["any"] += 1
            return occ
        t = torch.empty_like(t_max)
        tri = torch.empty(n, dtype=torch.int32, device=o.device)
        b0 = torch.empty_like(t_max)
        b1 = torch.empty_like(t_max)
        err = _kernel("rs_bvh12_closest")(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n,
                                          rows.data_ptr(), rows.shape[0], K, t.data_ptr(),
                                          tri.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                                          ovf.data_ptr(), next_ray.data_ptr(), stream)
    _build.check(err, "bvh12 closest-hit kernel launch")
    launches["closest"] += 1
    return TriHit(tri >= 0, t, tri, b0, b1)
