"""The SAH kd-tree (reference src/accelerators/kdtreeaccel.rs), the
triangle family's accelerator under ``Accelerator "kdtree"``.

The port of the JAX package's ``ops/kdtree.py``.  ``build_kdtree`` is its
host build, node for node: pbrt's SAH edge sweep per node
(kdtreeaccel.rs:253-499; cost = traversal + intersection (1 - empty bonus)
(pA nA + pB nB), the widest axis first, a leaf after three bad refines),
recursive numpy.  The nodes are flat arrays: axis (3 a leaf), split, the
above child (the below child is the next node), and a leaf's range of
prim_ids; leaf_cap is the largest leaf.

``kdtree_intersect_plain`` is the plain version of the walk, pbrt's
(node, tmin, tmax) stack (kdtreeaccel.rs:503-730) as the JAX loop runs it:
the ray clipped to the world box; a node whose tmin lies past the best hit
is popped; a leaf tests its triangles in order, each kept only strictly
nearer; an interior node visits the child on the origin's side first (the
below one where the origin lies on the plane and the ray does not point
above), only the first where the plane lies past tmax or behind the
origin, only the second where it lies before tmin, else both, the far
child placed under the near one.  The stack holds 64 entries, pbrt's
MAX_TO_DO; a push onto a full stack overwrites its top with the far child,
as the JAX loop's clamped slot does, and is counted.  The kernels D1
(closest hit) and D2 (any hit: a ray stops after the leaf of its first
hit) are ``ops/kdtree_kernel.py``.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve
from .bvh import range_hit, ray_shear, tri_test_soa
from .intersect import TriHit

STACK_DEPTH = 64  # reference kdtreeaccel.rs MAX_TO_DO
LEAF = 3  # axis of a leaf


class KdTree(NamedTuple):
    axis: torch.Tensor  # (M,) int32: 0, 1, 2 an interior node's split axis, 3 a leaf
    split: torch.Tensor  # (M,) f32 the split's position
    above: torch.Tensor  # (M,) int32 the above child (the below child is node + 1)
    start: torch.Tensor  # (M,) int32 a leaf's first entry of prim_ids
    count: torch.Tensor  # (M,) int32 its entries
    prim_ids: torch.Tensor  # (P,) int32
    world: torch.Tensor  # (6,) f32 the world box: bmin, bmax
    leaf_cap: int  # the largest leaf's count


def build_kdtree(bmin, bmax, isect_cost=80.0, trav_cost=1.0, empty_bonus=0.5, max_prims=1,
                 max_depth=-1) -> dict:
    """The kd-tree over primitive boxes bmin, bmax (N, 3) (host numpy):
    the JAX build_kdtree's arrays, value for value, as numpy: axis, split,
    above, start, count, prim_ids, bmin, bmax and leaf_cap."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    n = bmin.shape[0]
    if max_depth <= 0:
        max_depth = int(round(8.0 + 1.3 * np.log2(max(n, 1))))
    world_lo = bmin.min(0)
    world_hi = bmax.max(0)

    axis_l, split_l, above_l, start_l, count_l = [], [], [], [], []
    prim_ids_out = []

    def add_leaf(prims):
        axis_l.append(LEAF)
        split_l.append(0.0)
        above_l.append(0)
        start_l.append(len(prim_ids_out))
        count_l.append(len(prims))
        prim_ids_out.extend(prims.tolist())
        return len(axis_l) - 1

    def build(prims, lo, hi, depth, bad_refines):
        nprims = prims.shape[0]
        if nprims <= max_prims or depth == 0:
            return add_leaf(prims)
        # the SAH sweep over each axis's bound edges (kdtreeaccel.rs:286-400)
        d = hi - lo
        inv_total_sa = 1.0 / max(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-20)
        old_cost = isect_cost * nprims
        best = None  # (cost, axis, position)
        for axis in np.argsort(-d):  # the widest axis first
            e_lo = bmin[prims, axis]
            e_hi = bmax[prims, axis]
            pos = np.concatenate([e_lo, e_hi])
            typ = np.concatenate([np.zeros(nprims, np.int8), np.ones(nprims, np.int8)])
            order = np.lexsort((typ, pos))  # starts before ends at equal positions
            pos_s = pos[order]
            typ_s = typ[order]
            n_below = np.cumsum(typ_s == 0)
            n_above = nprims - np.cumsum(typ_s == 1)
            inside = (pos_s > lo[axis]) & (pos_s < hi[axis])
            if not inside.any():
                continue
            o0, o1, o2 = [(axis + k) % 3 for k in range(3)]
            below_sa = 2.0 * (d[o1] * d[o2] + (pos_s - lo[axis]) * (d[o1] + d[o2]))
            above_sa = 2.0 * (d[o1] * d[o2] + (hi[axis] - pos_s) * (d[o1] + d[o2]))
            p_below = below_sa * inv_total_sa
            p_above = above_sa * inv_total_sa
            # at an edge, below counts the starts before it; the ends at it
            # have left above (the reference's order)
            nb = np.concatenate([[0], n_below[:-1]])
            na = n_above
            eb = np.where((na == 0) | (nb == 0), empty_bonus, 0.0)
            cost = trav_cost + isect_cost * (1.0 - eb) * (p_below * nb + p_above * na)
            cost = np.where(inside, cost, np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), int(axis), float(pos_s[k]))
            if best is not None and best[0] < old_cost:
                break  # the reference stops at the first good axis too
        if best is None:
            return add_leaf(prims)
        cost, axis, split = best
        if cost > old_cost:
            bad_refines += 1
        if (cost > 4.0 * old_cost and nprims < 16) or bad_refines == 3:
            return add_leaf(prims)
        below = prims[bmin[prims, axis] < split]
        above = prims[bmax[prims, axis] > split]
        if len(below) == nprims and len(above) == nprims:
            return add_leaf(prims)  # a split that separates nothing
        node_id = len(axis_l)
        axis_l.append(axis)
        split_l.append(split)
        above_l.append(-1)  # patched once the below subtree is built
        start_l.append(0)
        count_l.append(0)
        lo_b, hi_b = lo.copy(), hi.copy()
        hi_b[axis] = split
        build(below, lo_b, hi_b, depth - 1, bad_refines)
        above_l[node_id] = len(axis_l)
        lo_a, hi_a = lo.copy(), hi.copy()
        lo_a[axis] = split
        build(above, lo_a, hi_a, depth - 1, bad_refines)
        return node_id

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, old_limit))
    try:
        build(np.arange(n), world_lo.copy(), world_hi.copy(), max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)
    leaf_cap = max([c for a, c in zip(axis_l, count_l) if a == LEAF] + [1])
    return dict(axis=np.asarray(axis_l, np.int32), split=np.asarray(split_l, np.float32),
                above=np.asarray(above_l, np.int32), start=np.asarray(start_l, np.int32),
                count=np.asarray(count_l, np.int32),
                prim_ids=np.asarray(prim_ids_out if prim_ids_out else [0], np.int32),
                bmin=world_lo.astype(np.float32), bmax=world_hi.astype(np.float32),
                leaf_cap=int(leaf_cap))


def kdtree_from_numpy(arrays: dict, device="cuda") -> KdTree:
    """KdTree on `device` from build_kdtree's arrays."""
    dev = resolve(device)
    t = lambda k: torch.as_tensor(np.ascontiguousarray(arrays[k]), device=dev)
    world = np.concatenate([arrays["bmin"], arrays["bmax"]]).astype(np.float32)
    return KdTree(t("axis"), t("split"), t("above"), t("start"), t("count"), t("prim_ids"),
                  torch.as_tensor(world, device=dev), int(arrays["leaf_cap"]))


def kdtree_intersect_plain(o, d, t_max, kt: KdTree, tris, any_hit: bool = False,
                           work: Optional[dict] = None) -> TriHit:
    """The walk of rays o, d (N, 3) within t_max (N,) over the triangles
    tris (T, 9) f32 (p0, p1, p2) -> TriHit (valid, t (t_max on a miss),
    tri, b0, b1); any_hit: each ray stops after the leaf of its first hit
    (its tri is the nearest hit of that leaf).  Lanes whose walk has ended
    leave the wavefront.  work, when given, gains per ray the nodes popped
    ("nodes") and triangles tested ("tests"), (N,) int64, the far children
    a full stack overwrote ("overflow"), and the distinct nodes, prim id
    slots and triangles that any ray read ("node_rows", "slot_rows",
    "tri_rows"), ints."""
    n, dev = o.shape[0], o.device
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    shear = tuple(s[:, None] for s in ray_shear(o, d))
    # the world-box clip (kdtreeaccel.rs:517)
    t_lo = (kt.world[:3] - o) * inv_d
    t_hi = (kt.world[3:] - o) * inv_d
    tmn, tmx = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
    t_near = torch.clamp(torch.maximum(torch.maximum(tmn[:, 0], tmn[:, 1]), tmn[:, 2]), min=0.0)
    t_far = torch.minimum(torch.minimum(tmx[:, 0], tmx[:, 1]), tmx[:, 2])
    entered = t_near <= t_far

    stk_node = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stk_tmin = torch.zeros((n, STACK_DEPTH), device=dev)
    stk_tmax = torch.zeros((n, STACK_DEPTH), device=dev)
    stk_tmin[:, 0] = t_near
    stk_tmax[:, 0] = torch.minimum(t_far, t_max)
    sp = entered.to(torch.int64)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_b0 = torch.zeros(n, device=dev)
    best_b1 = torch.zeros(n, device=dev)
    nodes = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = 0
    n_prims = kt.prim_ids.shape[0]
    node_seen = torch.zeros(kt.axis.shape[0], dtype=torch.bool, device=dev)
    slot_seen = torch.zeros(n_prims, dtype=torch.bool, device=dev)
    tri_seen = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    axis_t = kt.axis.to(torch.int64)

    lanes = torch.nonzero(sp > 0)[:, 0]
    while lanes.numel():
        top = sp[lanes] - 1
        node = stk_node[lanes, top]
        tmin = stk_tmin[lanes, top]
        tmax = stk_tmax[lanes, top]
        nodes[lanes] += 1
        node_seen[node] = True
        axis = axis_t[node]
        dead = tmin > best_t[lanes]
        is_leaf = axis == LEAF
        # a leaf's triangles, in order, each against the best t so far: all
        # tested at once with t_max = inf, then each one's range test at the
        # best t it meets (range_hit), the test's only term t_max enters
        li = torch.nonzero(is_leaf & ~dead)[:, 0]
        if li.numel():
            ln = lanes[li]
            cnt = kt.count[node[li]].long()
            start = kt.start[node[li]].long()
            kk = torch.arange(int(cnt.max()), device=dev)
            slot = torch.clamp(start[:, None] + kk, 0, n_prims - 1)
            prim = kt.prim_ids[slot].long()
            in_leaf = kk < cnt[:, None]
            slot_seen[slot[in_leaf]] = True
            tri_seen[prim[in_leaf]] = True
            v = tris[prim]  # (leaf lanes, K, 9)
            th, tt, tb0, tb1, ts, det = tri_test_soa(
                o[ln], torch.full((ln.shape[0], 1), float("inf"), device=dev),
                tuple(s[ln] for s in shear), *[v[..., c] for c in range(9)], scaled=True)
            tests[ln] += cnt
            bt, bi = best_t[ln], best_tri[ln]
            b0, b1 = best_b0[ln], best_b1[ln]
            for k in range(kk.shape[0]):
                upd = ((k < cnt) & range_hit(th[:, k], ts[:, k], det[:, k], bt)
                       & (tt[:, k] < bt))
                bt = torch.where(upd, tt[:, k], bt)
                bi = torch.where(upd, prim[:, k], bi)
                b0 = torch.where(upd, tb0[:, k], b0)
                b1 = torch.where(upd, tb1[:, k], b1)
            best_t[ln], best_tri[ln], best_b0[ln], best_b1[ln] = bt, bi, b0, b1
        pop = dead | is_leaf
        # an interior node: the near child in place, the far one under it
        ii = torch.nonzero(~pop)[:, 0]
        if ii.numel():
            li_, nd, ax = lanes[ii], node[ii], axis[ii]
            t0, t1 = tmin[ii], tmax[ii]
            o_ax = o[li_].gather(1, ax[:, None])[:, 0]
            d_ax = d[li_].gather(1, ax[:, None])[:, 0]
            inv_ax = inv_d[li_].gather(1, ax[:, None])[:, 0]
            split = kt.split[nd]
            t_plane = (split - o_ax) * inv_ax
            below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0))
            below, above = nd + 1, kt.above[nd].long()
            first = torch.where(below_first, below, above)
            second = torch.where(below_first, above, below)
            only_first = (t_plane > t1) | (t_plane <= 0)
            only_second = (t_plane < t0) & ~only_first
            both = ~only_first & ~only_second
            near_node = torch.where(only_second, second, first)
            near_t0 = torch.where(only_second, torch.maximum(t_plane, t0), t0)
            near_t1 = torch.where(only_first | only_second, t1, torch.minimum(t_plane, t1))
            far_t0 = torch.maximum(t_plane, t0)
            tp = top[ii]
            full = both & (tp + 1 >= STACK_DEPTH)
            overflow += int(full.sum())
            push = both & ~full
            # the near child goes one above the far one, which takes its
            # slot; on a full stack the far one overwrites the top
            stk_node[li_, tp] = torch.where(both, second, near_node)
            stk_tmin[li_, tp] = torch.where(both, far_t0, near_t0)
            stk_tmax[li_, tp] = torch.where(both, t1, near_t1)
            pi, ps = li_[push], tp[push] + 1
            stk_node[pi, ps] = near_node[push]
            stk_tmin[pi, ps] = near_t0[push]
            stk_tmax[pi, ps] = near_t1[push]
            sp[li_] += push.long()
        sp[lanes] -= pop.long()
        live = sp[lanes] > 0
        if any_hit:
            live &= best_tri[lanes] < 0
        lanes = lanes[live]
    if work is not None:
        work.update(nodes=nodes, tests=tests, overflow=overflow,
                    node_rows=int(node_seen.sum()), slot_rows=int(slot_seen.sum()),
                    tri_rows=int(tri_seen.sum()))
    return TriHit(best_tri >= 0, best_t, best_tri.to(torch.int32), best_b0, best_b1)
