"""Two-level instancing: a tree over the instances' boxes, and one tree a
prototype over its object-space triangles (reference src/core/primitive.rs
TransformedPrimitive, :198-265).

The port of the JAX package's ``ops/instancing.py``.  An instanced scene
keeps one copy of each prototype mesh (``scene.proto_attr``) and per
instance its transforms; ``build_instance_accel`` builds, on the host, the
top tree over the instances' world boxes and each prototype's tree over
its triangles, both with ``build_lbvh``, this package's copy of the JAX
numpy Karras build (``rs_pbrt_tpu/ops/bvh.py:148``): the instances a ray
tests are the K nearest boxes it enters, and among boxes entered at equal
distance (every box that holds the ray's origin is entered at 0) the tree
and its walk order decide which are kept, so the top tree must be the JAX
package's own.

The walk has two phases, as the JAX package's (``instance_intersect``):
phase 1 walks the top tree and keeps the K_CANDIDATES nearest instance
boxes a ray enters (by entry distance clamped at 0, a new box replacing the
farthest kept one only when strictly nearer), sorted by that distance;
phase 2 carries the ray into each candidate's object space (its direction
left unnormalized, so object t is world t) and walks the candidate's
prototype tree, pruned by the best t so far.  A ray that enters more than
K boxes may miss a hit in the boxes it drops: the JAX package's semantics,
kept here (``entered`` counts them).  The plain versions are here
(``collect_candidates``, ``inner_traverse``, ``instance_intersect_plain``);
the kernels I1 (closest hit) and I2 (any hit, the same candidates, each
ray stopping at its first hit) are ``ops/instance_kernel.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve
from ..utils import transform as tr
from .bvh import SLAB_EPS, ray_shear, tri_test_soa
from .intersect import TriHit

K_CANDIDATES = 4
STACK_DEPTH = 64  # the JAX walks' stacks (bvh.STACK_DEPTH, reference bvh.rs:420)


# ---------------------------------------------------------------------------
# the host build: the JAX package's numpy LBVH
# ---------------------------------------------------------------------------

def _expand_bits_10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton3(x, y, z):
    """30-bit Morton codes from 10-bit ints per axis."""
    return ((_expand_bits_10(x.astype(np.uint32)) << 2)
            | (_expand_bits_10(y.astype(np.uint32)) << 1)
            | _expand_bits_10(z.astype(np.uint32)))


def build_lbvh(bmin, bmax) -> dict:
    """Binary radix tree over boxes bmin, bmax (N, 3) f32 (Karras 2012):
    the JAX numpy ``build_lbvh``'s node arrays, child_l, child_r (N-1,)
    int32 (>= 0 a node, else the leaf ~position), bmin_l, bmax_l, bmin_r,
    bmax_r (N-1, 3) f32 and prim_ids (N,) int32, value for value.  A
    single box gives one node whose two children are that leaf."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    n = bmin.shape[0]
    if n == 1:
        leaf = np.asarray([-1], np.int64)
        return dict(child_l=leaf, child_r=leaf.copy(), bmin_l=bmin[None, 0], bmax_l=bmax[None, 0],
                    bmin_r=bmin[None, 0], bmax_r=bmax[None, 0], prim_ids=np.zeros(1, np.int32))
    centroid = 0.5 * (bmin + bmax)
    c_lo = centroid.min(0)
    c_ext = np.maximum(centroid.max(0) - c_lo, 1e-12)
    q = np.clip(((centroid - c_lo) / c_ext) * 1023.0, 0, 1023).astype(np.uint32)
    codes30 = _morton3(q[:, 0], q[:, 1], q[:, 2])
    # unique keys: the primitive index appended (Karras' tie-break)
    keys = (codes30.astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    prim_ids = order.astype(np.int32)
    sb = bmin[order]
    sB = bmax[order]

    def delta(i, j):
        """Common-prefix length of keys i and j (-1 where j is outside)."""
        out = np.full(i.shape, -1, np.int64)
        ok = (j >= 0) & (j < n)
        x = keys[i[ok]] ^ keys[j[ok]]
        lz = 63 - np.floor(np.log2(x.astype(np.float64) + 0.5)).astype(np.int64)
        lz = np.where(x == 0, 64, lz)
        out[ok] = lz
        return out

    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        grow = delta(i, i + lmax * d) > delta_min
        if not grow.any():
            break
        lmax = np.where(grow, lmax * 2, lmax)
        if lmax.max() > 4 * n:
            break
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while t.max() >= 1:
        ok = delta(i, i + (l + t) * d) > delta_min
        l = np.where(ok, l + t, l)
        t = t // 2
    j = i + l * d
    # the split (Karras findSplit)
    delta_node = delta(i, j)
    s = np.zeros(n - 1, np.int64)
    done = np.zeros(n - 1, bool)
    div = 2
    while not done.all():
        t = np.maximum((l + div - 1) // div, 1)
        ok = (delta(i, i + (s + t) * d) > delta_node) & ~done
        s = np.where(ok, s + t, s)
        done |= t == 1
        div *= 2
    gamma_split = i + s * d + np.minimum(d, 0)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    child_l = np.where(lo == gamma_split, ~gamma_split, gamma_split).astype(np.int64)
    child_r = np.where(hi == gamma_split + 1, ~(gamma_split + 1), gamma_split + 1).astype(np.int64)

    # node boxes over leaf ranges [lo, hi] from a sparse table of minima
    levels = max(1, int(np.ceil(np.log2(n))))
    mins, maxs = [sb], [sB]
    for k in range(levels):
        half = 1 << k
        m2, M2 = mins[-1].copy(), maxs[-1].copy()
        m2[: n - half] = np.minimum(mins[-1][: n - half], mins[-1][half:])
        M2[: n - half] = np.maximum(maxs[-1][: n - half], maxs[-1][half:])
        mins.append(m2)
        maxs.append(M2)
    mins_s, maxs_s = np.stack(mins), np.stack(maxs)

    def child_bounds(c):
        is_leaf = c < 0
        a = np.where(is_leaf, ~c, 0)
        cn = np.where(is_leaf, 0, c)
        ra, rb = lo[cn], hi[cn]
        k = np.maximum(np.floor(np.log2(np.maximum(rb - ra + 1, 1))).astype(np.int64), 0)
        off = rb - (1 << k) + 1
        mn = np.minimum(mins_s[k, ra], mins_s[k, off])
        mx = np.maximum(maxs_s[k, ra], maxs_s[k, off])
        mn = np.where(is_leaf[:, None], sb[a], mn)
        mx = np.where(is_leaf[:, None], sB[a], mx)
        return mn.astype(np.float32), mx.astype(np.float32)

    bmin_l, bmax_l = child_bounds(child_l)
    bmin_r, bmax_r = child_bounds(child_r)
    return dict(child_l=child_l, child_r=child_r, bmin_l=bmin_l, bmax_l=bmax_l, bmin_r=bmin_r,
                bmax_r=bmax_r, prim_ids=prim_ids)


class InstanceAccel(NamedTuple):
    """The trees on the device, as the kernels read them: a node's row of
    box holds its children's boxes (bmin_l, bmax_l, bmin_r, bmax_r), its
    row of child their refs (>= 0 a node; a leaf ~k: the top tree's k-th
    leaf, top_prim[k] its instance, or the inner trees' triangle k of
    tris).  The inner trees of every prototype share one node array; an
    instance walks from its prototype's root."""

    top_box: torch.Tensor  # (Mt, 12) f32
    top_child: torch.Tensor  # (Mt, 2) int32
    top_prim: torch.Tensor  # (I,) int32: the top tree's leaf k -> instance
    inner_box: torch.Tensor  # (Mi, 12) f32
    inner_child: torch.Tensor  # (Mi, 2) int32
    w2o: torch.Tensor  # (I, 4, 4) f32 world to object
    root: torch.Tensor  # (I,) int32: the instance's prototype's root node
    tris: torch.Tensor  # (PT, 9) f32 the prototypes' vertices (p0, p1, p2), object space


def _rows(tree: dict):
    box = np.concatenate([tree["bmin_l"], tree["bmax_l"], tree["bmin_r"], tree["bmax_r"]], 1)
    child = np.stack([tree["child_l"], tree["child_r"]], 1)
    return np.ascontiguousarray(box, np.float32), np.ascontiguousarray(child, np.int32)


def instance_boxes(proto_bounds, inst_proto, inst_o2w):
    """(wmin, wmax) (I, 3) f32: each instance's prototype box (P, 2, 3)
    carried to the world by its 8 corners (the JAX build's expression)."""
    pb = np.asarray(proto_bounds, np.float32)[np.asarray(inst_proto, np.int64)]
    lo, hi = pb[:, 0], pb[:, 1]
    cs = np.stack([np.stack([np.where(m & 1, hi[:, 0], lo[:, 0]),
                             np.where(m & 2, hi[:, 1], lo[:, 1]),
                             np.where(m & 4, hi[:, 2], lo[:, 2])], -1)
                   for m in range(8)], 1)  # (I, 8, 3)
    inst_o2w = np.asarray(inst_o2w, np.float32)
    wc = np.einsum("ikj,icj->ick", inst_o2w[:, :3, :3], cs) + inst_o2w[:, :3, 3][:, None, :]
    return wc.min(1).astype(np.float32), wc.max(1).astype(np.float32)


def build_instance_accel(proto_ranges, proto_bounds, inst_proto, inst_o2w, tris,
                         device="cuda") -> InstanceAccel:
    """Host build (the JAX build_instance_accel).  proto_ranges: (tri0,
    tri1) per prototype into the shared triangles; proto_bounds (P, 2, 3)
    each prototype's object-space box; inst_proto (I,) its prototype;
    inst_o2w (I, 4, 4); tris (PT, 9) f32 the shared triangles' vertices."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 9)
    p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    tri_bmin = np.minimum(np.minimum(p0, p1), p2)
    tri_bmax = np.maximum(np.maximum(p0, p1), p2)
    inst_proto = np.asarray(inst_proto, np.int64)
    inst_o2w = np.asarray(inst_o2w, np.float32)
    roots, boxes, childs = [], [], []
    node_off = 0
    for t0, t1 in proto_ranges:
        sub = build_lbvh(tri_bmin[t0:t1], tri_bmax[t0:t1])
        pid = np.asarray(sub["prim_ids"], np.int64) + t0
        # leaves name their global triangle directly; nodes shift by the offset
        remap = lambda c: np.where(c >= 0, c + node_off, ~pid[np.where(c >= 0, 0, ~c)])
        box, _ = _rows(sub)
        boxes.append(box)
        childs.append(np.stack([remap(sub["child_l"]), remap(sub["child_r"])], 1))
        roots.append(node_off)
        node_off += box.shape[0]
    top = build_lbvh(*instance_boxes(proto_bounds, inst_proto, inst_o2w))
    top_box, top_child = _rows(top)
    w2o = np.linalg.inv(inst_o2w.astype(np.float64)).astype(np.float32)
    dev = resolve(device)
    f = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    return InstanceAccel(
        f(top_box, np.float32), f(top_child, np.int32), f(top["prim_ids"], np.int32),
        f(np.concatenate(boxes), np.float32), f(np.concatenate(childs), np.int32),
        f(w2o, np.float32), f(np.asarray(roots, np.int64)[inst_proto], np.int32),
        f(tris, np.float32))


# ---------------------------------------------------------------------------
# the plain walks (the JAX while loops, lane by lane; finished lanes leave)
# ---------------------------------------------------------------------------

def _inv_dir(d):
    return 1.0 / torch.where(d == 0.0, 1e-20, d)


def slab(o, inv_d, t_max, box, c: int):
    """The JAX _slab of rays (R, 3) against boxes box[:, c:c+6] (bmin,
    bmax): (hit, t_near).  A NaN in any slab distance makes it a miss."""
    t1 = (box[:, c:c + 3] - o) * inv_d
    t2 = (box[:, c + 3:c + 6] - o) * inv_d
    tmn, tmx = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tn = torch.maximum(torch.maximum(tmn[:, 0], tmn[:, 1]), tmn[:, 2])
    tf = torch.minimum(torch.minimum(tmx[:, 0], tmx[:, 1]), tmx[:, 2]) * SLAB_EPS
    return (tn <= tf) & (tf > 0.0) & (tn < t_max), tn


def _push(stack, sp, lanes, sel, child):
    """Pushes child where sel (the JAX push: a full stack overwrites its
    top entry and keeps its size)."""
    slot = torch.clamp(sp, max=STACK_DEPTH - 1)
    li, si = lanes[sel], slot[sel]
    stack[li, si] = child[sel]
    sp = torch.where(sel, torch.clamp(sp + 1, max=STACK_DEPTH), sp)
    return sp


def collect_candidates(o, d, t_max, acc: InstanceAccel, k: int = K_CANDIDATES,
                       work: Optional[dict] = None):
    """Phase 1 (the JAX _collect_candidates): each ray's k nearest instance
    boxes by entry distance max(t_near, 0), sorted (stable) -> (cand (N,
    k) int32, -1 where none, cand_t (N, k) f32, inf where none).  work,
    when given, gains per ray the top nodes visited ("top_nodes") and the
    instance boxes entered ("entered"), each (N,) int64, and the top nodes
    any ray visited ("top_seen", a bool mask)."""
    n, dev = o.shape[0], o.device
    inv_d = _inv_dir(d)
    cand = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    cand_t = torch.full((n, k), float("inf"), device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    entered = torch.zeros(n, dtype=torch.int64, device=dev)
    seen = torch.zeros(acc.top_box.shape[0], dtype=torch.bool, device=dev)
    kk = torch.arange(k, device=dev)
    lanes = torch.arange(n, device=dev)
    while lanes.numel():
        spl = sp[lanes] - 1
        node = stack[lanes, spl]
        visits[lanes] += 1
        seen[node] = True
        box = acc.top_box[node]
        child = acc.top_child[node].to(torch.int64)
        ol, il, tl = o[lanes], inv_d[lanes], t_max[lanes]
        hits = [slab(ol, il, tl, box, 0), slab(ol, il, tl, box, 6)]
        # leaf children into the candidates (left, then right): a box
        # replaces the farthest kept one (the first of equal) when nearer
        for (hit, tn), side in zip(hits, (0, 1)):
            ch = child[:, side]
            leaf = hit & (ch < 0)
            entered[lanes] += leaf
            inst = acc.top_prim[torch.where(ch < 0, ~ch, 0)]
            ct, cl = cand_t[lanes], cand[lanes]
            worst = torch.argmax(ct, dim=1)
            tn0 = torch.clamp(tn, min=0.0)
            do = leaf & (tn0 < ct.gather(1, worst[:, None])[:, 0])
            at = do[:, None] & (kk[None, :] == worst[:, None])
            cand[lanes] = torch.where(at, inst[:, None], cl)
            cand_t[lanes] = torch.where(at, tn0[:, None], ct)
        # internal children onto the stack: left, then right
        for (hit, _), side in zip(hits, (0, 1)):
            ch = child[:, side]
            spl = _push(stack, spl, lanes, hit & (ch >= 0), ch)
        sp[lanes] = spl
        lanes = lanes[spl > 0]
    order = torch.sort(cand_t, dim=1, stable=True).indices
    if work is not None:
        work.update(top_nodes=visits, entered=entered, top_seen=seen)
    return cand.gather(1, order), cand_t.gather(1, order)


def inner_traverse(o, d, t_max, acc: InstanceAccel, root, any_hit: bool = False,
                   work: Optional[dict] = None):
    """Phase 2's walk of object-space rays (R, 3) from their prototype roots
    (R,) within t_max (R,) (the JAX _inner_traverse): -> (t, tri, b0, b1),
    tri -1 and t = t_max where nothing is hit.  At each node both child
    boxes are tested against the best t so far, a leaf child's triangle is
    tested (left, then right), and the hit internal children are pushed
    far first, so the nearer pops first (left on equal entry).  any_hit: a
    ray stops after the node at which it first hits.  work, when given,
    gains the nodes ("nodes") and triangles ("tests") each ray visits and
    the nodes and triangles any ray visited ("node_seen", "tri_seen", bool
    masks)."""
    n, dev = o.shape[0], o.device
    inv_d = _inv_dir(d)
    shear = tuple(s[:, None] for s in ray_shear(o, d))
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_b0 = torch.zeros(n, device=dev)
    best_b1 = torch.zeros(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack[:, 0] = root
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    nodes = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    node_seen = torch.zeros(acc.inner_box.shape[0], dtype=torch.bool, device=dev)
    tri_seen = torch.zeros(acc.tris.shape[0], dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)
    while lanes.numel():
        spl = sp[lanes] - 1
        node = stack[lanes, spl]
        nodes[lanes] += 1
        node_seen[node] = True
        box = acc.inner_box[node]
        child = acc.inner_child[node].to(torch.int64)
        ol, il = o[lanes], inv_d[lanes]
        bt = best_t[lanes]
        hit_l, tn_l = slab(ol, il, bt, box, 0)
        hit_r, tn_r = slab(ol, il, bt, box, 6)
        sh = tuple(s[lanes] for s in shear)
        for hit, side in ((hit_l, 0), (hit_r, 1)):
            ch = child[:, side]
            leaf = hit & (ch < 0)
            if bool(leaf.any()):
                li = torch.nonzero(leaf)[:, 0]
                prim = ~ch[li]
                v = acc.tris[prim]
                th, tt, tb0, tb1 = tri_test_soa(
                    ol[li], best_t[lanes[li], None], tuple(s[li] for s in sh),
                    *[v[:, c:c + 1] for c in range(9)])
                th, tt, tb0, tb1 = th[:, 0], tt[:, 0], tb0[:, 0], tb1[:, 0]
                tests[lanes[li]] += 1
                tri_seen[prim] = True
                upd = th & (tt < best_t[lanes[li]])
                u = lanes[li][upd]
                best_t[u] = tt[upd]
                best_tri[u] = prim[upd]
                best_b0[u] = tb0[upd]
                best_b1[u] = tb1[upd]
        near_l = tn_l <= tn_r
        first = torch.where(near_l, child[:, 0], child[:, 1])
        second = torch.where(near_l, child[:, 1], child[:, 0])
        push_first = torch.where(near_l, hit_l, hit_r) & (first >= 0)
        push_second = torch.where(near_l, hit_r, hit_l) & (second >= 0)
        spl = _push(stack, spl, lanes, push_second, second)
        spl = _push(stack, spl, lanes, push_first, first)
        sp[lanes] = spl
        live = spl > 0
        if any_hit:
            live &= best_tri[lanes] < 0
        lanes = lanes[live]
    if work is not None:
        work.update(nodes=nodes, tests=tests, node_seen=node_seen, tri_seen=tri_seen)
    return best_t, best_tri.to(torch.int32), best_b0, best_b1


class InstanceHit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) world t of the hit, t_max where none
    tri: torch.Tensor  # (N,) int32 triangle of the shared table, -1 where none
    inst: torch.Tensor  # (N,) int32 instance (0 where none)
    b0: torch.Tensor
    b1: torch.Tensor


def instance_intersect_plain(o, d, t_max, acc: InstanceAccel, any_hit: bool = False,
                             k: int = K_CANDIDATES, work: Optional[dict] = None):
    """Closest hit through the instances (the JAX instance_intersect) ->
    InstanceHit; any_hit: the occlusion (N,) bool, the same candidates
    walked until each ray's first hit.  Rays with t_max < 0 (dead paths)
    or NaN can hit nothing: they keep t_max and skip both phases (phase 1
    would still collect their boxes; no triangle passes their range test).
    work, when given, is filled per ray (N,) int64 with "top_nodes",
    "entered", "candidates", "inner_nodes" and "tests", and with the
    distinct top nodes, instances, inner nodes and triangles that any ray
    visited ("top_rows", "inst_rows", "inner_rows", "tri_rows", ints)."""
    n, dev = o.shape[0], o.device
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_b0 = torch.zeros(n, device=dev)
    best_b1 = torch.zeros(n, device=dev)
    counts = {key: torch.zeros(n, dtype=torch.int64, device=dev)
              for key in ("top_nodes", "entered", "candidates", "inner_nodes", "tests")}
    inst_seen = torch.zeros(acc.w2o.shape[0], dtype=torch.bool, device=dev)
    inner_seen = torch.zeros(acc.inner_box.shape[0], dtype=torch.bool, device=dev)
    tri_seen = torch.zeros(acc.tris.shape[0], dtype=torch.bool, device=dev)
    live = torch.nonzero(t_max >= 0.0)[:, 0]
    w1 = {}
    cand, _ = collect_candidates(o[live], d[live], t_max[live], acc, k, w1)
    counts["top_nodes"][live] = w1["top_nodes"]
    counts["entered"][live] = w1["entered"]
    for j in range(k):
        sel = cand[:, j] >= 0
        if any_hit:
            sel &= best_tri[live] < 0
        lanes = live[sel]
        if not lanes.numel():
            continue
        inst = cand[sel, j].long()
        w2o = acc.w2o[inst]
        oo = tr.xform_point(w2o, o[lanes])
        od = tr.xform_vector(w2o, d[lanes])
        w2 = {}
        t, tri, b0, b1 = inner_traverse(oo, od, best_t[lanes], acc, acc.root[inst].long(),
                                        any_hit, w2)
        counts["candidates"][lanes] += 1
        counts["inner_nodes"][lanes] += w2["nodes"]
        counts["tests"][lanes] += w2["tests"]
        inst_seen[inst] = True
        inner_seen |= w2["node_seen"]
        tri_seen |= w2["tri_seen"]
        upd = (tri >= 0) & (t < best_t[lanes])
        u = lanes[upd]
        best_t[u] = t[upd]
        best_tri[u] = tri[upd]
        best_inst[u] = inst[upd].to(torch.int32)
        best_b0[u] = b0[upd]
        best_b1[u] = b1[upd]
    if work is not None:
        work.update(counts, top_rows=int(w1["top_seen"].sum()), inst_rows=int(inst_seen.sum()),
                    inner_rows=int(inner_seen.sum()), tri_rows=int(tri_seen.sum()))
    if any_hit:
        return best_tri >= 0
    return InstanceHit(best_tri >= 0, best_t, best_tri, torch.clamp(best_inst, min=0), best_b0,
                       best_b1)
