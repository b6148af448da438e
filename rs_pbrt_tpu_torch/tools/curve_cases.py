"""Inputs on which the curve kernels (C1-C4, ``ops/curve_kernel.py``) are
held to their plain versions: rays at the fur patch, a table of flat,
cylinder and ribbon segments with degenerate rows, rays aimed at its
segments, and a tree whose walk overflows the stack.

``chip_smoke.py`` (phase 13) runs them on the card; the CPU tests build the
same inputs at small sizes.  Everything is made from numpy generators of
the given seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curves as cv

FLT_MAX = float(np.finfo(np.float32).max)


def fur_rays(n: int, seed: int = 0, device="cuda"):
    """(o, d, t_max) of n rays from in front of the patch toward it: unit
    directions, a fifth with a finite t_max, a tenth with t_max = inf and
    the rest FLT_MAX (as camera rays), the first 16 of zero direction."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.2, 2.0, n), np.full(n, 3.0)], -1)
    target = np.stack([rng.uniform(-0.6, 0.9, n), rng.uniform(0, 1, n),
                       rng.uniform(-0.6, 0.6, n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = 0.0
    u = rng.uniform(size=n)
    t_max = np.where(u < 0.2, rng.uniform(2.0, 4.0, n), np.where(u < 0.3, np.inf, FLT_MAX))
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return f(o), f(d), f(t_max)


def table_rows(n_rows: int = 1024, seed: int = 0) -> np.ndarray:
    """(n_rows, 26) f32 segment rows: random flat, cylinder and ribbon
    curves flattened at splitdepth 1, cycled by type; rows 0-3 of zero
    width, rows 4-7 with coincident control points."""
    rng = np.random.default_rng(seed)
    rows, have = [], 0
    while have < n_rows:
        for ctype in (cv.FLAT, cv.CYLINDER, cv.RIBBON):
            n = 8
            p0 = rng.uniform(-1.5, 1.5, (n, 3))
            cps = np.stack([p0, p0 + rng.normal(0, 0.4, (n, 3)), p0 + rng.normal(0, 0.4, (n, 3)),
                            p0 + rng.normal(0, 0.8, (n, 3))], 1).astype(np.float32)
            nn = rng.normal(size=(n, 2, 3)).astype(np.float32)
            nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
            arrs = cv.flatten_curves(cps, rng.uniform(0.05, 0.3, n), rng.uniform(0.01, 0.2, n),
                                     np.full(n, ctype), nn[:, 0], nn[:, 1], splitdepth=1)
            rows.append(cv.pack_curve_attr(arrs, np.full(arrs["crv_cp"].shape[0], ctype)))
            have += rows[-1].shape[0]
    at = np.concatenate(rows)[:n_rows].copy()
    at[0:4, 12:14] = 0.0  # zero width
    at[4:8, 3:12] = np.tile(at[4:8, 0:3], (1, 3))  # coincident control points
    return at


def rays_at(rows: np.ndarray, n: int, seed: int = 0, device="cuda"):
    """(o, d, t_max, seg) of n rays, each aimed near a point of segment
    seg (a random row of rows) from 2-6 away, with directions of length
    0.5-2: rays 0-3 of zero direction, rays 4-7 along their segment's
    chord, a fifth with a finite t_max, the rest FLT_MAX."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, rows.shape[0], n)
    cp = rows[seg, :12].reshape(n, 4, 3)
    w = rng.uniform(0, 1, n)[:, None]
    target = (1 - w) * cp[:, 0] + w * cp[:, 3] + rng.normal(0, 0.05, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = target - d * rng.uniform(2, 6, (n, 1))
    d *= rng.uniform(0.5, 2.0, (n, 1))
    d[:4] = 0.0
    chord = cp[4:8, 3] - cp[4:8, 0]
    d[4:8] = chord
    o[4:8] = cp[4:8, 0] - chord
    t_max = np.where(rng.uniform(size=n) < 0.2, rng.uniform(0.5, 4.0, n), FLT_MAX)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return f(o), f(d), f(t_max), seg


def clamp_tree(rows: np.ndarray, spine: int = 80, device="cuda"):
    """(CurveBVH, arrays, n_segments) of a tree over the first 2 spine + 2
    rows whose walk defers one node a step: spine node i (0..spine-1) has
    the next spine node (node 2 spine after the last) on its left and stub
    node spine+i, whose leaves are 2i and 2i+1, on its right; node 2 spine
    holds the last two leaves.  Every box is the rows' whole box, so the
    left child is the nearer and each spine step pushes both: past 64
    steps the walk's stack clamps.  arrays are the JAX LBVH's fields."""
    k = spine
    s = 2 * k + 2
    bmin, bmax = cv.segment_boxes(rows[:s])
    child_l = np.concatenate([np.arange(1, k), [2 * k], ~(2 * np.arange(k)), [~(2 * k)]])
    child_r = np.concatenate([k + np.arange(k), ~(2 * np.arange(k) + 1), [~(2 * k + 1)]])
    box = lambda v: np.tile(v, (s - 1, 1)).astype(np.float32)
    arrays = dict(child_l=child_l.astype(np.int32), child_r=child_r.astype(np.int32),
                  bmin_l=box(bmin.min(0)), bmax_l=box(bmax.max(0)), bmin_r=box(bmin.min(0)),
                  bmax_r=box(bmax.max(0)), prim_ids=np.arange(s, dtype=np.int32))
    return cv.curve_bvh_from_numpy(**arrays, device=device), arrays, s
