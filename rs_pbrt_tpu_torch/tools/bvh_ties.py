"""A hand-built 12-wide tree whose walks meet each tie and NaN rule of the
traversal (ops/bvh.py), for holding a traversal to another on them.

``tie_case`` gives the rows and rays.  The tree has three levels (depth 3),
its triangles lie in planes z = const, and most rays run along +z:

- two child boxes at equal entry distance, in slots 1 and 2 of an internal
  row whose slot 0 is farther: the walk enters slot 1 first (the lowest
  slot on ties), and its leaf, found first, keeps the hit;
- a leaf whose nearest hits are two triangles at equal t in slots 3 and 7,
  behind a farther one in slot 0: slot 3's triangle wins;
- the same triangle again in a later leaf at the same t: a leaf updates the
  hit only where it is strictly nearer, so the first leaf's stays;
- a leaf holding a triangle with a NaN vertex (its t is NaN) beside one at
  t = 1: the NaN blocks the leaf's update, so a farther leaf's hit at t = 3
  wins;
- rays with t_max < 0 (dead paths), rays that end before the boxes or just
  before the triangles, and random rays across the regions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

W, COLS = 12, 128
BASE, COUNT, PRIM, LEAF_COUNT, FLAG = 72, 73, 108, 120, 127
DEPTH = 3
FLT_MAX = float(np.finfo(np.float32).max)


def _internal(base, boxes):
    """An internal row over consecutive children base.., boxes [(lo, hi)]."""
    row = np.zeros(COLS, np.float32)
    row[0:36] = 1e30  # empty slots: inverted boxes, masked by the count
    row[36:72] = -1e30
    for s, (lo, hi) in enumerate(boxes):
        for a in range(3):
            row[12 * a + s] = lo[a]
            row[36 + 12 * a + s] = hi[a]
    row[BASE], row[COUNT] = base, len(boxes)
    return row


def _leaf(tris):
    """A leaf row of 12 slots, tris [(prim, p0, p1, p2)]; the last triangle
    fills the empty slots, as the builder fills them."""
    tris = list(tris) + [tris[-1]] * (W - len(tris))
    row = np.zeros(COLS, np.float32)
    for s, (prim, *verts) in enumerate(tris):
        for v, p in enumerate(verts):
            for a in range(3):
                row[12 * (3 * v + a) + s] = p[a]
        row[PRIM + s] = prim
    row[LEAF_COUNT], row[FLAG] = W, 1.0
    return row


def _tri(prim, x0, y0, z, nan=False):
    """A right triangle in the plane z covering [x0, x0 + 1] x [y0, y0 + 1]
    below its diagonal, facing -z; nan puts a NaN in its first vertex."""
    p0 = (float("nan") if nan else x0 - 0.1, y0 - 0.1, z)
    return prim, p0, (x0 + 1.9, y0 - 0.1, z), (x0 - 0.1, y0 + 1.9, z)


def tie_case(device="cuda"):
    """(o, d, t_max, rows, depth) as f32 tensors on `device` (depth an int):
    the tree of the module docstring and 64 rays.  Region A is x in [0, 1],
    region B x in [2, 3], both y in [0, 1]."""
    miss = _tri(999, 10.0, 10.0, 1.0)  # lies outside every ray's reach
    rows = np.stack([
        # 0: the root
        _internal(1, [((0, 0, 0.9), (3, 1, 3)),  # row 1
                      ((0, 0, 2), (1, 1, 2.5)),  # row 2
                      ((2, 0, 0.9), (3, 1, 1.1))]),  # row 3
        # 1: region A's leaves and region B's far leaf
        _internal(4, [((0, 0, 1.5), (1, 1, 1.5)),  # row 4, farther
                      ((0, 0, 1.0), (1, 1, 1.8)),  # row 5
                      ((0, 0, 1.0), (1, 1, 1.8)),  # row 6, at row 5's entry distance
                      ((2, 0, 3.0), (3, 1, 3.0))]),  # row 7
        # 2: one child, row 8
        _internal(8, [((0, 0, 2.0), (1, 1, 2.0))]),
        # 3: region B, a NaN triangle beside one at t = 1
        _leaf([_tri(30, 2.0, 0.0, 1.0, nan=True), _tri(31, 2.0, 0.0, 1.0)]),
        # 4..8
        _leaf([_tri(40, 0.0, 0.0, 1.5)]),
        _leaf([_tri(50, 0.0, 0.0, 1.8), miss, miss, _tri(53, 0.0, 0.0, 1.0), miss, miss, miss,
               _tri(57, 0.0, 0.0, 1.0), miss]),
        _leaf([_tri(60, 0.0, 0.0, 1.0)]),
        _leaf([_tri(70, 2.0, 0.0, 3.0)]),
        _leaf([_tri(80, 0.0, 0.0, 2.0)]),
    ])

    rng = np.random.default_rng(12)
    n_axis = 32
    o = np.zeros((64, 3))
    o[:n_axis, 0] = rng.choice([0.25, 0.5, 2.25, 2.5], n_axis)
    o[:n_axis, 1] = rng.uniform(0.05, 0.45, n_axis)
    d = np.zeros((64, 3))
    d[:n_axis, 2] = 1.0
    t_max = np.full(64, FLT_MAX)
    t_max[0:4] = -1.0  # dead paths
    t_max[4:8] = 0.5  # end before the boxes
    t_max[8:12] = 0.95  # inside the near boxes, before the triangles
    t_max[12:16] = 1.2
    # random rays from below the regions, some toward the gaps between them
    o[n_axis:, 0] = rng.uniform(-0.5, 3.5, 64 - n_axis)
    o[n_axis:, 1] = rng.uniform(-0.5, 1.5, 64 - n_axis)
    o[n_axis:, 2] = rng.uniform(-1.0, 0.5, 64 - n_axis)
    d[n_axis:] = rng.normal(0.0, 0.3, (64 - n_axis, 3)) + np.array([0.0, 0.0, 1.0])
    d[n_axis:] /= np.linalg.norm(d[n_axis:], axis=1, keepdims=True)
    t_max[n_axis:n_axis + 4] = -1.0
    dev = resolve(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return f32(o), f32(d), f32(t_max), f32(rows), DEPTH
