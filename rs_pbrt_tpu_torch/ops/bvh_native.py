"""ctypes binding of the host BVH builder (``csrc/lbvh.cpp``).

The port of the JAX package's ``ops/bvh_native.py`` for the two trees the
port traverses: a binned-SAH binary tree (``rs_sah_build``), collapsed into
12-wide 512-byte rows (``rs_wide12_build``) for triangles, and kept binary
for curve segments (``build_binary_native``).  ``ops/_build.py`` compiles
the source with the host C++ compiler at first use; the JAX package's
prebuilt library is not used.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

W12_COLS = 128  # f32 columns of a wide12 row (512 bytes)

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = _build.load("lbvh")
    if not _ready:
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.rs_sah_build.argtypes = [f32p, f32p, ctypes.c_int, i32p, i32p, f32p, f32p, f32p,
                                     f32p, i32p]
        lib.rs_sah_build.restype = ctypes.c_int
        lib.rs_wide12_build.argtypes = [i32p, i32p, f32p, f32p, f32p, f32p, i32p, f32p, f32p,
                                        f32p, ctypes.c_int, f32p, ctypes.c_long, i32p]
        lib.rs_wide12_build.restype = ctypes.c_long
        _ready = True
    return lib


def _wide12(child_l, child_r, bmin_l, bmax_l, bmin_r, bmax_r, prim_ids, p0, p1, p2):
    """(rows (M, 128) f32, depth) of a binary tree over triangles p0, p1, p2."""
    lib = _lib()
    n = len(prim_ids)
    assert n < (1 << 24), "wide ids exceed exact-f32 range"
    c32 = lambda a, t: np.ascontiguousarray(a, t)
    args = [c32(child_l, np.int32), c32(child_r, np.int32), c32(bmin_l, np.float32),
            c32(bmax_l, np.float32), c32(bmin_r, np.float32), c32(bmax_r, np.float32),
            c32(prim_ids, np.int32), c32(p0, np.float32), c32(p1, np.float32),
            c32(p2, np.float32)]
    rows = np.empty((2 * n + 8, W12_COLS), np.float32)
    depth = np.zeros(1, np.int32)
    ret = lib.rs_wide12_build(*args, n, rows, rows.size, depth)
    if ret < 0:
        rows = np.empty((-ret, W12_COLS), np.float32)
        ret = lib.rs_wide12_build(*args, n, rows, rows.size, depth)
    if ret <= 0:
        raise RuntimeError(f"rs_wide12_build failed ret={ret}")
    # the child-group base (col 72) is a row id stored as f32: the returned
    # row count, not n, bounds it
    assert ret < (1 << 24), "wide row ids exceed exact-f32 range"
    return np.ascontiguousarray(rows[:ret]), int(depth[0])


def _sah_binary(bmin, bmax):
    """rs_sah_build's arrays over n >= 2 boxes: child_l, child_r (n-1,),
    bmin_l, bmax_l, bmin_r, bmax_r (n-1, 3), prim_ids (n,)."""
    n = bmin.shape[0]
    m = n - 1
    child_l = np.empty(m, np.int32)
    child_r = np.empty(m, np.int32)
    boxes = [np.empty((m, 3), np.float32) for _ in range(4)]
    prim_ids = np.empty(n, np.int32)
    rc = _lib().rs_sah_build(bmin, bmax, n, child_l, child_r, *boxes, prim_ids)
    if rc != 0:
        raise RuntimeError(f"rs_sah_build failed rc={rc}")
    return (child_l, child_r, *boxes, prim_ids)


def build_binary_native(bmin, bmax) -> dict:
    """The binary SAH tree over boxes bmin, bmax (N, 3) as rs_sah_build
    gives it: child_l, child_r (N-1,) int32 (>= 0 a node, else the leaf
    ~position), bmin_l, bmax_l, bmin_r, bmax_r (N-1, 3) f32 and prim_ids
    (N,) int32, the JAX LBVH's fields of these names (the tree the JAX
    package gives curves, build_lbvh_native with lean=False).  A single
    box gives the JAX build_lbvh's one node whose two children are that
    leaf."""
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    if n < 1:
        raise ValueError("a BVH needs at least one primitive")
    if n == 1:
        leaf = np.full(1, -1, np.int32)
        arrays = (leaf, leaf.copy(), bmin[:1], bmax[:1], bmin[:1].copy(), bmax[:1].copy(),
                  np.zeros(1, np.int32))
    else:
        arrays = _sah_binary(bmin, bmax)
    names = ("child_l", "child_r", "bmin_l", "bmax_l", "bmin_r", "bmax_r", "prim_ids")
    return dict(zip(names, arrays))


def build_lbvh_native(bmin, bmax, tris):
    """bmin, bmax: (N, 3) f32 boxes of the triangles tris = (p0, p1, p2),
    each (N, 3) -> (rows (M, 128) np.float32, depth): the SAH tree's
    12-wide rows and the wide tree's depth (the root is depth 1)."""
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    if n < 1:
        raise ValueError("a BVH needs at least one triangle")
    if n == 1:
        # a single primitive: the binary builder would emit a fake root with
        # a duplicated leaf; the wide build takes it as one leaf row directly
        z1 = np.zeros(1, np.int32)
        z3 = np.zeros((1, 3), np.float32)
        return _wide12(z1, z1, z3, z3, z3, z3, z1, *tris)
    return _wide12(*_sah_binary(bmin, bmax), *tris)
