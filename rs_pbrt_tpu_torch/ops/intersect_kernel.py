"""K3, K4, K5: dense ray-triangle sweeps.

The port of rs_pbrt_tpu/ops/pallas_intersect.py.  Each wrapper launches
its CUDA kernel (``csrc/intersect.cu``) for CUDA tensors and runs its plain
PyTorch version for CPU tensors:

- ``closest_sweep`` (K3): the closest watertight hit -> TriHit (valid, t,
  tri, b0, b1); a miss gives tri -1 and t = t_max.
- ``any_sweep`` (K4): the occlusion bit, any hit in (0, t_max).
- ``full_sweep`` (K5): the closest hit fused with its hit record
  (scene_intersect._tri_interaction) -> FullHit.

Rays are o, d (N, 3) and t_max (N,) f32; the table is (T, C) f32 with the
vertex coordinates in its first 9 columns (K5 reads the whole tri_attr
row, C = N_TRI_ATTR), swept over rows 0 .. n_tri-1.  The TPU kernels padded
the table to a multiple of 8 zero rows and the rays to 8192 lanes; these
loop exactly n_tri rows over exactly N rays.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..scene import arrays as sa
from . import _build
from .autodiff import refuse_grad
from .intersect import TriHit
from .record import tri_record
from .watertight import any_sweep as _any_sweep_tuples
from .watertight import closest_sweep as _closest_sweep_tuples

# kernel launches of each wrapper; the plain versions do not count
launches = {"closest_sweep": 0, "any_sweep": 0, "full_sweep": 0}

# K5's rows: f32 (18, N), int32 (3, N)
F_T, F_P, F_P_ERR, F_NG, F_NS, F_UV, F_DPDU = 0, 1, 4, 7, 10, 13, 15
N_F_ROWS = 18
I_PRIM, I_MAT, I_LIGHT = 0, 1, 2


class FullHit(NamedTuple):
    """K5's output: the hit record as rows of N."""

    rows: torch.Tensor  # (18, N) f32: t, p, p_err, ng, ns, u, v, dpdu
    ids: torch.Tensor  # (3, N) int32: prim (-1 on a miss), mat, light

    def vec(self, row: int, width: int = 3) -> torch.Tensor:
        """(N, width) view of rows row .. row+width-1."""
        return self.rows[row:row + width].T

    @property
    def valid(self):
        return self.ids[I_PRIM] >= 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _split(v: torch.Tensor):
    return tuple(v.unbind(-1))


def closest_sweep_plain(o, d, t_max, tris, n_tri: int) -> TriHit:
    bt, bi, b0, b1 = _closest_sweep_tuples(tris, n_tri, _split(o), _split(d), t_max)
    valid = bi >= 0
    return TriHit(valid, torch.where(valid, bt, t_max), bi, b0, b1)


def any_sweep_plain(o, d, t_max, tris, n_tri: int) -> torch.Tensor:
    return _any_sweep_tuples(tris, n_tri, _split(o), _split(d), t_max)


def full_sweep_plain(o, d, t_max, tris, n_tri: int) -> FullHit:
    bt, bi, b0, b1 = _closest_sweep_tuples(tris, n_tri, _split(o), _split(d), t_max)
    rec = tri_record(tris, bi, b0, b1)
    miss = bi < 0
    rows = torch.stack([torch.where(miss, t_max, bt), *rec.p, *rec.p_err, *rec.ng, *rec.ns,
                        *rec.uv, *rec.dpdu])
    ids = torch.stack([bi, torch.where(miss, 0, rec.mat), torch.where(miss, -1, rec.light)])
    return FullHit(rows, ids.to(torch.int32))


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # o, d, tmax, n, tris, n_tri, [cols], outputs..., stream
    "rs_closest_sweep": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    "rs_any_sweep": [_P, _P, _P, _I, _P, _I, _I, _P, _P],
    "rs_full_sweep": [_P, _P, _P, _I, _P, _I, _P, _P, _P],
}


def _kernel(name: str):
    fn = getattr(_build.load("intersect"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(what, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} lies on {t.device}, expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def _check_inputs(what, o, d, t_max, tris, n_tri, cols=None):
    n = o.shape[0]
    _check(what, "o", o, torch.float32, (n, 3))
    _check(what, "d", d, torch.float32, (n, 3))
    _check(what, "t_max", t_max, torch.float32, (n,))
    if tris.dim() != 2 or tris.shape[1] < 9:
        raise ValueError(f"{what}: the table needs the 9 vertex coordinates a row")
    _check(what, "tris", tris, torch.float32, (tris.shape[0], cols or tris.shape[1]))
    if not 0 <= n_tri <= tris.shape[0]:
        raise ValueError(f"{what}: n_tri {n_tri} outside the table's {tris.shape[0]} rows")
    if n >= 1 << 31:
        raise ValueError(f"{what}: at most 2^31 - 1 rays per launch")
    return n


def _stream():
    return torch.cuda.current_stream().cuda_stream


def closest_sweep(o, d, t_max, tris, n_tri: int) -> TriHit:
    """K3: the kernel for CUDA tensors, closest_sweep_plain for CPU ones."""
    refuse_grad("closest_sweep (K3; the differentiable hit is scene_intersect.tri_hit)", o,
                d, t_max, tris)
    if o.device.type == "cpu":
        return closest_sweep_plain(o, d, t_max, tris, n_tri)
    n = _check_inputs("closest_sweep", o, d, t_max, tris, n_tri)
    t = torch.empty_like(t_max)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    b0 = torch.empty_like(t_max)
    b1 = torch.empty_like(t_max)
    with torch.cuda.device(o.device):
        err = _kernel("rs_closest_sweep")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, tris.data_ptr(), n_tri,
            tris.shape[1], t.data_ptr(), tri.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            _stream())
    _build.check(err, "closest_sweep kernel launch")
    launches["closest_sweep"] += 1
    return TriHit(tri >= 0, t, tri, b0, b1)


def any_sweep(o, d, t_max, tris, n_tri: int) -> torch.Tensor:
    """K4: the kernel for CUDA tensors, any_sweep_plain for CPU ones.
    Returns the (N,) bool occlusion mask."""
    if o.device.type == "cpu":
        return any_sweep_plain(o, d, t_max, tris, n_tri)
    n = _check_inputs("any_sweep", o, d, t_max, tris, n_tri)
    occ = torch.empty(n, dtype=torch.bool, device=o.device)  # one byte, 0 or 1
    with torch.cuda.device(o.device):
        err = _kernel("rs_any_sweep")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, tris.data_ptr(), n_tri,
            tris.shape[1], occ.data_ptr(), _stream())
    _build.check(err, "any_sweep kernel launch")
    launches["any_sweep"] += 1
    return occ


def full_sweep(o, d, t_max, tris, n_tri: int) -> FullHit:
    """K5: the kernel for CUDA tensors, full_sweep_plain for CPU ones.
    tris is the scene's (T, N_TRI_ATTR) tri_attr."""
    refuse_grad("full_sweep (K5, whose record has no backward: scene_intersect takes "
                "tri_hit and tri_record)", o, d, t_max, tris)
    if o.device.type == "cpu":
        return full_sweep_plain(o, d, t_max, tris, n_tri)
    n = _check_inputs("full_sweep", o, d, t_max, tris, n_tri, cols=sa.N_TRI_ATTR)
    rows = torch.empty((N_F_ROWS, n), dtype=torch.float32, device=o.device)
    ids = torch.empty((3, n), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        err = _kernel("rs_full_sweep")(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, tris.data_ptr(), n_tri,
            rows.data_ptr(), ids.data_ptr(), _stream())
    _build.check(err, "full_sweep kernel launch")
    launches["full_sweep"] += 1
    return FullHit(rows, ids)
