"""P1, P2: the gather probe's kernels, gathers from on-chip memory.

The port of the two Pallas kernels of the JAX package's round-4 probe,
``tools/tpu_probe.py`` part 3, which measures how fast a kernel gathers
from its fast on-chip memory (the TPU's VMEM; shared memory here), the
question that decides how a BVH traversal fetches its rows:

- ``take_rows`` (P1, ``kern``): ``out[r, c] = tab[r, idx[r, c]]``;
- ``take_loop`` (P2, ``kern_loop``): ``steps`` times, ``acc += gather``
  then ``idx = rem(idx * 1103515245 + 12345, C)``, ``+ C`` where negative,
  in int32 with wraparound; returns ``acc`` (f32 sums in step order).

tab is (R, C) f32, idx (R, C) int32 in [0, C).  Each wrapper launches its
CUDA kernel (``csrc/gather_probe.cu``) for CUDA tensors and runs its plain
version for CPU tensors.  P2 takes one of two paths by C: for C a power of
two the update is an affine map mod 2^32 masked to C, and ``lcg_jump``
gives the constants of several steps in one; for other C the remainder
takes ``rem_magic``'s multiplier and shift.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve
from . import _build

LCG_MUL, LCG_ADD = 1103515245, 12345
STEPS = 1000  # P2's loop length in the JAX probe
SMEM_BYTES = 232448  # the shared memory a block may use on Hopper (227 KB)
JUMP = 8  # P2's steps whose loads are in flight together (kJump in csrc/gather_probe.cu)
_M32 = (1 << 32) - 1

# kernel launches of each wrapper; the plain versions do not count
launches = {"take_rows": 0, "take_loop": 0}


def probe_inputs(rows: int = 16, cols: int = 2048, seed: int = 0, device="cuda"):
    """(tab (rows, cols) f32 uniform in [0, 1), idx (rows, cols) int32 in
    [0, cols)) from a numpy seed, as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    dev = resolve(device)
    tab = torch.tensor(rng.rand(rows, cols).astype(np.float32), device=dev)
    idx = torch.tensor(rng.randint(0, cols, (rows, cols)).astype(np.int32), device=dev)
    return tab, idx


def take_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.long())


def lcg_step(idx: torch.Tensor, cols: int) -> torch.Tensor:
    """The probe's index update in int32 arithmetic with wraparound:
    computed in int64, cut to 32 bits, then truncating remainder (as
    lax.rem; torch.fmod) and + cols where negative."""
    v = (idx.long() * LCG_MUL + LCG_ADD) & 0xFFFFFFFF
    v = torch.where(v >= 1 << 31, v - (1 << 32), v)
    v = torch.fmod(v, cols)
    return torch.where(v < 0, v + cols, v).to(torch.int32)


def lcg_jump(k: int) -> tuple:
    """(A_k, B_k), uint32: k steps of the update before the remainder in
    one, x -> A_k x + B_k mod 2^32.  For C dividing 2^32 the remainder of
    the int32 reinterpretation, + C where negative, is that value & (C - 1),
    so k steps of ``lcg_step`` are x -> (A_k x + B_k) & (C - 1)."""
    a, b = 1, 0
    for _ in range(k):
        a, b = (a * LCG_MUL) & _M32, (b * LCG_MUL + LCG_ADD) & _M32
    return a, b


def rem_magic(cols: int) -> tuple:
    """(mul, shift, add) such that, in int32 arithmetic with wraparound,
    q = ((mulhi(mul, v) + (v & add)) >> shift) + (v < 0) is v / cols
    truncated for every int32 v (mulhi: the high 32 bits of the 64-bit
    product; >> arithmetic), for 1 <= cols < 2^16.

    M = floor(2^p / cols) + 1 for the least p >= 32 with
    (M cols - 2^p) 2^31 <= 2^p, which bounds the product's error below
    one step of v / cols on either side of 0; mul is M, less 2^32 where
    M >= 2^31, and then add = -1 puts v back (mulhi by M - 2^32 is
    floor(M v / 2^32) - v).  shift = p - 32 > 0 needs M <= 2^32, so that
    floor(M v / 2^32) fits int32; at shift 0 (cols 1 only needs it) the
    sum may wrap, since q is right modulo 2^32."""
    if not 1 <= cols < 1 << 16:
        raise ValueError(f"rem_magic: cols {cols} outside [1, 2^16)")
    for p in range(32, 64):
        m = (1 << p) // cols + 1
        if (m * cols - (1 << p)) << 31 > 1 << p:
            continue
        if m < 1 << 31:
            return m, p - 32, 0
        if m <= 1 << 32 or (p == 32 and m < 3 << 31):
            return m - (1 << 32), p - 32, -1
    raise AssertionError(f"rem_magic: no multiplier for {cols}")


def take_loop_plain(tab: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    acc = torch.zeros_like(tab)
    for _ in range(steps):
        g = torch.gather(tab, 1, idx.long())
        idx = lcg_step(idx, tab.shape[1])
        acc = acc + g
    return acc


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # tab, idx, rows, cols, out, stream
    "rs_take_rows": [_P, _P, _I, _I, _P, _P],
    # tab, idx, rows, cols, steps, jump, magic (mul, shift, add), out, stream
    "rs_take_loop": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
}
# (A_j, 4 B_j) for j = 1..JUMP: the power-of-two path keeps the index as a
# byte offset, which the same map moves with 4 B_j and mask 4 C - 1
_JUMP_ARG = (ctypes.c_uint32 * (2 * JUMP))(*[
    v for j in range(1, JUMP + 1) for v in (lcg_jump(j)[0], 4 * lcg_jump(j)[1] & _M32)])


def _kernel(name: str):
    fn = getattr(_build.load("gather_probe"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(what, tab, idx):
    for name, t, dtype in (("tab", tab, torch.float32), ("idx", idx, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 2-D {dtype} CUDA tensor")
    if idx.shape != tab.shape:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} and tab {tuple(tab.shape)} differ")
    if tab.shape[1] * 4 > SMEM_BYTES:
        raise ValueError(f"{what}: a row of {tab.shape[1]} floats does not fit a block's "
                         f"{SMEM_BYTES} bytes of shared memory")
    if tab.numel() >= 1 << 31:
        raise ValueError(f"{what}: {tab.numel()} elements, the kernels take fewer than 2^31")
    # idx is trusted to lie in [0, cols), as the TPU kernel trusts it


def take_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 for CUDA tensors, take_rows_plain for CPU ones."""
    if tab.device.type == "cpu":
        return take_rows_plain(tab, idx)
    _check("take_rows", tab, idx)
    out = torch.empty_like(tab)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tab.device):
        err = _kernel("rs_take_rows")(tab.data_ptr(), idx.data_ptr(), tab.shape[0], tab.shape[1],
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "take_rows kernel launch")
    launches["take_rows"] += 1
    return out


def take_loop(tab: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """P2 for CUDA tensors, take_loop_plain for CPU ones.  The kernel takes
    its power-of-two path where C is a power of two, else the remainder by
    rem_magic(C)."""
    if tab.device.type == "cpu":
        return take_loop_plain(tab, idx, steps)
    _check("take_loop", tab, idx)
    out = torch.empty_like(tab)
    if out.numel() == 0:
        return out
    rows, cols = tab.shape
    with torch.cuda.device(tab.device):
        err = _kernel("rs_take_loop")(tab.data_ptr(), idx.data_ptr(), rows, cols, steps,
                                      ctypes.addressof(_JUMP_ARG), *rem_magic(cols),
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "take_loop kernel launch")
    launches["take_loop"] += 1
    return out
