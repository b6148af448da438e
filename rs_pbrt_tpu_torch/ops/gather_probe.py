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
CUDA kernel (``csrc/gather_probe.cu``: each block stages one row of tab in
shared memory) for CUDA tensors and runs its plain version for CPU
tensors.
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


def take_loop_plain(tab: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    acc = torch.zeros_like(tab)
    for _ in range(steps):
        g = torch.gather(tab, 1, idx.long())
        idx = lcg_step(idx, tab.shape[1])
        acc = acc + g
    return acc


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # tab, idx, rows, cols, [steps], out, stream
    "rs_take_rows": [_P, _P, _I, _I, _P, _P],
    "rs_take_loop": [_P, _P, _I, _I, _I, _P, _P],
}


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
    # idx is trusted to lie in [0, cols), as the TPU kernel trusts it


def take_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 for CUDA tensors, take_rows_plain for CPU ones."""
    if tab.device.type == "cpu":
        return take_rows_plain(tab, idx)
    _check("take_rows", tab, idx)
    out = torch.empty_like(tab)
    with torch.cuda.device(tab.device):
        err = _kernel("rs_take_rows")(tab.data_ptr(), idx.data_ptr(), tab.shape[0], tab.shape[1],
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "take_rows kernel launch")
    launches["take_rows"] += 1
    return out


def take_loop(tab: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """P2 for CUDA tensors, take_loop_plain for CPU ones."""
    if tab.device.type == "cpu":
        return take_loop_plain(tab, idx, steps)
    _check("take_loop", tab, idx)
    out = torch.empty_like(tab)
    with torch.cuda.device(tab.device):
        err = _kernel("rs_take_loop")(tab.data_ptr(), idx.data_ptr(), tab.shape[0], tab.shape[1],
                                      steps, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    _build.check(err, "take_loop kernel launch")
    launches["take_loop"] += 1
    return out
