"""H1: Halton samples for a block of dimensions.

The port of the JAX package's ``halton_sample`` and ``halton_sample_dyn``
(rs_pbrt_tpu/ops/lowdiscrepancy.py:259, :276), which its samplers call one
dim at a time.  ``halton_dims`` launches the CUDA kernel
(``csrc/halton.cu``) for CUDA tensors and runs ``halton_dims_plain``
(``lowdiscrepancy.halton_samples``), the same function in plain PyTorch,
for CPU tensors.  Both return the (N, n_dims) samples as the transposed
view of a dims-major (n_dims, N) tensor, and both give the JAX package's
bits.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build
from . import lowdiscrepancy as ld

MAX_DIMS = 128  # dims a launch draws, as K1
launches = 0  # kernel launches of `halton_dims`; the plain path does not count

halton_dims_plain = ld.halton_samples  # the plain version: the same function in PyTorch


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("halton").rs_halton_dims
    P, I = ctypes.c_void_p, ctypes.c_int
    # index, perms, out, n, codes, offs, n_dims, exp_x, scale_y, lo, hi, stream
    fn.argtypes = [P, P, P, I, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def _dims(dim0: int, n_dims: int, clip: bool) -> np.ndarray:
    """The dims the block's rows draw: clipped to [2, 255] where clip."""
    dims = np.arange(dim0, dim0 + n_dims)
    return np.clip(dims, 2, ld.HALTON_MAX_BASES - 1) if clip else dims


def _check_args(index: torch.Tensor, dim0: int, n_dims: int, exp_x: int, scale_y: int,
                clip: bool):
    """Raises on what the kernel does not take, on any device."""
    if index.dtype != torch.int32 or index.dim() != 1 or not index.is_contiguous():
        raise ValueError("halton_dims: index must be a contiguous 1-D int32 tensor")
    if index.shape[0] >= 1 << 31:
        raise ValueError("halton_dims: at most 2^31 - 1 lanes per launch")
    if not 1 <= n_dims <= MAX_DIMS:
        raise ValueError(f"halton_dims: n_dims must be in 1..{MAX_DIMS}, got {n_dims}")
    if dim0 < 0 or _dims(dim0, n_dims, clip).max() >= len(ld.HALTON_PRIMES):
        raise ValueError(f"halton_dims: dims {dim0}..{dim0 + n_dims - 1} out of range")
    if not 0 <= exp_x <= 31 or scale_y < 1:
        raise ValueError(f"halton_dims: bad pixel scales exp_x={exp_x}, scale_y={scale_y}")


def halton_dims(index: torch.Tensor, dim0: int, n_dims: int, exp_x: int, scale_y: int,
                clip: bool = False) -> torch.Tensor:
    """(N,) 32-bit Halton indices, their u32 bits as int32 (as make_ctx
    holds them) -> (N, n_dims) f32 samples of dims
    dim0 .. dim0+n_dims-1 (see ``lowdiscrepancy.halton_samples``): the
    kernel for a CUDA index, the plain version for a CPU one.  exp_x and
    scale_y: the sampler's base-2 pixel digits and base-3 pixel scale
    (``SamplerCfg.halton[2]``, ``[1]``); clip: the traced-dim route."""
    _check_args(index, dim0, n_dims, exp_x, scale_y, clip)
    if index.device.type == "cpu":
        return halton_dims_plain(index, dim0, n_dims, exp_x, scale_y, clip)
    global launches
    if index.device.type != "cuda":
        raise ValueError(f"halton_dims: index lies on {index.device}")
    dims = _dims(dim0, n_dims, clip)
    codes = np.where(dims < 2, dims, ld.HALTON_PRIMES[dims])
    offs = np.where(dims < 2, 0, ld.PRIME_SUMS[dims])
    scr = dims >= 2
    perms, lo, hi = 0, 0, 0  # a block of film dims reads no permutation
    if scr.any():
        perms = ld.halton_perms(index.device, dims.max() + 1).data_ptr()
        lo, hi = int(offs[scr].min()), int((offs + codes)[scr].max())
    n = index.shape[0]
    out = torch.empty((n_dims, n), dtype=torch.float32, device=index.device)
    c_ints = lambda v: (ctypes.c_int * n_dims)(*(int(x) for x in v))
    with torch.cuda.device(index.device):
        err = _kernel()(index.data_ptr(), perms, out.data_ptr(), n, c_ints(codes),
                        c_ints(offs), n_dims, exp_x, scale_y, lo, hi,
                        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "halton kernel launch")
    launches += 1
    return out.t()
