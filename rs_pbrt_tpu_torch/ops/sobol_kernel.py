"""K1: Sobol' samples for a block of dimensions.

The port of rs_pbrt_tpu/ops/pallas_sobol.py.  ``sobol_dims`` launches the
CUDA kernel (``csrc/sobol.cu``) for CUDA tensors and runs
``sobol_dims_plain``, the same function in plain PyTorch, for CPU tensors.
Both convert u32 -> f32 directly, so both match
``lowdiscrepancy.sobol_sample`` bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import lowdiscrepancy as ld

MAX_DIMS = 64  # shared memory holds n_dims rows of 52 u32
launches = 0  # kernel launches of `sobol_dims`; the plain path does not count

sobol_dims_plain = ld.sobol_samples  # the plain version: the same function in PyTorch


def _kernel():
    fn = _build.load("sobol").rs_sobol_dims
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, P]  # index, mats, out, n, dim0, n_dims, n_bits, stream
    fn.restype = ctypes.c_int
    return fn


def sobol_dims(index: torch.Tensor, dim0: int, n_dims: int, n_bits: int = 52) -> torch.Tensor:
    """(N,) int64 global index -> (N, n_dims) f32 samples of dimensions
    dim0 .. dim0+n_dims-1: the kernel for a CUDA index, the plain version
    for a CPU one.  n_bits is 32 when the caller proves the index fits 32
    bits (samplers.index_bits), else 52."""
    if index.device.type == "cpu":
        return sobol_dims_plain(index, dim0, n_dims, n_bits)
    global launches
    if index.device.type != "cuda":
        raise ValueError(f"sobol_dims: index lies on {index.device}")
    if index.dtype != torch.int64 or index.dim() != 1 or not index.is_contiguous():
        raise ValueError("sobol_dims: index must be a contiguous 1-D int64 tensor")
    if index.shape[0] >= 1 << 31:
        raise ValueError("sobol_dims: at most 2^31 - 1 lanes per launch")
    if not 1 <= n_dims <= MAX_DIMS:
        raise ValueError(f"sobol_dims: n_dims must be in 1..{MAX_DIMS}, got {n_dims}")
    if dim0 < 0 or dim0 + n_dims > ld.NUM_SOBOL_DIMENSIONS:
        raise ValueError(f"sobol_dims: dims {dim0}..{dim0 + n_dims - 1} out of range")
    if n_bits not in (32, 52):
        raise ValueError(f"sobol_dims: n_bits must be 32 or 52, got {n_bits}")
    n = index.shape[0]
    out = torch.empty((n, n_dims), dtype=torch.float32, device=index.device)
    mats = ld.sobol_matrices(index.device, torch.int32)
    with torch.cuda.device(index.device):
        err = _kernel()(index.data_ptr(), mats.data_ptr(), out.data_ptr(), n, dim0, n_dims,
                        n_bits, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sobol kernel launch")
    launches += 1
    return out
