"""Sobol' sequence as stateless random-access functions on torch tensors.

The port's copy of the Sobol' parts of the JAX package's
``ops/lowdiscrepancy.py`` (reference src/core/lowdiscrepancy.rs).  The
52-bit global sample index is one int64 tensor: the JAX package splits it
into u32 hi/lo words only because the TPU has no 64-bit integers.  The bit
arithmetic runs in int64 because torch on the CPU has no shifts for uint32.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..utils.vecmath import ONE_MINUS_EPSILON

_DATA = np.load(Path(__file__).resolve().parent.parent / "data" / "sobol_tables.npz")
SOBOL_MATRICES_32 = _DATA["sobol_matrices_32"]  # (1024, 52) u32
# (m-1, c) rows of the van der Corput index tables as 64-bit words
VDC = (_DATA["vdc_hi"].astype(np.int64) << 32) | _DATA["vdc_lo"].astype(np.int64)  # (25, 50)
VDC_INV = (_DATA["vdc_inv_hi"].astype(np.int64) << 32) | _DATA["vdc_inv_lo"].astype(np.int64)
NUM_SOBOL_DIMENSIONS = 1024
INV_2_32 = np.float32(2.3283064365386963e-10)  # 0x1p-32


@lru_cache(maxsize=None)
def sobol_matrices(device: torch.device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """The (1024, 52) direction-number table on `device`: int64 values for
    the plain versions, or the same u32 bits as int32 for the kernels."""
    m = SOBOL_MATRICES_32.astype(np.int64) if dtype == torch.int64 else SOBOL_MATRICES_32.view(np.int32)
    return torch.as_tensor(m, device=device)


def u32_to_unit_float(v: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> f32 in [0, 1): the direct round-to-nearest
    conversion, times 2^-32, clamped below 1 (lowdiscrepancy.rs:1046)."""
    return torch.clamp(v.to(torch.float32) * INV_2_32, max=float(ONE_MINUS_EPSILON))


def sobol_samples(index: torch.Tensor, dim0: int, n_dims: int, n_bits: int = 52) -> torch.Tensor:
    """(N,) int64 global index -> (N, n_dims) f32 samples of dimensions
    dim0 .. dim0+n_dims-1, from the low n_bits bits of the index: the XOR of
    the direction numbers the set bits select (lowdiscrepancy.rs:1046)."""
    mats = sobol_matrices(index.device)[dim0:dim0 + n_dims]  # (n_dims, 52)
    v = torch.zeros((index.shape[0], n_dims), dtype=torch.int64, device=index.device)
    for i in range(n_bits):
        bit = (((index >> i) & 1) > 0)[:, None]
        v = v ^ torch.where(bit, mats[None, :, i], 0)
    return u32_to_unit_float(v)


def sobol_sample(index: torch.Tensor, dimension: int) -> torch.Tensor:
    """Sobol' sample of dimension `dimension` for int64 global indices."""
    return sobol_samples(index, dimension, 1)[:, 0]


def sobol_interval_to_index(m: int, frame: torch.Tensor, p: torch.Tensor,
                            max_frame_bits: int = 32) -> torch.Tensor:
    """Global index of sample `frame` in pixel p when the Sobol' domain is
    scaled to 2^m x 2^m pixels (lowdiscrepancy.rs:1014).

    frame: (N,) int64 sample numbers; p: (N, 2) integer pixels.  Returns the
    (N,) int64 index; max_frame_bits bounds the bits of `frame` read."""
    frame = frame.to(torch.int64)
    if m == 0:
        return frame
    dev = frame.device
    index = frame << (2 * m)
    row = torch.as_tensor(VDC[m - 1], device=dev)
    delta = torch.zeros_like(frame)
    for c in range(min(max_frame_bits, VDC.shape[1])):
        delta = delta ^ torch.where(((frame >> c) & 1) > 0, row[c], 0)
    p = p.to(torch.int64)
    b = ((p[..., 0] << m) ^ p[..., 1]) ^ delta
    inv = torch.as_tensor(VDC_INV[m - 1], device=dev)
    for c in range(2 * m):
        index = index ^ torch.where(((b >> c) & 1) > 0, inv[c], 0)
    return index
