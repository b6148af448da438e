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
SOBOL_MATRIX_SIZE = 52  # direction numbers a dimension: index bits the table covers
INV_2_32 = np.float32(2.3283064365386963e-10)  # 0x1p-32
U32_MASK = (1 << 32) - 1
PRIMES = (2, 3, 5, 7, 11)  # radical_inverse's bases: lightdistrib's Halton points


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


def radical_inverse(base_index: int, a: torch.Tensor, max_digits: int = 32) -> torch.Tensor:
    """Radical inverse of a, (N,) integers below 2^32, in the base_index-th
    prime (lowdiscrepancy.rs:1126); f32 in [0, 1).  The digits are reversed
    in u32 arithmetic (held in int64, wrapped to 32 bits) as the reference
    does; base 2 is the bit reversal."""
    a = a.to(torch.int64) & U32_MASK
    if base_index == 0:
        v = torch.zeros_like(a)
        for i in range(32):
            v = v | (((a >> i) & 1) << (31 - i))
        return u32_to_unit_float(v)
    base = int(PRIMES[base_index])
    n_digits = min(int(np.ceil(32 / np.log2(base))), max_digits)
    inv_base = float(np.float32(1.0 / base))
    reversed_digits = torch.zeros_like(a)
    inv_base_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    cur = a
    for _ in range(n_digits):
        nonzero = cur > 0
        nxt = cur // base
        digit = cur - nxt * base
        reversed_digits = torch.where(nonzero, (reversed_digits * base + digit) & U32_MASK,
                                      reversed_digits)
        inv_base_n = torch.where(nonzero, inv_base_n * inv_base, inv_base_n)
        cur = nxt
    return torch.clamp(reversed_digits.to(torch.float32) * inv_base_n,
                       max=float(ONE_MINUS_EPSILON))


def sobol_samples(index: torch.Tensor, dim0: int, n_dims: int, n_bits: int = 52) -> torch.Tensor:
    """(N,) int64 global index -> (N, n_dims) f32 samples of dimensions
    dim0 .. dim0+n_dims-1, from the low n_bits bits of the index: the XOR of
    the direction numbers the set bits select (lowdiscrepancy.rs:1046).
    The result is the transposed view of a dims-major (n_dims, N) tensor,
    the layout K1 writes."""
    mats = sobol_matrices(index.device)[dim0:dim0 + n_dims]  # (n_dims, 52)
    v = torch.zeros((n_dims, index.shape[0]), dtype=torch.int64, device=index.device)
    for i in range(n_bits):
        bit = (((index >> i) & 1) > 0)[None, :]
        v = v ^ torch.where(bit, mats[:, i:i + 1], 0)
    return u32_to_unit_float(v).t()


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
