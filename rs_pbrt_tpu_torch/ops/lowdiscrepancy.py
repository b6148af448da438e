"""Low-discrepancy sequences as stateless random-access functions on torch
tensors.

The port of the JAX package's ``ops/lowdiscrepancy.py`` (reference
src/core/lowdiscrepancy.rs): the Sobol' sequence, the (0,2)-sequence, the
max-min-distance matrices and the scrambled Halton sequence.  The 52-bit
global sample index is one int64 tensor: the JAX package splits it into u32
hi/lo words only because the TPU has no 64-bit integers.  The bit
arithmetic runs in int64 because torch on the CPU has no shifts for uint32;
32-bit words are masked after each step that can carry past them.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..utils.rng import Pcg32, shuffle
from ..utils.vecmath import ONE_MINUS_EPSILON

_DATA = np.load(Path(__file__).resolve().parent.parent / "data" / "sobol_tables.npz")
_HDATA = np.load(Path(__file__).resolve().parent.parent / "data" / "halton_tables.npz")
HALTON_PRIMES = _HDATA["primes"].astype(np.int64)  # (1000,) the first 1000 primes
PRIME_SUMS = _HDATA["prime_sums"].astype(np.int64)  # (1000,) their prefix sums
C_MAX_MIN_DIST = _HDATA["c_max_min_dist"].astype(np.int64)  # (17, 32) generator columns
SOBOL_MATRICES_32 = _DATA["sobol_matrices_32"]  # (1024, 52) u32
# (m-1, c) rows of the van der Corput index tables as 64-bit words
VDC = (_DATA["vdc_hi"].astype(np.int64) << 32) | _DATA["vdc_lo"].astype(np.int64)  # (25, 50)
VDC_INV = (_DATA["vdc_inv_hi"].astype(np.int64) << 32) | _DATA["vdc_inv_lo"].astype(np.int64)
NUM_SOBOL_DIMENSIONS = 1024
SOBOL_MATRIX_SIZE = 52  # direction numbers a dimension: index bits the table covers
INV_2_32 = np.float32(2.3283064365386963e-10)  # 0x1p-32
U32_MASK = (1 << 32) - 1
PRIMES = tuple(int(p) for p in HALTON_PRIMES[:5])  # radical_inverse's: lightdistrib's points
HALTON_MAX_BASES = 256  # bases the traced-dim Halton route reads (halton_sample_dyn)


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
        return van_der_corput_sample(a)
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


def reverse_bits_32(n: torch.Tensor) -> torch.Tensor:
    """The 32-bit reversal of words held in int64 (lowdiscrepancy.py
    reverse_bits_32)."""
    n = n.to(torch.int64) & U32_MASK
    n = ((n << 16) | (n >> 16)) & U32_MASK
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    return ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)


def multiply_generator(c, a: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """v = C a over GF(2) (lowdiscrepancy.rs:799): the XOR of the columns of
    c (32 ints) selected by the bits of a; only the low n_bits bits of a
    are read (the caller's bound on a)."""
    v = torch.zeros_like(a)
    for i in range(n_bits):
        v = v ^ torch.where(((a >> i) & 1) > 0, int(c[i]), 0)
    return v


def van_der_corput_sample(index: torch.Tensor, scramble=None) -> torch.Tensor:
    """The base-2 radical inverse of 32-bit words, XOR-scrambled
    (lowdiscrepancy.rs:857, random-access form); scramble broadcasts."""
    v = reverse_bits_32(index)
    if scramble is not None:
        v = v ^ scramble
    return u32_to_unit_float(v)


def sobol_02_y_bits(index: torch.Tensor) -> torch.Tensor:
    """The unscrambled second coordinate's word of the (0,2)-sequence point
    of 32-bit indices: Sobol' dimension 1's first 32 direction numbers
    (lowdiscrepancy.rs:919 sobol_2d)."""
    mat = SOBOL_MATRICES_32[1].astype(np.int64)
    return multiply_generator(mat, index.to(torch.int64) & U32_MASK)


def sobol_02(index: torch.Tensor, scramble_x=None, scramble_y=None) -> torch.Tensor:
    """(N, 2) (0,2)-sequence points of 32-bit indices, each coordinate
    XOR-scrambled (lowdiscrepancy.py sobol_02)."""
    y = sobol_02_y_bits(index)
    if scramble_y is not None:
        y = y ^ scramble_y
    return torch.stack([van_der_corput_sample(index, scramble_x), u32_to_unit_float(y)], -1)


def max_min_dist_sample(index: torch.Tensor, matrix_idx: int, scramble=None,
                        n_bits: int = 32) -> torch.Tensor:
    """x in [0, 1) from the max-min-distance matrix C_MAX_MIN_DIST[matrix_idx]
    (lowdiscrepancy.py max_min_dist_sample); n_bits bounds the index."""
    v = multiply_generator(C_MAX_MIN_DIST[matrix_idx], index.to(torch.int64) & U32_MASK, n_bits)
    if scramble is not None:
        v = v ^ scramble
    return u32_to_unit_float(v)


def inverse_radical_inverse_2(inverse: torch.Tensor, n_digits: int) -> torch.Tensor:
    """The index whose base-2 radical inverse has the n_digits digits of
    `inverse` (lowdiscrepancy.rs:788): an n_digits-bit reversal."""
    inverse = inverse.to(torch.int64) & U32_MASK
    index = torch.zeros_like(inverse)
    for _ in range(n_digits):
        index = ((index << 1) | (inverse & 1)) & U32_MASK
        inverse = inverse >> 1
    return index


def inverse_radical_inverse_3(inverse: torch.Tensor, n_digits: int) -> torch.Tensor:
    """Base 3's inverse_radical_inverse (lowdiscrepancy.rs:788)."""
    inverse = inverse.to(torch.int64) & U32_MASK
    index = torch.zeros_like(inverse)
    for _ in range(n_digits):
        index = (index * 3 + inverse % 3) & U32_MASK
        inverse = inverse // 3
    return index


def compute_radical_inverse_permutations(rng: Pcg32 = None, n_bases: int = 1000) -> np.ndarray:
    """The scrambling permutations of the first n_bases prime bases
    (lowdiscrepancy.rs:2165), flat at PRIME_SUMS offsets, uint16: base i's
    Fisher-Yates shuffle draws from the PCG32 stream after every base below
    it, so a prefix equals the reference's whole table's."""
    rng = Pcg32() if rng is None else rng
    n_bases = min(n_bases, len(HALTON_PRIMES))
    perms = np.zeros(int(PRIME_SUMS[n_bases - 1] + HALTON_PRIMES[n_bases - 1]), np.uint16)
    for i in range(n_bases):
        off, base = int(PRIME_SUMS[i]), int(HALTON_PRIMES[i])
        perms[off:off + base] = shuffle(list(range(base)), rng)
    return perms


_halton_host = (0, np.zeros(0, np.uint16))  # (bases built, their permutations)


def halton_permutations(n_bases: int) -> np.ndarray:
    """The host table of at least the first n_bases bases' permutations
    (lowdiscrepancy.py halton_permutations), grown geometrically so that
    deeper dims do not replay the PCG stream each time."""
    global _halton_host
    have = _halton_host[0]
    if n_bases > have:
        grow = min(max(n_bases, 2 * max(have, 32)), len(HALTON_PRIMES))
        _halton_host = (grow, compute_radical_inverse_permutations(n_bases=grow))
    return _halton_host[1]


_halton_dev: dict = {}  # device -> its copy of the host table


def halton_perms(device, n_bases: int) -> torch.Tensor:
    """The flat permutations of at least the first n_bases bases on
    `device`, int16 (every value is below 2^15): one copy a device of the
    host table, uploaded anew only when the host table grows."""
    device = torch.device(device)
    host = halton_permutations(int(n_bases))
    have = _halton_dev.get(device)
    if have is None or have.numel() < host.size:
        have = _halton_dev[device] = torch.as_tensor(host.view(np.int16), device=device)
    return have


def halton_samples(index: torch.Tensor, dim0: int, n_dims: int, base_exp_x: int,
                   base_scale_y: int, clip: bool = False) -> torch.Tensor:
    """(N,) 32-bit Halton global indices (int64, or int32 holding the u32
    bits, as H1 reads them) -> (N, n_dims) f32 samples
    of dims dim0 .. dim0+n_dims-1 (lowdiscrepancy.py halton_sample for each
    dim; the transposed view of a dims-major (n_dims, N) tensor, as H1
    writes it).  Dims 0 and 1 shift out the pixel's digits: the bit
    reversal of index >> base_exp_x and the base-3 radical inverse of
    index // base_scale_y.  Every other dim is the scrambled radical
    inverse in the dim-th prime, its digits' permutation from
    halton_permutations.  clip: each dim clipped to [2, 255] first, as the
    traced-dim route halton_sample_dyn does (the JAX package's path above
    128 dims)."""
    dev = index.device
    a = index.to(torch.int64) & U32_MASK
    dims = np.arange(dim0, dim0 + n_dims)
    if clip:
        dims = np.clip(dims, 2, HALTON_MAX_BASES - 1)
    out = torch.empty((n_dims, a.shape[0]), dtype=torch.float32, device=dev)
    for k in np.flatnonzero(dims < 2):
        out[k] = (van_der_corput_sample(a >> base_exp_x) if dims[k] == 0
                  else radical_inverse(1, a // base_scale_y))
    ks = np.flatnonzero(dims >= 2)
    if len(ks):
        n_bases = int(dims.max()) + 1
        if n_bases > len(HALTON_PRIMES):
            raise ValueError(f"halton: dim {n_bases - 1} has no prime base (at most 999)")
        perms = halton_perms(dev, n_bases)
        sel = torch.as_tensor(dims[ks], device=dev)
        base = torch.as_tensor(HALTON_PRIMES, device=dev)[sel][:, None]  # (K, 1)
        off = torch.as_tensor(PRIME_SUMS, device=dev)[sel][:, None]
        inv_base = 1.0 / base.to(torch.float32)  # f32 1/p: np.float32(1/p) for every prime
        perms = perms.to(torch.int64)
        cur = a[None, :].expand(len(ks), -1)
        rev = torch.zeros_like(cur)
        inv_n = torch.ones(cur.shape, dtype=torch.float32, device=dev)
        # every base from 5 on has at most 14 digits below 2^32 (5^14 > 2^32)
        for _ in range(14):
            nonzero = cur > 0
            nxt = cur // base
            pdigit = perms[off + cur - nxt * base]
            rev = torch.where(nonzero, (rev * base + pdigit) & U32_MASK, rev)
            inv_n = torch.where(nonzero, inv_n * inv_base, inv_n)
            cur = nxt
        tail = inv_base * perms[off].to(torch.float32) / (1.0 - inv_base)
        out[torch.as_tensor(ks, device=dev)] = torch.clamp(
            inv_n * (rev.to(torch.float32) + tail), max=float(ONE_MINUS_EPSILON))
    return out.t()
