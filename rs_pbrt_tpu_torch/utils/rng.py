"""Random numbers: the stateless hash RNG, and the reference's PCG32.

The port of the JAX package's ``utils/rng.py``: a lowbias32-style integer
hash and a boost-style combine (the reference draws from a per-thread
Pcg32, src/core/rng.rs, which a counter-based hash replaces so that any
lane order gives the same numbers), from which the random, stratified,
zerotwo and maxmin samplers and SPPM's photon pass draw; and ``Pcg32`` with
``shuffle`` on the host, which build the Halton sampler's permutations.

torch has no wrapping uint32 arithmetic on every device, so the words are
held in int64 and masked to 32 bits after each step.  A product of a word
with a constant of 32 bits would overflow int64, so it is taken in two
halves of 16 bits (``_mul32``).  The results are the JAX package's bits.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
FLOAT_ONE_MINUS_EPSILON = float(np.float32(1.0 - np.finfo(np.float32).eps / 2))
TWO_POW_M32 = float(np.float32(2.3283064365386963e-10))  # 2^-32


def _u32(x):
    """x as int64 words of 32 bits: a tensor, or a Python int (a key shared
    by every lane)."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for words x and a constant c below 2^32, without
    overflowing int64: the high half of c's product keeps its low 16 bits."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & M32


def hash_u32(x):
    """The lowbias32 finalizer (rng.py hash_u32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_combine(a, b):
    """hash_u32(a ^ (b + 0x9E3779B9 + (a << 6) + (a >> 2))), mod 2^32."""
    a, b = _u32(a), _u32(b)
    mixed = (b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32
    return hash_u32(a ^ mixed)


def uniform_u32(*keys):
    """A uniform word of 32 bits (int64) from any number of integer keys
    (tensors that broadcast, or Python ints)."""
    h = _u32(keys[0])
    for k in keys[1:]:
        h = hash_combine(h, k)
    return hash_u32(h)


def to_float(bits: torch.Tensor) -> torch.Tensor:
    """Words of 32 bits -> uniforms in [0, 1): the word rounded to f32 (as
    numpy's uint32 -> float32 rounds), times 2^-32, below 1."""
    return torch.clamp(bits.to(torch.float32) * TWO_POW_M32, max=FLOAT_ONE_MINUS_EPSILON)


def uniform_float(*keys) -> torch.Tensor:
    """A uniform in [0, 1) from integer keys (rng.py uniform_float)."""
    return to_float(uniform_u32(*keys))


# ---- the reference's PCG32, on the host ----

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D
_M64 = (1 << 64) - 1


class Pcg32:
    """The reference's PCG32 (src/core/rng.rs:21-82) in Python integers:
    stateful and sequential, for host-side tables (the Halton
    permutations).  The same stream as the JAX package's ``Pcg32``."""

    def __init__(self, init_state=None, init_seq=None):
        if init_state is None:
            self.state = PCG32_DEFAULT_STATE
            self.inc = PCG32_DEFAULT_STREAM
        else:
            self.state = 0
            self.inc = ((int(init_seq) << 1) | 1) & _M64
            self.uniform_uint32()
            self.state = (self.state + int(init_state)) & _M64
            self.uniform_uint32()

    def uniform_uint32(self) -> int:
        old = self.state
        self.state = (old * PCG32_MULT + self.inc) & _M64
        xorshifted = (((old >> 18) ^ old) >> 27) & M32
        rot = (old >> 59) & 31
        return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & M32

    def uniform_uint32_bounded(self, b: int) -> int:
        """Uniform in [0, b) by rejection (rng.rs uniform_uint32_bounded)."""
        threshold = (~b + 1) % b if b else 0
        while True:
            r = self.uniform_uint32()
            if r >= threshold:
                return r % b


def shuffle(arr, rng: Pcg32, n_dims: int = 1):
    """In-place Fisher-Yates of arr's groups of n_dims (sampling.rs
    shuffle); returns arr."""
    count = len(arr) // n_dims
    for i in range(count):
        other = i + rng.uniform_uint32_bounded(count - i)
        for j in range(n_dims):
            k1, k2 = n_dims * i + j, n_dims * other + j
            arr[k1], arr[k2] = arr[k2], arr[k1]
    return arr
