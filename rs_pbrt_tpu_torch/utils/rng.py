"""The stateless hash RNG: uniform numbers as a function of integer keys.

The port of the hash half of the JAX package's ``utils/rng.py`` (a
lowbias32-style integer hash and a boost-style combine; the reference draws
from a per-thread Pcg32, src/core/rng.rs, which a counter-based hash
replaces so that any lane order gives the same numbers).  The random
sampler and SPPM's photon pass draw from it.

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
