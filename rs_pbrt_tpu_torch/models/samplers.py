"""Samplers as stateless index math: value = f(pixel, sample, dimension).

The port of the Sobol' and random parts of the JAX package's
``models/samplers.py`` (reference src/core/sampler.rs, samplers/sobol.rs,
samplers/random.rs).  Sobol' dims come from K1; the random sampler's from
the stateless hash of ``utils/rng.py`` of (pixel, sample, dim, seed), as in
the JAX package.  Dimension budget: dims 0,1 film xy, dim 2 time, dims 3,4
lens uv, dims 5+ the integrator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import lowdiscrepancy as ld
from ..ops import sobol_kernel as sk
from ..utils import rng as rngmod
from ..utils.vecmath import ONE_MINUS_EPSILON

# numbered as in the JAX package; the other kinds come with their slice
SOBOL = 0
RANDOM = 1
PORTED_SAMPLERS = (SOBOL, RANDOM)


class SamplerCfg(NamedTuple):
    kind: int
    spp: int
    log2_resolution: int  # Sobol' pixel-domain scaling
    seed: int


def make_sampler(kind: int, spp: int, resolution=(1, 1), seed: int = 0) -> SamplerCfg:
    """Sampler config; Sobol' rounds spp up to a power of two (sobol.rs:40)."""
    if kind not in PORTED_SAMPLERS:
        raise NotImplementedError(
            "rs_pbrt_tpu_torch has only the Sobol' and random samplers so far (ROADMAP A24b)")
    log2res = int(np.ceil(np.log2(max(resolution[0], resolution[1], 1))))
    if kind == SOBOL and spp & (spp - 1):
        spp = 1 << int(np.ceil(np.log2(spp)))
    return SamplerCfg(kind, spp, log2res, seed)


def index_bits(cfg: SamplerCfg) -> int:
    """Width of the global index: it is below spp << 2*log2res
    (lowdiscrepancy.rs:1014), so 32 bits when that fits, else 52.  K2
    (path_kernel.bounce) takes this width."""
    return 32 if cfg.spp * (4 ** cfg.log2_resolution) <= (1 << 32) else 52


def exact_index_bits(cfg: SamplerCfg) -> int:
    """The global index's exact width when every sample number is below
    spp: sample << 2*log2res XOR bits below 2*log2res (lowdiscrepancy.rs:
    1014), so ceil(log2 spp) + 2*log2res bits, at least 1, at most the 52
    the direction numbers cover."""
    return min(ld.SOBOL_MATRIX_SIZE,
               max(1, (cfg.spp - 1).bit_length() + 2 * cfg.log2_resolution))


class SampleCtx(NamedTuple):
    pixel: torch.Tensor  # (N, 2) int64
    sample_num: torch.Tensor  # (N,) int64
    global_index: torch.Tensor  # (N,) int64 Sobol' global index
    # a block of dims drawn ahead in one K1 launch (with_dims): its first
    # dim and its (N, n) samples
    block0: int = 0
    block: Optional[torch.Tensor] = None
    # the caller's promise that sample_num < spp on every lane (make_ctx)
    frame_lt_spp: bool = False


def make_ctx(cfg: SamplerCfg, pixel, sample_num, frame_lt_spp: bool = False) -> SampleCtx:
    """frame_lt_spp: the caller promises sample_num < cfg.spp on every lane,
    which bounds the frame bits read to ceil(log2 spp) and the index to
    exact_index_bits; the context records it for get_dims.  The random
    sampler has no index (zeros, as in the JAX package)."""
    pixel = pixel.to(torch.int64)
    sample_num = sample_num.to(torch.int64)
    if cfg.kind == RANDOM:
        return SampleCtx(pixel, sample_num, torch.zeros_like(sample_num),
                         frame_lt_spp=frame_lt_spp)
    fbits = max(1, int(np.ceil(np.log2(max(cfg.spp, 2))))) if frame_lt_spp else 32
    idx = ld.sobol_interval_to_index(cfg.log2_resolution, sample_num, pixel, max_frame_bits=fbits)
    return SampleCtx(pixel, sample_num, idx, frame_lt_spp=frame_lt_spp)


def dims_bits(cfg: SamplerCfg, ctx: SampleCtx) -> int:
    """The index bits K1 reads for ctx: the exact width where the context
    was made with the frame_lt_spp promise, else index_bits."""
    return exact_index_bits(cfg) if ctx.frame_lt_spp else index_bits(cfg)


def _random_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int) -> torch.Tensor:
    """(N, n_dims) random samples: uniform_float(px, py, sample, dim, seed)
    (samplers.py get_1d's RANDOM branch), the keys' shared prefix hashed
    once."""
    h = rngmod.hash_combine(rngmod.hash_combine(ctx.pixel[:, 0], ctx.pixel[:, 1]),
                            ctx.sample_num)
    dims = torch.arange(dim0, dim0 + n_dims, dtype=torch.int64, device=h.device)
    h = rngmod.hash_combine(rngmod.hash_combine(h[:, None], dims[None, :]),
                            cfg.seed & rngmod.M32)
    return rngmod.to_float(rngmod.hash_u32(h))


def get_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int) -> torch.Tensor:
    """(N, n_dims) samples of dims dim0.. (no film remap): Sobol' in one K1
    launch, random from the hash."""
    if cfg.kind == RANDOM:
        return _random_dims(cfg, ctx, dim0, n_dims)
    return sk.sobol_dims(ctx.global_index, dim0, n_dims, dims_bits(cfg, ctx))


def with_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int) -> SampleCtx:
    """ctx with the integrator dims dim0 .. dim0+n_dims-1 (all >= 2, so no
    film remap) drawn in one K1 launch, for get_1d / get_2d to read."""
    if dim0 < 2:
        raise ValueError("with_dims holds integrator dims only (the film dims are remapped)")
    return ctx._replace(block0=dim0, block=get_dims(cfg, ctx, dim0, n_dims))


def get_1d(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """(N,) samples of dimension `dim` (samplers.py get_1d): read from the
    block of with_dims when it holds dim, else one K1 launch; dims 0 and 1
    are remapped into the pixel."""
    if ctx.block is not None and ctx.block0 <= dim < ctx.block0 + ctx.block.shape[1]:
        return ctx.block[:, dim - ctx.block0]
    s = get_dims(cfg, ctx, dim, 1)[:, 0]
    if dim < 2 and cfg.kind == SOBOL:
        res = float(1 << cfg.log2_resolution)
        s = torch.clamp(s * res - ctx.pixel[:, dim].to(torch.float32), 0.0,
                        float(ONE_MINUS_EPSILON))
    return s


def get_2d(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """(N, 2) samples of dimensions dim and dim+1."""
    return torch.stack([get_1d(cfg, ctx, dim), get_1d(cfg, ctx, dim + 1)], -1)


def get_camera_dims(cfg: SamplerCfg, ctx: SampleCtx, pixel):
    """(u_film, u_time, u_lens) from dims 0-4; Sobol's film dims are
    remapped from the Sobol' domain into the pixel (samplers.py get_1d)."""
    dims5 = get_dims(cfg, ctx, 0, 5)
    if cfg.kind == RANDOM:
        return dims5[:, 0:2], dims5[:, 2], dims5[:, 3:5]
    res = float(1 << cfg.log2_resolution)
    u_film = torch.clamp(dims5[:, 0:2] * res - pixel.to(torch.float32), 0.0,
                         float(ONE_MINUS_EPSILON))
    return u_film, dims5[:, 2], dims5[:, 3:5]
