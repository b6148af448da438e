"""Samplers as stateless index math: value = f(pixel, sample, dimension).

The port of the Sobol' parts of the JAX package's ``models/samplers.py``
(reference src/core/sampler.rs, samplers/sobol.rs).  Dimension budget:
dims 0,1 film xy, dim 2 time, dims 3,4 lens uv, dims 5+ the integrator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import lowdiscrepancy as ld
from ..ops import sobol_kernel as sk
from ..utils.vecmath import ONE_MINUS_EPSILON

SOBOL = 0  # numbered as in the JAX package; the other kinds come with their slice


class SamplerCfg(NamedTuple):
    kind: int
    spp: int
    log2_resolution: int  # Sobol' pixel-domain scaling
    seed: int


def make_sampler(kind: int, spp: int, resolution=(1, 1), seed: int = 0) -> SamplerCfg:
    """Sobol' sampler config: spp rounds up to a power of two (sobol.rs:40)."""
    if kind != SOBOL:
        raise NotImplementedError(
            "rs_pbrt_tpu_torch has only the Sobol' sampler so far (ROADMAP slice 4)")
    log2res = int(np.ceil(np.log2(max(resolution[0], resolution[1], 1))))
    if spp & (spp - 1):
        spp = 1 << int(np.ceil(np.log2(spp)))
    return SamplerCfg(kind, spp, log2res, seed)


def index_bits(cfg: SamplerCfg) -> int:
    """Width of the global index: it is below spp << 2*log2res
    (lowdiscrepancy.rs:1014), so 32 bits when that fits, else 52."""
    return 32 if cfg.spp * (4 ** cfg.log2_resolution) <= (1 << 32) else 52


class SampleCtx(NamedTuple):
    pixel: torch.Tensor  # (N, 2) int64
    sample_num: torch.Tensor  # (N,) int64
    global_index: torch.Tensor  # (N,) int64 Sobol' global index
    # a block of dims drawn ahead in one K1 launch (with_dims): its first
    # dim and its (N, n) samples
    block0: int = 0
    block: Optional[torch.Tensor] = None


def make_ctx(cfg: SamplerCfg, pixel, sample_num, frame_lt_spp: bool = False) -> SampleCtx:
    """frame_lt_spp: the caller promises sample_num < cfg.spp on every lane,
    which bounds the frame bits read to ceil(log2 spp)."""
    pixel = pixel.to(torch.int64)
    sample_num = sample_num.to(torch.int64)
    fbits = max(1, int(np.ceil(np.log2(max(cfg.spp, 2))))) if frame_lt_spp else 32
    idx = ld.sobol_interval_to_index(cfg.log2_resolution, sample_num, pixel, max_frame_bits=fbits)
    return SampleCtx(pixel, sample_num, idx)


def get_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int) -> torch.Tensor:
    """(N, n_dims) samples of dims dim0.. in one K1 launch (no film remap)."""
    return sk.sobol_dims(ctx.global_index, dim0, n_dims, index_bits(cfg))


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
    if dim < 2:
        res = float(1 << cfg.log2_resolution)
        s = torch.clamp(s * res - ctx.pixel[:, dim].to(torch.float32), 0.0,
                        float(ONE_MINUS_EPSILON))
    return s


def get_2d(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """(N, 2) samples of dimensions dim and dim+1."""
    return torch.stack([get_1d(cfg, ctx, dim), get_1d(cfg, ctx, dim + 1)], -1)


def get_camera_dims(cfg: SamplerCfg, ctx: SampleCtx, pixel):
    """(u_film, u_time, u_lens) from dims 0-4; the film dims are remapped
    from the Sobol' domain into the pixel (samplers.py get_1d)."""
    dims5 = get_dims(cfg, ctx, 0, 5)
    res = float(1 << cfg.log2_resolution)
    u_film = torch.clamp(dims5[:, 0:2] * res - pixel.to(torch.float32), 0.0,
                         float(ONE_MINUS_EPSILON))
    return u_film, dims5[:, 2], dims5[:, 3:5]
