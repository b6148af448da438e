"""Samplers as stateless index math: value = f(pixel, sample, dimension).

The port of the JAX package's ``models/samplers.py`` (reference
src/core/sampler.rs and src/samplers/*): Sobol', random, the (0,2)-sequence
("zerotwo"), stratified, Halton and max-min distance.  Sobol' dims come from
K1 and Halton dims from H1 (``ops/halton_kernel.py``), one launch for a
block of dims; the random sampler's from the stateless hash of
``utils/rng.py`` of (pixel, sample, dim, seed); zerotwo, stratified and
maxmin from plain PyTorch over the whole block (``_plain_dims``).
Dimension budget: dims 0,1 film xy, dim 2 time, dims 3,4 lens uv, dims 5+
the integrator.

Where the JAX package reads dims as 2D pairs the kinds differ: zerotwo's
and maxmin's 2D draw is a (0,2)-sequence point, stratified's static 2D draw
a near-square stratum grid, and maxmin's film pair its max-min-distance
point; the others' 2D draw is two 1D draws.  So a block of dims names the
offsets that start a pair (``pairs``), and ``dyn`` picks the JAX package's
traced-dim route (``get_1d_dyn``/``get_2d_dyn``: stratified pairs as two 1D
draws, Halton dims clipped to [2, 255]), which its path and volpath
integrators take.

MLT's primary-sample-space vectors ride the context (``SampleCtx.pss``, the
JAX package's samplers.py:86-97): where a context holds one, every draw of
dim d reads column d mod U of it, whatever the sampler's kind, and no
kernel is launched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import halton_kernel as hk
from ..ops import lowdiscrepancy as ld
from ..ops import sobol_kernel as sk
from ..utils import rng as rngmod
from ..utils.vecmath import ONE_MINUS_EPSILON

# numbered as in the JAX package
SOBOL = 0
RANDOM = 1
ZEROTWO = 2  # (0,2)-sequence with per-(pixel, dim) scrambles
STRATIFIED = 3
HALTON = 4
MAXMIN = 5
KINDS = (SOBOL, RANDOM, ZEROTWO, STRATIFIED, HALTON, MAXMIN)
PAIRED = (ZEROTWO, STRATIFIED, MAXMIN)  # kinds whose 2D draw is not two 1D draws
HALTON_MAX_RESOLUTION = 128  # halton.rs:30 K_MAX_RESOLUTION


class SamplerCfg(NamedTuple):
    kind: int
    spp: int
    log2_resolution: int  # Sobol' pixel-domain scaling
    seed: int
    # Halton's (scale_x, scale_y, exp_x, exp_y, stride, mult_inv_x,
    # mult_inv_y) (halton.rs:85-110)
    halton: tuple = ()


def make_sampler(kind: int, spp: int, resolution=(1, 1), seed: int = 0) -> SamplerCfg:
    """Sampler config (samplers.py make_sampler): Sobol', zerotwo and maxmin
    round spp up to a power of two (sobol.rs:40); maxmin takes at most 2^16
    spp, Halton at most spp x stride below 2^32 (its 32-bit index)."""
    if kind not in KINDS:
        raise ValueError(f"unknown sampler kind {kind}")
    log2res = int(np.ceil(np.log2(max(resolution[0], resolution[1], 1))))
    if kind in (SOBOL, ZEROTWO, MAXMIN) and spp & (spp - 1):
        spp = 1 << int(np.ceil(np.log2(spp)))
    if kind == MAXMIN and spp > (1 << 16):
        raise ValueError("maxmindist supports at most 2^16 samples per pixel")
    halton = ()
    if kind == HALTON:
        scales, exps = [], []
        for i, base in enumerate((2, 3)):
            scale, exp = 1, 0
            while scale < min(int(resolution[i]), HALTON_MAX_RESOLUTION):
                scale *= base
                exp += 1
            scales.append(scale)
            exps.append(exp)
        stride = scales[0] * scales[1]
        minv_x = pow(scales[1], -1, scales[0]) if scales[0] > 1 else 0
        minv_y = pow(scales[0], -1, scales[1]) if scales[1] > 1 else 0
        if spp * stride >= (1 << 32):
            raise ValueError(f"halton: spp={spp} x stride={stride} exceeds the 32-bit index "
                             "budget of the sampler")
        halton = (scales[0], scales[1], exps[0], exps[1], stride, minv_x, minv_y)
    return SamplerCfg(kind, spp, log2res, seed, halton)


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
    # (N,): Sobol's int64 index, Halton's u32 one as int32 bits (the 4
    # bytes a lane H1 reads), or int64 zeros
    global_index: torch.Tensor
    # a block of dims drawn ahead (with_dims): its first dim, its (N, n)
    # samples and the offsets in it that start a static 2D draw
    block0: int = 0
    block: Optional[torch.Tensor] = None
    block_pairs: tuple = ()
    # the caller's promise that sample_num < spp on every lane (make_ctx)
    frame_lt_spp: bool = False
    # MLT's primary-sample-space vectors (N, U): every dim d reads column
    # d mod U (mlt.rs:28-279 as data), no remap and no kernel
    pss: Optional[torch.Tensor] = None


def make_ctx(cfg: SamplerCfg, pixel, sample_num, frame_lt_spp: bool = False) -> SampleCtx:
    """frame_lt_spp: the caller promises sample_num < cfg.spp on every lane,
    which bounds the frame bits read to ceil(log2 spp) and the index to
    exact_index_bits; the context records it for get_dims.  Halton's index
    is _halton_index's, held as int32 bits; the other kinds have none
    (zeros, as in the JAX package).  SPPM passes iteration numbers, which may reach spp."""
    pixel = pixel.to(torch.int64)
    sample_num = sample_num.to(torch.int64)
    if cfg.kind == SOBOL:
        fbits = max(1, int(np.ceil(np.log2(max(cfg.spp, 2))))) if frame_lt_spp else 32
        idx = ld.sobol_interval_to_index(cfg.log2_resolution, sample_num, pixel,
                                         max_frame_bits=fbits)
    elif cfg.kind == HALTON:
        idx = _halton_index(cfg, pixel, sample_num)
        idx = (idx - ((idx >> 31) << 32)).to(torch.int32)
    else:
        idx = torch.zeros_like(sample_num)
    return SampleCtx(pixel, sample_num, idx, frame_lt_spp=frame_lt_spp)


def _halton_index(cfg: SamplerCfg, pixel: torch.Tensor, sample_num: torch.Tensor):
    """Halton's global index of (pixel, sample_num) (halton.rs:173-215): the
    pixel's offset by the CRT on the base-2 and base-3 pixel strides, then
    sample_num strides, in 32-bit arithmetic."""
    sx, sy, ex, ey, stride, minv_x, minv_y = cfg.halton
    if stride <= 1:
        return sample_num & ld.U32_MASK
    do_x = ld.inverse_radical_inverse_2(pixel[:, 0] % HALTON_MAX_RESOLUTION, ex)
    do_y = ld.inverse_radical_inverse_3(pixel[:, 1] % HALTON_MAX_RESOLUTION, ey)
    offset = (do_x * ((stride // sx) * minv_x % stride)
              + do_y * ((stride // sy) * minv_y % stride)) % stride
    return (offset + (sample_num * stride & ld.U32_MASK)) & ld.U32_MASK


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


def _pixel_hash(cfg: SamplerCfg, ctx: SampleCtx, dims: torch.Tensor) -> torch.Tensor:
    """(N, len(dims)) per-(pixel, dim) scrambles: uniform_u32(px, py, dim,
    seed) (samplers.py _pixel_hash)."""
    h = rngmod.hash_combine(ctx.pixel[:, 0:1], ctx.pixel[:, 1:2])
    return rngmod.hash_u32(rngmod.hash_combine(rngmod.hash_combine(h, dims[None, :]),
                                               cfg.seed & rngmod.M32))


def _strata(x: torch.Tensor, n: float) -> torch.Tensor:
    return torch.clamp(x / n, max=float(ONE_MINUS_EPSILON))


def _maxmin_film(cfg: SamplerCfg, ctx: SampleCtx) -> torch.Tensor:
    """(N, 2) the max-min-distance film pair (maxmin.rs:117-126): x = j/spp,
    y = C_maxmin j, j the sample's place in a per-pixel permutation."""
    c_index = int(np.log2(max(cfg.spp, 1)))
    key = _pixel_hash(cfg, ctx, torch.zeros(1, dtype=torch.int64, device=ctx.pixel.device))
    j = _permute(ctx.sample_num, cfg.spp, key[:, 0])
    x = _strata(j.to(torch.float32), float(cfg.spp))
    return torch.stack([x, ld.max_min_dist_sample(j, c_index, n_bits=max(c_index, 1))], -1)


def _plain_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int, pairs: tuple,
                dyn: bool) -> torch.Tensor:
    """(N, n_dims) dims of zerotwo, stratified or maxmin in plain PyTorch,
    every dim at once: a 1D draw at each offset, a 2D draw at each offset k
    of pairs and k+1 (samplers.py get_1d/get_2d, or get_1d_dyn/get_2d_dyn
    where dyn)."""
    dev = ctx.pixel.device
    dims = torch.arange(dim0, dim0 + n_dims, dtype=torch.int64, device=dev)
    s = ctx.sample_num[:, None]
    scr = _pixel_hash(cfg, ctx, dims)  # (N, n_dims)
    if cfg.kind == STRATIFIED:
        out = _strata(_permute(s, cfg.spp, scr).to(torch.float32)
                      + rngmod.uniform_float(scr, s, 0x9E37), float(cfg.spp))
    else:  # zerotwo, and maxmin past its film dims: the van der Corput draws
        out = ld.van_der_corput_sample(s, scr)
    film = cfg.kind == MAXMIN and not dyn and dim0 < 2
    if film:  # maxmin's film dims 0 and 1: its max-min-distance pair
        mm = _maxmin_film(cfg, ctx)
        out = torch.cat([mm[:, dim0:], out[:, 2 - dim0:]], 1)[:, :n_dims]
    pairs = [k for k in pairs if 0 <= k < n_dims - 1]
    if not pairs or (cfg.kind == STRATIFIED and dyn):  # get_2d_dyn: two 1D strata
        return out
    out = out.clone()
    ks = torch.as_tensor(pairs, device=dev)
    if cfg.kind == STRATIFIED:  # a near-square grid of spp strata
        nx = 1 << int(np.floor(np.log2(max(cfg.spp, 1)) / 2))
        ny = max(cfg.spp // nx, 1)
        perm = _permute(s, nx * ny, scr[:, ks])
        jx = rngmod.uniform_float(scr[:, ks], s, 1)
        jy = rngmod.uniform_float(scr[:, ks + 1], s, 2)
        out[:, ks] = _strata((perm % nx).to(torch.float32) + jx, float(nx))
        out[:, ks + 1] = _strata((perm // nx).to(torch.float32) + jy, float(ny))
        return out
    # zerotwo and maxmin: the (0,2)-sequence point, whose x is its first
    # dim's 1D draw; maxmin's static pairs at dims 0 and 1 are its film pair
    if film:
        if 1 - dim0 in pairs:  # the pair at dim 1, as the JAX package reads it
            out[:, 1 - dim0:3 - dim0] = mm
        ks = ks[dim0 + ks >= 2]
    y = ld.sobol_02_y_bits(ctx.sample_num)[:, None] ^ scr[:, ks + 1]
    out[:, ks + 1] = ld.u32_to_unit_float(y)
    return out


def get_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int, pairs: tuple = (),
             dyn: bool = False) -> torch.Tensor:
    """(N, n_dims) samples of dims dim0.. (no Sobol' film remap), each a 1D
    draw, or at an offset k of pairs the 2D draw of dims dim0+k and dim0+k+1
    (see the module's docstring).  dyn: the JAX package's traced-dim route.
    Sobol' in one K1 launch, Halton in one H1 launch, random from the hash,
    the other kinds in plain PyTorch; with ctx.pss, its columns."""
    if ctx.pss is not None:
        u = ctx.pss.shape[1]
        return ctx.pss[:, [(dim0 + k) % u for k in range(n_dims)]]
    if cfg.kind == SOBOL:
        return sk.sobol_dims(ctx.global_index, dim0, n_dims, dims_bits(cfg, ctx))
    if cfg.kind == RANDOM:
        return _random_dims(cfg, ctx, dim0, n_dims)
    if cfg.kind == HALTON:
        return hk.halton_dims(ctx.global_index, dim0, n_dims, cfg.halton[2], cfg.halton[1],
                              clip=dyn)
    return _plain_dims(cfg, ctx, dim0, n_dims, tuple(pairs), dyn)


def repeat_pairs(pairs: tuple, stride: int, n: int) -> tuple:
    """The pair offsets of n consecutive blocks of `stride` dims, each laid
    out as pairs: a table of every bounce's dims."""
    return tuple(b * stride + k for b in range(n) for k in pairs)


def traced_route(cfg: SamplerCfg, total_dims: int) -> bool:
    """Does the JAX package's path or volpath integrator draw its bounce
    dims through get_1d_dyn / get_2d_dyn (``dyn``)?  Every kind without a
    batched table does; Halton only past the 128 dims it stacks statically
    (path.py:522-561)."""
    return cfg.kind != HALTON or total_dims > sk.MAX_DIMS


def with_dims(cfg: SamplerCfg, ctx: SampleCtx, dim0: int, n_dims: int,
              pairs: tuple = ()) -> SampleCtx:
    """ctx with the integrator dims dim0 .. dim0+n_dims-1 (all >= 2, so no
    film remap) drawn in one block, static 2D draws at the offsets of pairs,
    for get_1d / get_2d to read."""
    if dim0 < 2:
        raise ValueError("with_dims holds integrator dims only (the film dims are remapped)")
    if ctx.pss is not None:  # every draw reads the pss columns
        return ctx
    return ctx._replace(block0=dim0, block=get_dims(cfg, ctx, dim0, n_dims, pairs),
                        block_pairs=tuple(pairs))


def _in_block(cfg: SamplerCfg, ctx: SampleCtx, dim: int, width: int) -> bool:
    """Does ctx's block hold the draw of `width` (1 or 2) dims at dim: the
    dims lie in it and, for the kinds whose 2D draw is not two 1D draws,
    the block drew them as the same 1D or 2D draw."""
    if ctx.block is None or not ctx.block0 <= dim <= ctx.block0 + ctx.block.shape[1] - width:
        return False
    if cfg.kind not in PAIRED:
        return True
    k = dim - ctx.block0
    if width == 2:
        return k in ctx.block_pairs
    return k not in ctx.block_pairs and k - 1 not in ctx.block_pairs


def _film_remap(cfg: SamplerCfg, ctx: SampleCtx, s: torch.Tensor, dim: int) -> torch.Tensor:
    """Sobol's film dims 0 and 1 from the Sobol' domain into the pixel."""
    if dim >= 2 or cfg.kind != SOBOL:
        return s
    res = float(1 << cfg.log2_resolution)
    return torch.clamp(s * res - ctx.pixel[:, dim].to(torch.float32), 0.0,
                       float(ONE_MINUS_EPSILON))


def get_1d(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """(N,) samples of dimension `dim` (samplers.py get_1d): read from the
    block of with_dims when it holds dim, else drawn; Sobol's dims 0 and 1
    are remapped into the pixel; with ctx.pss, column dim mod U."""
    if ctx.pss is not None:
        return ctx.pss[:, dim % ctx.pss.shape[1]]
    if _in_block(cfg, ctx, dim, 1):
        return ctx.block[:, dim - ctx.block0]
    return _film_remap(cfg, ctx, get_dims(cfg, ctx, dim, 1)[:, 0], dim)


def get_2d(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """(N, 2) samples of dimensions dim and dim+1 (samplers.py get_2d): two
    get_1d draws, or the kinds' own 2D draw (from the block where it drew
    the pair); with ctx.pss, columns dim and dim+1 mod U."""
    if ctx.pss is not None:
        return get_dims(cfg, ctx, dim, 2)
    if cfg.kind not in PAIRED:
        return torch.stack([get_1d(cfg, ctx, dim), get_1d(cfg, ctx, dim + 1)], -1)
    if _in_block(cfg, ctx, dim, 2):
        return ctx.block[:, dim - ctx.block0:dim - ctx.block0 + 2]
    return get_dims(cfg, ctx, dim, 2, (0,))


def get_1d_dyn(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """samplers.py get_1d_dyn: the traced-dim route, no film remap."""
    return get_dims(cfg, ctx, dim, 1, dyn=True)[:, 0]


def get_2d_dyn(cfg: SamplerCfg, ctx: SampleCtx, dim: int) -> torch.Tensor:
    """samplers.py get_2d_dyn."""
    return get_dims(cfg, ctx, dim, 2, (0,), dyn=True)


def get_camera_dims(cfg: SamplerCfg, ctx: SampleCtx, pixel):
    """(u_film, u_time, u_lens) from dims 0-4 in one draw (one K1 or H1
    launch); Sobol's film dims are remapped from the Sobol' domain into the
    pixel (samplers.py get_1d); with ctx.pss, its columns 0-4."""
    dims5 = get_dims(cfg, ctx, 0, 5, (0, 3))
    if cfg.kind != SOBOL or ctx.pss is not None:
        return dims5[:, 0:2], dims5[:, 2], dims5[:, 3:5]
    res = float(1 << cfg.log2_resolution)
    u_film = torch.clamp(dims5[:, 0:2] * res - pixel.to(torch.float32), 0.0,
                         float(ONE_MINUS_EPSILON))
    return u_film, dims5[:, 2], dims5[:, 3:5]


def _permute(i: torch.Tensor, n: int, key: torch.Tensor) -> torch.Tensor:
    """A pseudorandom permutation of [0, n) at i (samplers.py _permute):
    cycle-walking a permutation of [0, 2^k), k = ceil(log2 n), built of
    bijective rounds (odd multiplies, XORs and adds mod 2^k, x ^= x >> s),
    15 walks and then i mod n.  i and key broadcast; 32-bit words in
    int64."""
    i = i.to(torch.int64) & ld.U32_MASK
    if n <= 1:
        return torch.zeros(torch.broadcast_shapes(i.shape, key.shape), dtype=torch.int64,
                           device=i.device)
    k = int(np.ceil(np.log2(n)))
    mask = (1 << k) - 1
    mul = rngmod._mul32
    c1 = (mul(key, 0x9E3779B9) + 0x85EBCA6B) & mask
    c2 = (mul(key ^ 0xC2B2AE35, 0x27D4EB2F) + 0x165667B1) & mask
    c1h = c1 >> 1
    s1, s2 = max(1, k // 2), max(1, (k + 2) // 3)

    def perm(x):
        x = mul(x, 0x2545F491) & mask
        x = x ^ c1
        x = x ^ (x >> s1)
        x = (x + c2) & mask
        x = mul(x, 0x6935FA69) & mask
        x = x ^ (x >> s2)
        x = x ^ c1h
        x = mul(x, 0x9E501CC3) & mask
        return x ^ (x >> s1)

    x = perm(i)
    for _ in range(15):
        x = torch.where(x >= n, perm(x), x)
    return torch.where(x >= n, x % n, x)
