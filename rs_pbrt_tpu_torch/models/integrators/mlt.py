"""Metropolis light transport: primary-sample-space MLT over BDPT.

The port of the JAX package's ``models/integrators/mlt.py`` (reference
src/integrators/mlt.rs): a wavefront of Markov chains, each lane's state
its primary-sample-space (PSS) vector, read by BDPT through
``SampleCtx.pss`` (``bdpt.radiance_and_splats``; every launch of a
mutation is BDPT's).  The target is the BDPT estimate's luminance, the full
strategy sum or, ``depth_stratified``, one (depth, s) strategy a lane
picked by PSS dims 6 and 7 (mlt.rs:310-406).  A bootstrap of uniform PSS
vectors gives the normalization b (their mean target) and the chains'
starts, picked by target; each mutation then proposes a large step (a
fresh vector, probability P_LARGE) or a small one (Gaussian noise of
SIGMA, wrapped), evaluates the proposal once (the current state's
evaluation is carried), splats both states to the film weighted by the
acceptance a and 1 - a (mlt.rs:526-563) and accepts by a.

Random numbers come from one ``torch.Generator`` on the scene's device,
seeded with `seed`, drawn in this order: the bootstrap's (n_bootstrap,
U) uniforms, the chains' pick uniforms (n_chains,), then per mutation
u_large (n_chains,), u_fresh (n_chains, U), noise (n_chains, U, normal)
and u_accept (n_chains,).  They are not ``jax.random``'s numbers, so an
image equals the JAX one in distribution only; ``bootstrap_from`` and
``_mutation_step`` take their draws as arguments, which the tests feed
both packages.  The JAX package's chunking of mutations into dispatches
(``MLT_CHUNK_BUDGET``) serves a TPU's dispatch limit: the port runs a plain
loop of mutations.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import film as filmmod
from ...ops import sampling as smp
from ...scene import arrays as sa
from .. import cameras as cam
from .. import samplers as smpl
from . import bdpt as bdptmod
from .path import PathCfg

SIGMA = 0.01  # the small step's standard deviation (mlt.rs default)
P_LARGE = 0.3  # the large step's probability (mlt.rs default)
# lanes a bootstrap evaluation (~0.7 GB at depth 5: bdpt.MAX_LANES' bytes
# a lane); grid media key their tracking by lane in a batch, so a
# grid-medium bootstrap equals the JAX one (4,096 lanes a batch) only at
# 4096
BOOTSTRAP_CHUNK = 1 << 18
LUMINANCE = (0.2126, 0.7152, 0.0722)


def n_pss_for_depth(max_depth: int, has_media: bool = False) -> int:
    """PSS dims for disjoint streams at this depth (bdpt.dim_bases)."""
    t_max, s_max = max_depth + 2, max_depth + 1
    _, _, s1_base = bdptmod.dim_bases(t_max, s_max, has_media)
    return s1_base + 3 * (t_max + 1) + 4


def _luminance(x: torch.Tensor) -> torch.Tensor:
    return (x * x.new_tensor(LUMINANCE)).sum(-1)


def _eval_target(scene: sa.Scene, camera: cam.Camera, pcfg: PathCfg, cfg_s, pss, accel,
                 depth_stratified: bool = False, crop_rect=None):
    """BDPT at PSS vectors pss (N, U): (target luminance (N,), raster
    points (N, 2), L (N, 3), splat points and values, G groups of N).
    PSS dims 0-1 map onto the crop rect's pixels (film.rs
    get_sample_bounds); depth_stratified: dims 6-7 pick each lane's depth
    and strategy, and the depth's pick factor max_depth + 1 scales it so the
    target integrates to the full sum's."""
    n, dev = pss.shape[0], pss.device
    w, h = camera.resolution
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    ctx = smpl.SampleCtx(torch.zeros((n, 2), dtype=torch.int64, device=dev), zeros, zeros,
                         pss=pss)
    px0, px1, py0, py1 = crop_rect if crop_rect is not None else (0, w, 0, h)
    p_film = torch.stack([px0 + pss[:, 0] * (px1 - px0), py0 + pss[:, 1] * (py1 - py0)], -1)
    sel = None
    if depth_stratified:
        md = pcfg.max_depth
        d_sel = torch.clamp((pss[:, 6] * (md + 1)).to(torch.int32), 0, md)
        # depth 0 has one strategy, (0, 2): (1, 1) is skipped (mlt.rs:326-333)
        n_str = torch.where(d_sel == 0, 1, d_sel + 2)
        s_sel = torch.clamp((pss[:, 7] * n_str).to(torch.int32), min=0)
        sel = (d_sel, torch.minimum(s_sel, n_str - 1))
    L, sp, sl = bdptmod.radiance_and_splats(scene, camera, pcfg, cfg_s, ctx, p_film, accel,
                                            strategy_select=sel)
    lum_splat = torch.zeros(n, device=dev)
    for g in range(sp.shape[0] // n):  # the chains' own t = 1 splats
        lum_splat = lum_splat + _luminance(sl[g * n:(g + 1) * n])
    return _luminance(L) + lum_splat, p_film, L, sp, sl


def _mutation_step(scene: sa.Scene, camera: cam.Camera, pcfg: PathCfg, cfg_s, accel,
                   depth_stratified: bool, crop_rect, pss_cur, cur_eval, film: filmmod.Film,
                   uniforms):
    """One Metropolis mutation of every chain (mlt.rs:526-563):
    uniforms = (u_large (n,), u_fresh (n, U), noise (n, U), u_accept (n,));
    splats both states to film in place.  -> (pss, evaluation, film)."""
    lum_cur, pf_c, L_c, sp_c, sl_c = cur_eval
    u_large, u_fresh, noise, u_accept = uniforms
    n = pss_cur.shape[0]
    perturbed = pss_cur + SIGMA * noise
    perturbed = perturbed - torch.floor(perturbed)  # wrapped to [0, 1)
    pss_prop = torch.where((u_large < P_LARGE)[:, None], u_fresh, perturbed)
    lum_prop, pf_p, L_p, sp_p, sl_p = _eval_target(scene, camera, pcfg, cfg_s, pss_prop, accel,
                                                   depth_stratified, crop_rect)
    a = torch.clamp(lum_prop / torch.clamp(lum_cur, min=1e-12), 0.0, 1.0)
    w_prop = torch.where(lum_prop > 0, a / torch.clamp(lum_prop, min=1e-12), 0.0)
    w_cur = torch.where(lum_cur > 0, (1.0 - a) / torch.clamp(lum_cur, min=1e-12), 0.0)
    filmmod.add_splats(film, pf_p, L_p * w_prop[:, None])
    filmmod.add_splats(film, pf_c, L_c * w_cur[:, None])
    groups = sp_p.shape[0] // n
    for g in range(groups):
        part = slice(g * n, (g + 1) * n)
        filmmod.add_splats(film, sp_p[part], sl_p[part] * w_prop[:, None])
        filmmod.add_splats(film, sp_c[part], sl_c[part] * w_cur[:, None])
    accept = u_accept < a
    acc1 = accept[:, None]
    acc_g = acc1.repeat(groups, 1)  # the splats' groups of n chains
    new_eval = (torch.where(accept, lum_prop, lum_cur), torch.where(acc1, pf_p, pf_c),
                torch.where(acc1, L_p, L_c), torch.where(acc_g, sp_p, sp_c),
                torch.where(acc_g, sl_p, sl_c))
    return torch.where(acc1, pss_prop, pss_cur), new_eval, film


def bootstrap_pick(scene: sa.Scene, camera: cam.Camera, pcfg: PathCfg, cfg_s, accel,
                   depth_stratified: bool, crop_rect, boot, u_pick):
    """The bootstrap (mlt.rs:418-476) on the uniform PSS vectors boot
    (n_bootstrap, U) and the pick uniforms u_pick (n_chains,): their
    targets in BOOTSTRAP_CHUNK batches, b their mean, and the chains'
    starts picked by target.  depth_stratified stratifies dim 6 over the
    depths first.  -> (b, pss (n_chains, U))."""
    md = pcfg.max_depth
    if depth_stratified:
        strata = (torch.arange(boot.shape[0], device=boot.device) % (md + 1)).to(torch.float32)
        boot = boot.clone()
        boot[:, 6] = (strata + boot[:, 6]) / (md + 1)
    lum_b = torch.cat([
        _eval_target(scene, camera, pcfg, cfg_s, boot[i:i + BOOTSTRAP_CHUNK], accel,
                     depth_stratified, crop_rect)[0]
        for i in range(0, boot.shape[0], BOOTSTRAP_CHUNK)])
    b = lum_b.mean()
    # the pick's cdf is summed on the host: the card's cumsum (a look-back
    # scan) rounds in an order that changes from run to run, and a start
    # that moves moves its whole chain (chip_smoke.py phase 28)
    pick, _, _ = smp.sample_distribution_1d_discrete(smp.make_distribution_1d(lum_b.cpu()),
                                                     u_pick.cpu())
    return b, boot[pick.to(boot.device)]


def bootstrap_from(scene: sa.Scene, camera: cam.Camera, pcfg: PathCfg, cfg_s, accel,
                   depth_stratified: bool, crop_rect, boot, u_pick):
    """bootstrap_pick and the starts' evaluation.  -> (b, pss, evaluation)."""
    b, pss_cur = bootstrap_pick(scene, camera, pcfg, cfg_s, accel, depth_stratified, crop_rect,
                                boot, u_pick)
    return b, pss_cur, _eval_target(scene, camera, pcfg, cfg_s, pss_cur, accel,
                                    depth_stratified, crop_rect)


def mutation_uniforms(gen: torch.Generator, n_chains: int, n_pss: int, dev):
    """One mutation's draws from gen, in the module's documented order."""
    return (torch.rand(n_chains, generator=gen, device=dev),
            torch.rand((n_chains, n_pss), generator=gen, device=dev),
            torch.randn((n_chains, n_pss), generator=gen, device=dev),
            torch.rand(n_chains, generator=gen, device=dev))


def render_mlt(scene: sa.Scene, camera: cam.Camera, mutations_per_pixel: int = 16,
               max_depth: int = 5, n_chains: int = 4096, n_bootstrap: int = 16384, accel=None,
               seed: int = 7, depth_stratified: bool = False, crop_rect=None,
               stats: Optional[dict] = None) -> torch.Tensor:
    """The MLT image (H, W, 3) (MLTIntegrator::render mlt.rs:407): crop
    area x mutations_per_pixel / n_chains mutations of n_chains chains, the
    film's splats scaled by b x crop area / splats (mlt.rs:559), pixels
    outside the crop rect (px0, px1, py0, py1) black.  stats, where given,
    gets mutations (per chain) and b."""
    dev = scene.device
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_rect if crop_rect is not None else (0, w, 0, h)
    crop_area = (px1 - px0) * (py1 - py0)
    pcfg = PathCfg(max_depth, 1.0)
    cfg_s = smpl.make_sampler(smpl.RANDOM, 1, camera.resolution)
    n_pss = n_pss_for_depth(max_depth, scene.has_media)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    boot = torch.rand((n_bootstrap, n_pss), generator=gen, device=dev)
    u_pick = torch.rand(n_chains, generator=gen, device=dev)
    b, pss_cur, cur_eval = bootstrap_from(scene, camera, pcfg, cfg_s, accel, depth_stratified,
                                          crop_rect, boot, u_pick)
    film = filmmod.make_film((w, h), dev)
    n_mut = max(1, (crop_area * mutations_per_pixel) // n_chains)
    for _ in range(n_mut):
        pss_cur, cur_eval, film = _mutation_step(
            scene, camera, pcfg, cfg_s, accel, depth_stratified, crop_rect, pss_cur, cur_eval,
            film, mutation_uniforms(gen, n_chains, n_pss, dev))
    b = float(b)
    if stats is not None:
        stats.update(mutations=n_mut, b=b)
    return resolve(film.splat, b, crop_area, n_mut, n_chains, crop_rect)


def resolve(splat: torch.Tensor, b: float, crop_area: int, n_mut: int, n_chains: int,
            crop_rect=None) -> torch.Tensor:
    """The image of MLT's splat layer: scaled by b x crop area / splats
    (mlt.rs:559), pixels outside the crop rect (px0, px1, py0, py1) black
    (t = 1 splats outside the crop are dropped)."""
    img = splat * (b * crop_area / (n_mut * n_chains))
    if crop_rect is not None:
        px0, px1, py0, py1 = crop_rect
        out = torch.zeros_like(img)
        out[py0:py1, px0:px1] = img[py0:py1, px0:px1]
        img = out
    return img
