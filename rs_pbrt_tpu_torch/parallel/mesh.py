"""Sharded rendering over a DeviceMesh: each rank renders its share, the
films are summed.

The port of the JAX package's ``parallel/mesh.py`` (reference
src/blockqueue/mod.rs's tile queue and the RwLock'd film merge,
src/core/integrator.rs:101-215), on torch.distributed.  Every rank calls
the same function with the same arguments and the same scene, and every
rank gets back the whole image.  Films are reduced by SUM over every axis
of the mesh, so a 1-D ("d",) mesh and a ("h", "d") host mesh
(``distributed.make_host_mesh``) run the same program.

- ``render_sharded`` (the path family): each rank renders a band of whole
  pixel rows of the crop window through ``render.render_batch`` (K1 once a
  batch, K2 or the general bounce, R1 for a splatting filter), in the
  batches ``render`` takes for the whole window; the partial films are
  summed once, after the last batch.  Samplers are stateless in (pixel,
  sample) and a box-filtered pixel's samples all land on one rank, so
  the image equals ``render``'s bit for bit at any world size; a
  splatting filter's pixels on a band's edge sum two ranks' taps.
- ``render_bdpt_sharded``: the same bands through BDPT, the t = 1 splats
  summed with the rgb and weight planes.
- ``render_sppm_sharded``: each iteration's camera pass on the rank's
  share of the pixels, the visible points gathered in pixel order, the
  grid built on every rank, the photon pass split by photon index, and
  the deposits summed before the radius update.
- ``render_mlt_sharded``: every rank bootstraps the same chains from the
  same generator seed and draws every mutation's numbers for all chains,
  mutating its own contiguous range, so proposals do not depend on the
  layout; the splat films are summed.

``make_mesh()`` with no process group starts a world of one in this
process, so ``render(..., mesh=make_mesh())`` runs on one card.  Under
``torchrun`` call ``distributed.init_distributed()`` first.  Scenes are
replicated on every rank; ``distributed.geometry_sharded_intersect``
shards triangles instead.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from ..models import cameras as cam
from ..models import samplers as smpl
from ..models.integrators import bdpt as bdptmod
from ..models.integrators import mlt as mltmod
from ..models.integrators import path as pathmod
from ..models.integrators import regen as regenmod
from ..models.integrators import render as rdr
from ..models.integrators import sppm as sp
from ..ops import film as filmmod
from ..scene import arrays as sa
from .distributed import gather, start_world


def make_mesh(device="cuda", axis: str = "d"):
    """A 1-D DeviceMesh named (axis,) over every rank of the world; without
    a process group, a world of one started in this process (NCCL on the
    card, gloo on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = start_world(device)
    return DeviceMesh(dev.type, list(range(dist.get_world_size())), mesh_dim_names=(axis,))


def mesh_rank(mesh) -> int:
    """This rank's index in the mesh, row-major over its axes."""
    idx = 0
    for dim, c in enumerate(mesh.get_coordinate()):
        idx = idx * mesh.size(dim) + c
    return idx


def all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced in place over every axis of the mesh."""
    for dim in range(mesh.ndim):
        dist.all_reduce(t, op=op, group=mesh.get_group(dim))
    return t


def gather_cat(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's t concatenated along dim 0 in mesh_rank order."""
    flag = t.dtype == torch.bool
    if flag:
        t = t.to(torch.uint8)
    for dim in reversed(range(mesh.ndim)):
        t = gather(t, mesh.get_group(dim)).flatten(0, 1)
    return t.to(torch.bool) if flag else t


class _SumOverMesh(torch.autograd.Function):
    """The film summed over the mesh, whose backward passes the image's
    gradient to this rank's own partial film: the other ranks' shares of
    the parameter gradients arrive when the gradients are summed over the
    mesh (``diff/grad.grad_loss``), so only that one reduction sums."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_film(film: filmmod.Film, mesh) -> filmmod.Film:
    """The films of every rank summed, rgb, weight and splat in one
    (H, W, 7) all-reduce."""
    packed = torch.cat([film.rgb, film.weight[..., None], film.splat], -1)
    if torch.is_grad_enabled() and packed.requires_grad:
        packed = _SumOverMesh.apply(packed, mesh)
    else:
        all_reduce(packed, mesh)
    return filmmod.Film(packed[..., :3], packed[..., 3], packed[..., 4:], film.splatted)


def band(n_rows: int, n: int, r: int) -> tuple:
    """Rank r's rows [y0, y1) of n_rows split into n near-equal bands."""
    return r * n_rows // n, (r + 1) * n_rows // n


def _mesh_of(scene: sa.Scene, mesh):
    return make_mesh(scene.device) if mesh is None else mesh


def _crop(camera, crop_rect):
    w, h = camera.resolution
    return crop_rect if crop_rect is not None else (0, w, 0, h)


def render_sharded(scene: sa.Scene, camera: cam.Camera, cfg: rdr.RenderCfg,
                   sampler_cfg: smpl.SamplerCfg, filter_cfg: Optional[filmmod.FilterCfg] = None,
                   mesh=None, accel=None, spp_per_batch: Optional[int] = None, crop=None,
                   regen: bool = False, max_lanes: int = rdr.MAX_LANES,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """The path family's image (H, W, 3), data-parallel over the mesh (a
    world of one by default): this rank renders its band of the crop
    window's rows (crop: fractional, cfg.crop without one) in batches of
    spp_per_batch samples a pixel (default: what ``render`` takes for the
    whole window, at most max_lanes paths), the films are summed.  regen:
    the path integrator regenerates paths where the rank's batch takes it
    (``regen.eligible``); ``render(mesh=)`` passes none, so that gradients
    take the fixed-depth loop.  stats, where given, gets this rank's
    batches, lane_width and iterations, and wall_s from its first batch to
    the summed image (host clock, synchronized with the card)."""
    rdr.check_cfg(cfg)
    if cfg.integrator in ("sppm", "bdpt", "mlt"):
        raise ValueError(f"render_sharded renders the path family; {cfg.integrator} has "
                         f"render_{cfg.integrator}_sharded")
    if filter_cfg is None:
        filter_cfg = filmmod.make_filter(filmmod.FILTER_BOX)
    mesh = _mesh_of(scene, mesh)
    w, h = camera.resolution
    px0, px1, py0, py1 = rdr.crop_pixel_rect((w, h), crop if crop is not None else cfg.crop)
    cw, ch = px1 - px0, py1 - py0
    if spp_per_batch is None:
        spp_per_batch = max(1, min(cfg.spp, max_lanes // (cw * ch)))
    y0, y1 = band(ch, mesh.size(), mesh_rank(mesh))
    rect = (py0 + y0, y1 - y0, px0, cw)
    light_distrib, mega = rdr.path_setup(scene, cfg, accel)
    use_regen = regen and cfg.integrator == "path" and regenmod.eligible(
        scene, pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold), sampler_cfg, accel,
        spp_per_batch * rect[1] * cw)
    film = filmmod.make_film((w, h), scene.device)
    sample = batches = 0
    t0 = time.perf_counter()
    while rect[1] > 0 and sample < cfg.spp:
        nb = min(spp_per_batch, cfg.spp - sample)
        film = rdr.render_batch(scene, camera, cfg, sampler_cfg, film, filter_cfg, sample, nb,
                                mega, accel, rect, light_distrib, use_regen, stats)
        sample += nb
        batches += 1
    img = filmmod.to_rgb(reduce_film(film, mesh))
    if stats is not None:
        stats.update(batches=batches, lane_width=regenmod.REGEN_LANE_WIDTH if use_regen else 0,
                     wall_s=rdr.wall_since(t0, scene.device))
    return img


def render_bdpt_sharded(scene: sa.Scene, camera: cam.Camera, spp: int, max_depth: int = 5,
                        sampler_cfg: Optional[smpl.SamplerCfg] = None, mesh=None, accel=None,
                        max_lanes: int = bdptmod.MAX_LANES, crop_rect=None,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """``bdpt.render_bdpt`` over the mesh: this rank's band of the crop
    rect's rows (px0, px1, py0, py1) in the batches render_bdpt takes for
    the whole rect; each rank's film, the t = 1 splats included, summed.
    stats, where given, gets this rank's batches."""
    if sampler_cfg is None:
        sampler_cfg = smpl.make_sampler(smpl.RANDOM, spp, camera.resolution)
    mesh = _mesh_of(scene, mesh)
    px0, px1, py0, py1 = _crop(camera, crop_rect)
    cw = px1 - px0
    spp_per_batch = max(1, min(spp, max_lanes // (cw * (py1 - py0))))
    y0, y1 = band(py1 - py0, mesh.size(), mesh_rank(mesh))
    film = filmmod.make_film(camera.resolution, scene.device)
    batches = 0
    if y1 > y0:
        batches = bdptmod.add_rect(scene, camera, spp, max_depth, sampler_cfg, accel, film,
                                   (py0 + y0, y1 - y0, px0, cw), spp_per_batch)
    film = reduce_film(film, mesh)
    film.splatted = True  # BDPT's films always hold splats
    if stats is not None:
        stats["batches"] = batches
    return bdptmod.resolve(film, spp, crop_rect)


def render_sppm_sharded(scene: sa.Scene, camera: cam.Camera, sampler_cfg, n_iterations: int = 16,
                        photons_per_iter: int = 0, max_depth: int = 5,
                        initial_radius: float = 0.0, mesh=None, accel=None, seed: int = 0,
                        stats: Optional[dict] = None, crop_rect=None) -> torch.Tensor:
    """``sppm.render_sppm`` over the mesh.  Each iteration: the camera pass
    on this rank's contiguous share of the pixels (padded to a multiple of
    the mesh's ranks, the padding no visible point), the visible points and
    their direct light gathered in rank order, which is pixel order; the
    grid built on every rank; this rank's photons idx0 = rank x ph_shard
    .. + ph_shard (photons_per_iter, one a pixel by default, rounded up to
    a multiple of the ranks) deposited by S1; phi and m summed over the
    mesh before the radius update.  A bucket overflow raises the scan's
    depth on every rank alike (its MAX over the mesh).  stats as
    render_sppm's."""
    sp.check_supported(scene, accel)
    mesh = _mesh_of(scene, mesh)
    n, r = mesh.size(), mesh_rank(mesh)
    dev = scene.device
    w, h = camera.resolution
    px0, px1, py0, py1 = _crop(camera, crop_rect)
    n_pix = (px1 - px0) * (py1 - py0)
    if photons_per_iter <= 0:
        photons_per_iter = n_pix
    ph_shard = -(-photons_per_iter // n)
    photons_per_iter = ph_shard * n
    if initial_radius <= 0.0:
        initial_radius = float(scene.world_radius) * 2.0 / max(w, h)
    light_dist = pathmod._light_select_dist(scene)
    per = -(-n_pix // n)
    mine = torch.arange(r * per, (r + 1) * per, dtype=torch.int64, device=dev)
    lane_ok = mine < n_pix
    mine = torch.clamp(mine, max=n_pix - 1)
    pixels = torch.stack([px0 + mine % (px1 - px0), py0 + mine // (px1 - px0)], -1)
    p_pad = per * n
    state = sp.SPPMState(torch.full((p_pad,), float(initial_radius), device=dev),
                         torch.zeros((p_pad, 3), device=dev), torch.zeros(p_pad, device=dev),
                         torch.zeros((p_pad, 3), device=dev))
    total_overflow = last_res = last_max = 0
    max_vps = sp.MAX_VPS_PER_CELL
    for i in range(n_iterations):
        ctx = smpl.make_ctx(sampler_cfg, pixels, torch.full((per,), i, device=dev))
        u_film, u_time, u_lens = smpl.get_camera_dims(sampler_cfg, ctx, pixels)
        rays = cam.generate_rays(camera, pixels.to(torch.float32) + u_film, u_lens, u_time)
        vps, ld_inc = sp.camera_pass(scene, sampler_cfg, ctx, rays.o, rays.d, max_depth,
                                     light_dist, accel)
        vps = vps._replace(valid=vps.valid & lane_ok)
        vps = sp.VisiblePoints(*(gather_cat(x, mesh) for x in vps))
        ld_inc = gather_cat(torch.where(lane_ok[:, None], ld_inc, 0.0), mesh)
        grid = sp.build_grid(vps, state.radius, max_vps, shuffle=i)
        events = sp.photon_pass(scene, ph_shard, max_depth, i, light_dist, accel, seed,
                                idx0=r * ph_shard)
        if events is None:
            phi, mcount = torch.zeros((p_pad, 3), device=dev), torch.zeros(p_pad, device=dev)
        else:
            phi, mcount = sp.deposit_events(scene, vps, state.radius, grid, *events, max_vps, i,
                                            seed)
        all_reduce(phi, mesh)
        all_reduce(mcount, mesh)
        state = sp.update_state(state, vps, ld_inc, phi, mcount)
        overflow = all_reduce(torch.tensor([grid.overflow], device=dev), mesh,
                              dist.ReduceOp.MAX)
        overflow = int(overflow[0])
        total_overflow += overflow
        last_res, last_max = grid.res, max_vps
        max_vps = sp.adapt_max_vps(max_vps, overflow)
    if stats is not None:
        stats.update(grid_bucket_overflow=total_overflow, grid_res_last=last_res,
                     max_ev_last=last_max)
    state = sp.SPPMState(*(x[:n_pix] for x in state))
    return sp.resolve(state, n_iterations, photons_per_iter, (w, h), crop_rect)


def render_mlt_sharded(scene: sa.Scene, camera: cam.Camera, mutations_per_pixel: int = 16,
                       max_depth: int = 5, n_chains: int = 4096, n_bootstrap: int = 16384,
                       mesh=None, accel=None, seed: int = 7, depth_stratified: bool = False,
                       crop_rect=None, stats: Optional[dict] = None) -> torch.Tensor:
    """``mlt.render_mlt`` over the mesh: n_chains rounded up to a multiple
    of the ranks, each rank mutating a contiguous range of them.  Every rank
    draws render_mlt's numbers from one generator of the same seed (the
    bootstrap, the picks, then each mutation's draws for every chain, of
    which it keeps its own rows), so a world of one is render_mlt draw for
    draw; the splat films are summed.  stats as render_mlt's."""
    mesh = _mesh_of(scene, mesh)
    n, r = mesh.size(), mesh_rank(mesh)
    dev = scene.device
    w, h = camera.resolution
    px0, px1, py0, py1 = _crop(camera, crop_rect)
    crop_area = (px1 - px0) * (py1 - py0)
    pcfg = pathmod.PathCfg(max_depth, 1.0)
    cfg_s = smpl.make_sampler(smpl.RANDOM, 1, camera.resolution)
    n_pss = mltmod.n_pss_for_depth(max_depth, scene.has_media)
    n_chains = -(-n_chains // n) * n
    own = slice(r * (n_chains // n), (r + 1) * (n_chains // n))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    boot = torch.rand((n_bootstrap, n_pss), generator=gen, device=dev)
    u_pick = torch.rand(n_chains, generator=gen, device=dev)
    b, starts = mltmod.bootstrap_pick(scene, camera, pcfg, cfg_s, accel, depth_stratified,
                                      crop_rect, boot, u_pick)
    pss_cur = starts[own]
    cur_eval = mltmod._eval_target(scene, camera, pcfg, cfg_s, pss_cur, accel, depth_stratified,
                                   crop_rect)
    film = filmmod.make_film((w, h), dev)
    n_mut = max(1, (crop_area * mutations_per_pixel) // n_chains)
    for _ in range(n_mut):
        draws = mltmod.mutation_uniforms(gen, n_chains, n_pss, dev)
        pss_cur, cur_eval, film = mltmod._mutation_step(
            scene, camera, pcfg, cfg_s, accel, depth_stratified, crop_rect, pss_cur, cur_eval,
            film, tuple(x[own] for x in draws))
    b = float(b)
    if stats is not None:
        stats.update(mutations=n_mut, b=b)
    return mltmod.resolve(all_reduce(film.splat, mesh), b, crop_area, n_mut, n_chains, crop_rect)

