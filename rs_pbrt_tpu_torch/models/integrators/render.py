"""Render driver: samples -> camera rays -> integrator -> film.

The port of the JAX package's ``models/integrators/render.py`` (reference
src/core/integrator.rs:70-220) for every integrator of the JAX package:
path, volpath, whitted, directlighting and ao through the batches here;
sppm, bdpt and mlt through their own loops (``sppm.py``, ``bdpt.py``,
``mlt.py``), as the JAX render dispatches them (its render.py:278-323).
The pixel grid (the film's crop window, or the whole film) is one flat
wavefront of (pixel, sample) lanes, ``nb`` ordered copies of the
grid with x fastest, batched over samples per pixel.  Scenes above the
brute-force limit, and scenes with instances, render with their trees
(``accel``, ``ops/scene_intersect.build_accel``: a BVH, or a kd-tree where
``RenderCfg.accelerator`` is "kdtree"); there, by default, the path
integrator streams each batch's paths through a pool of lanes that it
refills as paths finish (``regen.py``), as the JAX package's render does.
The camera rays' times reach the path integrator, whose casts see moving
meshes at them; the other integrators see them at time 0, as in the JAX
package.
Where a scene binds an image map to a material slot (``needs_diffs``), the
path, volpath, whitted and directlighting integrators take the camera
rays' differentials, whose footprints filter the image maps at the first
hit (``ops/differentials.py``, render.py:53-65 and :164-172 of the JAX
package).
A render saves its film and the next sample to a ``.npz`` checkpoint every
``checkpoint_every`` samples per pixel and resumes from it (the JAX
render.py:187-210, :348-423): the same keys, so a checkpoint written by
either package resumes in the other.  Autograd records through a render
whose scene or camera tensors require grad (``diff/grad.py``): the path
integrator's sampling is detached as in the JAX package, K2 is refused,
and the hits, textures and filter splat take their backward passes (G1,
T2, R2).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import differentials as rd
from ...ops import film as filmmod
from ...ops import path_kernel as pk
from ...ops import scene_intersect as si
from ...scene import arrays as sa
from .. import cameras as cam
from .. import samplers as smpl
from . import bdpt as bdptmod
from . import direct as directmod
from . import mlt as mltmod
from . import path as pathmod
from . import regen as regenmod
from . import sppm as sppmmod
from . import volpath as volpathmod

INTEGRATORS = ("path", "volpath", "whitted", "directlighting", "ao", "sppm", "bdpt", "mlt")
# paths a batch at most, by default; sized by memory on an NVIDIA H100
# 80GB (chip_smoke.py phase 12, PERF.md).  At depth 5 the regeneration loop
# holds ~243 bytes a path (140 of hoisted dims, 24 of camera ray, 12 of
# radiance, the rest the camera's and the sample context's), the
# fixed-depth loop ~920 (every lane's state at once), so 2^26 paths (a
# 1024x1024, 64 spp render in one batch, one drain) hold ~15 or ~57 GiB
MAX_LANES = 1 << 26


class RenderCfg(NamedTuple):
    """The JAX package's RenderCfg, field for field, with its defaults."""

    integrator: str
    spp: int
    max_depth: int
    rr_threshold: float
    light_strategy: str = "power"  # "uniform" | "power" | "spatial" (lightdistrib.rs:393)
    crop: Optional[tuple] = None  # the film's crop window (x0, x1, y0, y1)
    # integrator parameters (directlighting: "strategy"; ao: "n_samples",
    # "cos_sample"; sppm: "n_iterations", "photons_per_iteration",
    # "initial_radius"; mlt: "mutations_per_pixel", "chains",
    # "bootstrap_samples")
    extra: Optional[dict] = None
    # the accel's kind, "bvh" or "kdtree": the caller builds it
    # (scene_intersect.build_accel(scene, kind=cfg.accelerator)), as in the JAX package
    accelerator: str = "bvh"


def check_cfg(cfg: RenderCfg):
    """Raises ValueError for an integrator or an accelerator that neither
    package has: the port renders every integrator of the JAX package, on
    one device or sharded over a mesh.  What it still lacks are the front
    ends (ROADMAP A18)."""
    if cfg.integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {cfg.integrator!r}: the port renders "
                         f"{INTEGRATORS} (the scene-file front ends come with ROADMAP A18)")
    if cfg.accelerator not in si.ACCELERATORS:
        raise ValueError(f"accelerator {cfg.accelerator!r}: the port builds {si.ACCELERATORS}")


def save_checkpoint(path, film: filmmod.Film, next_sample: int):
    """Writes the progressive render's state (the film's sums and the next
    sample per pixel) to the .npz at path, with the JAX package's keys
    (its render.py:187-197): rgb, weight, splat, next_sample."""
    np.savez(path, rgb=film.rgb.detach().cpu().numpy(), weight=film.weight.detach().cpu().numpy(),
             splat=film.splat.detach().cpu().numpy(), next_sample=np.int64(next_sample))


def load_checkpoint(path, device="cuda"):
    """(Film on device, next_sample) of the checkpoint at path, or None
    where there is none (the JAX render.py:200-210)."""
    if not os.path.exists(path):
        return None
    from ...device import resolve

    dev = resolve(device)
    z = np.load(path)
    t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=dev)
    splat = t("splat")
    return (filmmod.Film(t("rgb"), t("weight"), splat, splatted=bool(splat.any())),
            int(z["next_sample"]))


# the integrators whose first hits read image maps through ray differentials
DIFFS_INTEGRATORS = ("path", "volpath", "whitted", "directlighting")


def radiance_fn(cfg: RenderCfg, mega: Optional[pk.MegaCfg] = None, accel=None,
                light_distrib=None, regen: bool = False, stats: Optional[dict] = None):
    """Integrator dispatch (integrator.rs:31): (scene, sampler_cfg, ctx, o,
    d, diffs, time) -> (N, 3) radiance; diffs the camera rays'
    differentials or None, time their times in the shutter or None.  mega:
    the scene's MegaCfg for "path"; accel: the scene's trees, passed down
    to scene intersection.  light_distrib, regen, stats and time reach the
    path integrator only: volpath and the direct integrators select lights
    as they do with every strategy and see moving meshes at time 0, as in
    the JAX package (its render.py:79-110)."""
    if cfg.integrator == "path":
        pcfg = pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold)
        return lambda scene, scfg, ctx, o, d, diffs=None, time=None: pathmod.radiance(
            scene, pcfg, scfg, ctx, o, d, mega=mega, accel=accel, light_distrib=light_distrib,
            regen=regen, stats=stats, diffs=diffs, time=time)
    if cfg.integrator == "volpath":
        vcfg = pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold)
        return lambda scene, scfg, ctx, o, d, diffs=None, time=None: volpathmod.radiance(
            scene, vcfg, scfg, ctx, o, d, accel, diffs)
    if cfg.integrator == "whitted":
        wcfg = directmod.WhittedCfg(cfg.max_depth)
        return lambda scene, scfg, ctx, o, d, diffs=None, time=None: directmod.whitted_radiance(
            scene, wcfg, scfg, ctx, o, d, accel, diffs)
    if cfg.integrator == "directlighting":
        sample_all = (cfg.extra or {}).get("strategy", "all") == "all"
        dcfg = directmod.DirectLightingCfg(cfg.max_depth, sample_all)
        return lambda scene, scfg, ctx, o, d, diffs=None, time=None: (
            directmod.directlighting_radiance(scene, dcfg, scfg, ctx, o, d, accel, diffs))
    if cfg.integrator == "ao":
        ex = cfg.extra or {}
        acfg = directmod.AOCfg(int(ex.get("n_samples", 8)), bool(ex.get("cos_sample", True)))
        return lambda scene, scfg, ctx, o, d, diffs=None, time=None: directmod.ao_radiance(
            scene, acfg, scfg, ctx, o, d, accel)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def crop_pixel_rect(resolution, crop):
    """A fractional crop window (x0, x1, y0, y1) -> the integer pixel rect
    (px0, px1, py0, py1) (film.rs:224-262: the corners ceil(res * crop), at
    least one pixel wide); the whole film without one."""
    w, h = resolution
    if crop is None:
        return 0, w, 0, h
    x0, x1, y0, y1 = crop
    px0 = int(np.ceil(w * x0))
    px1 = max(int(np.ceil(w * x1)), px0 + 1)
    py0 = int(np.ceil(h * y0))
    py1 = max(int(np.ceil(h * y1)), py0 + 1)
    return px0, px1, py0, py1


def camera_rays(camera: cam.Camera, sampler_cfg: smpl.SamplerCfg, sample0: int, nb: int,
                rect=None, diffs: bool = False, p_film: bool = False):
    """(SampleCtx, CameraRays) of samples sample0 .. sample0+nb-1 of every
    pixel of rect (y0, h, x0, w), the whole film without one: nb copies of
    the grid, x fastest.  The Sobol' indices are those of the pixels' film
    coordinates.  diffs: (SampleCtx, CameraRays, RayDiffs), the rays'
    differentials at sampler_cfg's spp (differentials.camera_differentials).
    p_film: the lanes' raster points (N, 2) come last too (the JAX
    _camera_rays' p_film)."""
    w, h = camera.resolution
    y0, hh, x0, ww = rect if rect is not None else (0, h, 0, w)
    dev = camera.device
    xs = torch.arange(x0, x0 + ww, dtype=torch.int64, device=dev)
    ys = torch.arange(y0, y0 + hh, dtype=torch.int64, device=dev)
    pixel = torch.stack([xs.repeat(hh), ys.repeat_interleave(ww)], -1).repeat(nb, 1)
    sample_num = torch.arange(sample0, sample0 + nb, dtype=torch.int64,
                              device=dev).repeat_interleave(ww * hh)
    ctx = smpl.make_ctx(sampler_cfg, pixel, sample_num, frame_lt_spp=True)
    u_film, u_time, u_lens = smpl.get_camera_dims(sampler_cfg, ctx, pixel)
    pts = pixel.to(torch.float32) + u_film
    rays = cam.generate_rays(camera, pts, u_lens, u_time)
    out = (ctx, rays)
    if diffs:
        out += (rd.camera_differentials(camera, rays, pts, u_lens, u_time, sampler_cfg.spp),)
    return out + (pts,) if p_film else out


def render_batch(scene: sa.Scene, camera: cam.Camera, cfg: RenderCfg,
                 sampler_cfg: smpl.SamplerCfg, film: filmmod.Film, filter_cfg: filmmod.FilterCfg,
                 sample0: int, nb: int, mega: Optional[pk.MegaCfg] = None, accel=None,
                 rect=None, light_distrib=None, regen: bool = False,
                 stats: Optional[dict] = None) -> filmmod.Film:
    """Samples sample0 .. sample0+nb-1 of every pixel of rect (the crop
    window (y0, h, x0, w), else the whole film), added to `film`: in place
    by pixel for a box of radius <= 0.5 (add_samples_grid), else splatted
    from each lane's raster point through the filter (add_samples: R1 on
    the card), as the JAX render_batch does (its render.py:176-180)."""
    want_diffs = cfg.integrator in DIFFS_INTEGRATORS and rd.needs_diffs(scene)
    ctx, rays, *rest = camera_rays(camera, sampler_cfg, sample0, nb, rect, diffs=want_diffs,
                                   p_film=True)
    diffs = rest[0] if want_diffs else None
    L = radiance_fn(cfg, mega, accel, light_distrib, regen, stats)(
        scene, sampler_cfg, ctx, rays.o, rays.d, diffs, rays.time)
    L = L * rays.weight[:, None]
    if filmmod.grid_filter(filter_cfg):
        return filmmod.add_samples_grid(film, filter_cfg, L, nb, rect)
    return filmmod.add_samples(film, filter_cfg, rest[-1], L)


def path_setup(scene: sa.Scene, cfg: RenderCfg, accel=None) -> tuple:
    """(light_distrib, mega) of a path-family render: the spatial light
    distribution where the path integrator asks for it, and K2's MegaCfg
    where the scene takes it (no accel)."""
    light_distrib = None
    if cfg.integrator == "path" and cfg.light_strategy == "spatial" and scene.n_lights > 0:
        from .. import lightdistrib as ldist

        light_distrib = ldist.build_spatial(scene)
    mega = (pk.mega_cfg(scene, light_distrib) if cfg.integrator == "path" and accel is None
            else None)
    return light_distrib, mega


def render(scene: sa.Scene, camera: cam.Camera, cfg: RenderCfg, sampler_cfg: smpl.SamplerCfg,
           filter_cfg: Optional[filmmod.FilterCfg] = None, accel=None,
           max_lanes: int = MAX_LANES, stats: Optional[dict] = None, crop=None,
           regen: bool = True, checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 0, mesh=None) -> torch.Tensor:
    """Renders the whole image; returns linear RGB (H, W, 3) on the scene's
    device.  accel: the scene's ``build_accel``, needed above
    BRUTE_FORCE_MAX_TRIS triangles.  max_lanes: a batch's paths at most,
    in either loop.  regen: the path integrator regenerates paths where a
    batch takes it (``regen.eligible``, the JAX render's gate,
    render.py:379-397): each batch streams its paths through
    ``regen.REGEN_LANE_WIDTH`` lanes (the port's own width, chosen on the
    card; the JAX package further caps a batch for a TPU's dispatch).  crop: a fractional crop window (x0, x1, y0, y1),
    cfg.crop without one; pixels outside it stay black.  cfg.light_strategy "spatial" builds
    the spatial light distribution once for the path integrator.  stats,
    when given, is filled with camera_rays, spp, resolution, wall_s,
    paths_per_s and max_ray_casts (wall time on the host clock, synchronized
    with the card), and batches, lane_width (0 without regeneration) and
    iterations (of the regeneration loop).  "sppm" renders through
    ``sppm.render_sppm`` with cfg.extra's n_iterations (16),
    photons_per_iteration (0: one a pixel) and initial_radius (0: from the
    world radius); its stats are camera_rays (pixels x iterations),
    resolution, wall_s, paths_per_s, iterations, grid_bucket_overflow,
    grid_res_last and max_ev_last.  "bdpt" renders through
    ``bdpt.render_bdpt`` (the box filter, sampler_cfg's samples, at most
    min(max_lanes, bdpt.MAX_LANES) paths a batch) and "mlt" through
    ``mlt.render_mlt`` with cfg.extra's mutations_per_pixel (16), chains
    (4096) and bootstrap_samples (16384); their stats are camera_rays
    (pixels x spp, or x mutations_per_pixel), resolution, wall_s and
    paths_per_s, with bdpt's batches and mlt's mutations (a chain's) and
    mutations_per_s.  checkpoint_path: the film starts from the checkpoint
    there where one exists, and, with checkpoint_every > 0, is saved there
    whenever checkpoint_every more samples per pixel have been added and
    after the last batch (the path-family integrators; sppm, bdpt and mlt
    ignore it, as in the JAX package).  A resumed render equals the
    uninterrupted one bit for bit where both take the same batches.
    mesh: a DeviceMesh (``parallel/mesh.make_mesh``, ``parallel/distributed
    .make_host_mesh``) that every rank of it renders with, each getting the
    whole image: sppm, bdpt and mlt through their sharded renders, the path
    family through ``render_sharded`` in the fixed-depth loop (no regen, as
    in the JAX package), checkpoints ignored; stats are filled as without
    one, batches and iterations this rank's."""
    check_cfg(cfg)
    dev = scene.device
    if camera.device != dev:
        raise ValueError(f"camera lies on {camera.device}, scene on {dev}")
    if cfg.integrator == "sppm":
        return _render_sppm(scene, camera, cfg, sampler_cfg, accel, stats,
                            crop if crop is not None else cfg.crop, mesh)
    if cfg.integrator in ("bdpt", "mlt"):
        return _render_bidirectional(scene, camera, cfg, sampler_cfg, accel, max_lanes, stats,
                                     crop if crop is not None else cfg.crop, mesh)
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_pixel_rect((w, h), crop if crop is not None else cfg.crop)
    run = None if stats is None else {}
    if mesh is not None:
        img = _sharded("render_sharded")(scene, camera, cfg, sampler_cfg, filter_cfg, mesh,
                                         accel, crop=crop, max_lanes=max_lanes, stats=run)
    else:
        img = _render_path_family(scene, camera, cfg, sampler_cfg, filter_cfg, accel, max_lanes,
                                  (py0, py1 - py0, px0, px1 - px0), regen, checkpoint_path,
                                  checkpoint_every, run)
    if stats is not None:
        paths = (py1 - py0) * (px1 - px0) * cfg.spp
        stats.update(camera_rays=paths, spp=cfg.spp, resolution=(w, h), wall_s=run["wall_s"],
                     paths_per_s=paths / run["wall_s"],
                     max_ray_casts=paths * (cfg.max_depth + 1) * 2, batches=run["batches"],
                     lane_width=run["lane_width"], iterations=run.get("iterations", 0))
    return img


def wall_since(t0: float, dev: torch.device) -> float:
    """Seconds on the host clock since t0, synchronized with the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return max(time.perf_counter() - t0, 1e-9)


def _render_path_family(scene, camera, cfg: RenderCfg, sampler_cfg, filter_cfg, accel,
                        max_lanes: int, rect, regen: bool, checkpoint_path, checkpoint_every,
                        run: Optional[dict]) -> torch.Tensor:
    """render's batches on one device over the pixel rect (y0, h, x0, w);
    run, where given, gains batches, lane_width, iterations and wall_s (from
    the first batch to the image)."""
    if filter_cfg is None:
        filter_cfg = filmmod.make_filter(filmmod.FILTER_BOX)
    n_pix = rect[1] * rect[3]
    light_distrib, mega = path_setup(scene, cfg, accel)
    spp_per_batch = max(1, min(cfg.spp, max_lanes // n_pix))
    use_regen = regen and cfg.integrator == "path" and regenmod.eligible(
        scene, pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold), sampler_cfg, accel,
        spp_per_batch * n_pix)
    film = filmmod.make_film(camera.resolution, scene.device)
    sample = batches = since_ck = 0
    if checkpoint_path is not None:
        ck = load_checkpoint(checkpoint_path, scene.device)
        if ck is not None:
            film, sample = ck
    t0 = time.perf_counter()
    while sample < cfg.spp:
        nb = min(spp_per_batch, cfg.spp - sample)
        film = render_batch(scene, camera, cfg, sampler_cfg, film, filter_cfg, sample, nb, mega,
                            accel, rect, light_distrib, use_regen, run)
        sample += nb
        batches += 1
        since_ck += nb
        if checkpoint_path is not None and checkpoint_every and (
                since_ck >= checkpoint_every or sample >= cfg.spp):
            save_checkpoint(checkpoint_path, film, sample)
            since_ck = 0
    img = filmmod.to_rgb(film)
    if run is not None:
        run.update(batches=batches, lane_width=regenmod.REGEN_LANE_WIDTH if use_regen else 0,
                   wall_s=wall_since(t0, scene.device))
    return img


def _sharded(name: str):
    from ...parallel import mesh as pmesh

    return getattr(pmesh, name)


def _render_sppm(scene, camera, cfg: RenderCfg, sampler_cfg, accel, stats, crop, mesh=None):
    """render's sppm branch (the JAX render.py:306-320)."""
    ex = cfg.extra or {}
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_pixel_rect((w, h), crop)
    n_it = int(ex.get("n_iterations", 16))
    run = {}
    t0 = time.perf_counter()
    kw = {} if mesh is None else dict(mesh=mesh)
    fn = sppmmod.render_sppm if mesh is None else _sharded("render_sppm_sharded")
    img = fn(scene, camera, sampler_cfg, n_iterations=n_it,
             photons_per_iter=int(ex.get("photons_per_iteration", 0)), max_depth=cfg.max_depth,
             initial_radius=float(ex.get("initial_radius", 0.0)), accel=accel, stats=run,
             crop_rect=(px0, px1, py0, py1) if crop is not None else None, **kw)
    if stats is not None:
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        dt = max(time.perf_counter() - t0, 1e-9)
        rays = (px1 - px0) * (py1 - py0) * n_it
        stats.update(camera_rays=rays, resolution=(w, h), wall_s=dt, paths_per_s=rays / dt,
                     iterations=n_it, **run)
    return img


def _render_bidirectional(scene, camera, cfg: RenderCfg, sampler_cfg, accel, max_lanes, stats,
                          crop, mesh=None):
    """render's bdpt and mlt branches (the JAX render.py:278-305)."""
    ex = cfg.extra or {}
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_pixel_rect((w, h), crop)
    crop_rect = (px0, px1, py0, py1) if crop is not None else None
    kw = {} if mesh is None else dict(mesh=mesh)
    run = {}
    t0 = time.perf_counter()
    if cfg.integrator == "bdpt":
        fn = bdptmod.render_bdpt if mesh is None else _sharded("render_bdpt_sharded")
        img = fn(scene, camera, cfg.spp, cfg.max_depth, sampler_cfg=sampler_cfg, accel=accel,
                 max_lanes=min(max_lanes, bdptmod.MAX_LANES), crop_rect=crop_rect, stats=run,
                 **kw)
        per_pixel = cfg.spp
    else:
        per_pixel = int(ex.get("mutations_per_pixel", 16))
        fn = mltmod.render_mlt if mesh is None else _sharded("render_mlt_sharded")
        img = fn(scene, camera, mutations_per_pixel=per_pixel, max_depth=cfg.max_depth,
                 n_chains=int(ex.get("chains", 4096)),
                 n_bootstrap=int(ex.get("bootstrap_samples", 16384)), accel=accel,
                 crop_rect=crop_rect, stats=run, **kw)
    if stats is not None:
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        dt = max(time.perf_counter() - t0, 1e-9)
        rays = (px1 - px0) * (py1 - py0) * per_pixel
        stats.update(camera_rays=rays, resolution=(w, h), wall_s=dt, paths_per_s=rays / dt, **run)
        if cfg.integrator == "mlt":
            stats["mutations_per_s"] = run["mutations"] * int(ex.get("chains", 4096)) / dt
    return img
