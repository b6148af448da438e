"""Render driver: samples -> camera rays -> integrator -> film.

The port of the JAX package's ``models/integrators/render.py`` (reference
src/core/integrator.rs:70-220) for the path, whitted and directlighting
integrators.  The pixel grid is one flat wavefront of (pixel, sample)
lanes, ``nb`` ordered copies of the grid with x fastest, batched over
samples per pixel to stay under ``max_lanes``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ...ops import film as filmmod
from ...ops import path_kernel as pk
from ...scene import arrays as sa
from .. import cameras as cam
from .. import samplers as smpl
from . import direct as directmod
from . import path as pathmod

INTEGRATORS = ("path", "whitted", "directlighting")


class RenderCfg(NamedTuple):
    """The JAX package's RenderCfg, field for field, with its defaults."""

    integrator: str
    spp: int
    max_depth: int
    rr_threshold: float
    light_strategy: str = "power"  # "uniform" | "power" | "spatial" (lightdistrib.rs:393)
    crop: Optional[tuple] = None  # the film's crop window (x0, x1, y0, y1)
    extra: Optional[dict] = None  # integrator parameters (directlighting: "strategy")
    accelerator: str = "bvh"  # ignored: no ported scene needs an accelerator yet


def check_cfg(scene: sa.Scene, cfg: RenderCfg):
    """Raises NotImplementedError for a RenderCfg the port cannot render yet."""
    if cfg.integrator not in INTEGRATORS:
        raise NotImplementedError(f"integrator {cfg.integrator!r} is not ported yet "
                                  "(ROADMAP queue A)")
    if cfg.crop is not None:
        raise NotImplementedError("crop windows are not ported yet (ROADMAP queue A)")
    if cfg.light_strategy == "spatial" and scene.n_lights > 0:
        raise NotImplementedError("spatial light selection is not ported yet (ROADMAP queue A)")


def radiance_fn(cfg: RenderCfg, mega: Optional[pk.MegaCfg] = None):
    """Integrator dispatch (integrator.rs:31): (scene, sampler_cfg, ctx, o,
    d) -> (N, 3) radiance.  mega: the scene's MegaCfg for "path"."""
    if cfg.integrator == "path":
        pcfg = pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold)
        return lambda scene, scfg, ctx, o, d: pathmod.radiance(scene, pcfg, scfg, ctx, o, d,
                                                                 mega=mega)
    if cfg.integrator == "whitted":
        wcfg = directmod.WhittedCfg(cfg.max_depth)
        return lambda scene, scfg, ctx, o, d: directmod.whitted_radiance(scene, wcfg, scfg, ctx,
                                                                          o, d)
    if cfg.integrator == "directlighting":
        sample_all = (cfg.extra or {}).get("strategy", "all") == "all"
        dcfg = directmod.DirectLightingCfg(cfg.max_depth, sample_all)
        return lambda scene, scfg, ctx, o, d: directmod.directlighting_radiance(
            scene, dcfg, scfg, ctx, o, d)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def camera_rays(camera: cam.Camera, sampler_cfg: smpl.SamplerCfg, sample0: int, nb: int):
    """(SampleCtx, CameraRays) of samples sample0 .. sample0+nb-1 of every
    pixel: nb copies of the pixel grid, x fastest."""
    w, h = camera.resolution
    dev = camera.device
    xs = torch.arange(w, dtype=torch.int64, device=dev)
    ys = torch.arange(h, dtype=torch.int64, device=dev)
    pixel = torch.stack([xs.repeat(h), ys.repeat_interleave(w)], -1).repeat(nb, 1)
    sample_num = torch.arange(sample0, sample0 + nb, dtype=torch.int64,
                              device=dev).repeat_interleave(w * h)
    ctx = smpl.make_ctx(sampler_cfg, pixel, sample_num, frame_lt_spp=True)
    u_film, u_time, u_lens = smpl.get_camera_dims(sampler_cfg, ctx, pixel)
    return ctx, cam.generate_rays(camera, pixel.to(torch.float32) + u_film, u_lens, u_time)


def render_batch(scene: sa.Scene, camera: cam.Camera, cfg: RenderCfg,
                 sampler_cfg: smpl.SamplerCfg, film: filmmod.Film, filter_cfg: filmmod.FilterCfg,
                 sample0: int, nb: int, mega: Optional[pk.MegaCfg] = None) -> filmmod.Film:
    """Samples sample0 .. sample0+nb-1 of every pixel, added to `film`."""
    ctx, rays = camera_rays(camera, sampler_cfg, sample0, nb)
    L = radiance_fn(cfg, mega)(scene, sampler_cfg, ctx, rays.o, rays.d)
    L = L * rays.weight[:, None]
    return filmmod.add_samples_grid(film, filter_cfg, L, nb)


def render(scene: sa.Scene, camera: cam.Camera, cfg: RenderCfg, sampler_cfg: smpl.SamplerCfg,
           filter_cfg: Optional[filmmod.FilterCfg] = None, max_lanes: int = 1 << 20,
           stats: Optional[dict] = None) -> torch.Tensor:
    """Renders the whole image; returns linear RGB (H, W, 3) on the scene's
    device.  stats, when given, is filled with camera_rays, spp, wall_s and
    paths_per_s (wall time on the host clock, synchronized with the card)."""
    check_cfg(scene, cfg)
    dev = scene.device
    if camera.device != dev:
        raise ValueError(f"camera lies on {camera.device}, scene on {dev}")
    if filter_cfg is None:
        filter_cfg = filmmod.make_filter(filmmod.FILTER_BOX)
    w, h = camera.resolution
    n_pix = w * h
    mega = pk.mega_cfg(scene) if cfg.integrator == "path" else None
    film = filmmod.make_film((w, h), dev)
    t0 = time.perf_counter()
    spp_per_batch = max(1, min(cfg.spp, max_lanes // n_pix))
    sample = 0
    while sample < cfg.spp:
        nb = min(spp_per_batch, cfg.spp - sample)
        film = render_batch(scene, camera, cfg, sampler_cfg, film, filter_cfg, sample, nb, mega)
        sample += nb
    img = filmmod.to_rgb(film)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = max(time.perf_counter() - t0, 1e-9)
        stats.update(camera_rays=n_pix * cfg.spp, spp=cfg.spp, resolution=(w, h), wall_s=dt,
                     paths_per_s=n_pix * cfg.spp / dt)
    return img
