"""Render driver: samples -> camera rays -> integrator -> film.

The port of the JAX package's ``models/integrators/render.py`` (reference
src/core/integrator.rs:70-220) for the path integrator.  The pixel grid is
one flat wavefront of (pixel, sample) lanes, ``nb`` ordered copies of the
grid with x fastest, batched over samples per pixel to stay under
``max_lanes``.
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
from . import path as pathmod


class RenderCfg(NamedTuple):
    integrator: str
    spp: int
    max_depth: int
    rr_threshold: float


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
    L = pathmod.radiance(scene, pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold), sampler_cfg,
                         ctx, rays.o, rays.d, mega=mega)
    L = L * rays.weight[:, None]
    return filmmod.add_samples_grid(film, filter_cfg, L, nb)


def render(scene: sa.Scene, camera: cam.Camera, cfg: RenderCfg, sampler_cfg: smpl.SamplerCfg,
           filter_cfg: Optional[filmmod.FilterCfg] = None, max_lanes: int = 1 << 20,
           stats: Optional[dict] = None) -> torch.Tensor:
    """Renders the whole image; returns linear RGB (H, W, 3) on the scene's
    device.  stats, when given, is filled with camera_rays, spp, wall_s and
    paths_per_s (wall time on the host clock, synchronized with the card)."""
    if cfg.integrator != "path":
        raise NotImplementedError(f"integrator {cfg.integrator!r} is not ported yet (ROADMAP slice 5)")
    dev = scene.device
    if camera.device != dev:
        raise ValueError(f"camera lies on {camera.device}, scene on {dev}")
    if filter_cfg is None:
        filter_cfg = filmmod.make_filter(filmmod.FILTER_BOX)
    w, h = camera.resolution
    n_pix = w * h
    mega = pk.mega_cfg(scene)
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
