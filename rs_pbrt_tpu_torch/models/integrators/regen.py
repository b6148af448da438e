"""Wavefront path regeneration: a fixed pool of lanes that finished paths
hand over to paths not yet traced.

The port of the JAX package's ``models/integrators/regen.py`` (the
reference's tile queue feeding idle threads, blockqueue/mod.rs:11-78, as a
wavefront: Laine et al. 2013).  The fixed-depth loop traverses every lane at
every bounce, dead or alive; here each iteration runs one vertex of every
lane, each lane at its own bounce, and then refills the dead lanes with the
next camera paths: a cumsum over the dead lanes ranks them, and the new
paths' rays are gathered by path id.  Every lane reads its bounce's Sobol'
dims (seven, or 15 in a scene with subsurface materials) from one table
drawn for the whole batch, indexed by path id and bounce, so each path
takes the same samples and the same arithmetic as in the fixed-depth loop,
and the two agree per path.

Eligibility (``eligible``): the path integrator through a tree (the
triangles' BVH or kd-tree, the curves' tree or the instances' trees:
``scene_intersect.uses_tree``), the Sobol' sampler, every bounce's
dims in one K1 launch (dims_per_bounce x max_depth <= 128, as the JAX
regen.py:59-61 counts them), a scene without ray differentials (no image
map bound to a material: refilled lanes carry none), and more paths than
one lane width.  A refilled lane takes its new path's ray time too
(the JAX regen.py:116-122, 162-163).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import differentials as rd
from ...ops import scene_intersect as si
from ...ops import sobol_kernel as sk
from ...scene import arrays as sa
from ...utils import vecmath as vm
from .. import samplers as smpl
from .path import (DIM_CAMERA, PathCfg, _add_emitted, _dist_at, _light_select_dist,
                   _shade_and_extend, dims_per_bounce)

# lanes in flight; a batch streams its paths through them.  Chosen on an
# NVIDIA H100 at 700 W (rs_pbrt_tpu_torch/tools/regen_sweep.py, PERF.md):
# an iteration queues ~1,700 small ops, ~15-20 ms of host time, so up to
# ~2^20 lanes the card waits on the host; at 2^21 the two meet, and 2^22
# is no faster.  At the TPU's 2^14 the 5.24M-triangle statue iterates ~60x
# as often and renders ~50x slower.
REGEN_LANE_WIDTH = 1 << 21


def eligible(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg, accel, n_paths: int,
             lane_width: Optional[int] = None) -> bool:
    """Can radiance_regen serve this call?  Only where the scene is
    traversed through a tree, its triangles' BVH or kd-tree, its curves' or
    its instances' (build_accel gives small scenes none; the JAX package
    asks only for an accel), and with more paths than one lane width,
    below which nothing is refilled."""
    width = lane_width or REGEN_LANE_WIDTH
    total = dims_per_bounce(scene) * cfg.max_depth
    return (si.uses_tree(scene, accel)
            and cfg.max_depth > 0 and sampler_cfg.kind == smpl.SOBOL
            and 0 < total <= sk.MAX_DIMS and not rd.needs_diffs(scene) and n_paths > width)


def _paths_remain(alive: torch.Tensor) -> bool:
    """The loop's condition, read on the host once an iteration: a read from
    the card that waits for the iteration's work."""
    return bool(alive.any())


def radiance_regen(scene: sa.Scene, cfg: PathCfg, sampler_cfg: smpl.SamplerCfg,
                   ctx: smpl.SampleCtx, ray_o: torch.Tensor, ray_d: torch.Tensor, accel,
                   light_distrib=None, lane_width: Optional[int] = None,
                   stats: Optional[dict] = None, time=None) -> torch.Tensor:
    """(N, 3) radiance along N camera rays in path order, the regeneration
    loop's estimate: per path the samples and arithmetic of
    ``general_radiance``.  lane_width defaults to REGEN_LANE_WIDTH.  stats,
    when given, gains the iterations run (``iterations``, added to what it
    holds).  time: the rays' times (N,) in the shutter (None: 0)."""
    si.check_supported(scene, accel)
    n, dev = ray_o.shape[0], ray_o.device
    width = min(lane_width or REGEN_LANE_WIDTH, n)
    md = cfg.max_depth
    dist_at = _dist_at(scene, light_distrib)
    light_dist = _light_select_dist(scene) if scene.n_lights > 0 else None
    dpb = dims_per_bounce(scene)
    # every path's bounce dims in one K1 launch, dims-major: (dpb md, n), so
    # a lane's dims of bounce b are rows dpb b .. dpb b + dpb - 1 at its path
    # id.  A refilled lane reads its new path's dims from this table and
    # draws none, so every index K1 reads is one the batch's context made,
    # and the context's promise of sample numbers below spp (frame_lt_spp),
    # on which K1's exact index width rests, holds for every lane.
    table = smpl.get_dims(sampler_cfg, ctx, DIM_CAMERA, dpb * md).t().contiguous()
    dim_rows = torch.arange(dpb, dtype=torch.int64, device=dev)[None, :] * n
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    inf = float(vm.INFINITY)

    pid = torch.arange(width, dtype=torch.int64, device=dev)
    o, d = ray_o[:width], ray_d[:width]
    t_lane = None if time is None else time[:width]
    L = torch.zeros((width, 3), device=dev)
    beta = torch.ones((width, 3), device=dev)
    alive = torch.ones(width, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(width, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.ones(width, device=dev)
    eta_scale = torch.ones(width, device=dev)
    bounce = torch.zeros(width, dtype=torch.int64, device=dev)
    nxt = torch.tensor(width, dtype=torch.int64, device=dev)  # the next path id to start
    # one row past the paths takes the writes of lanes that hold no path
    out = torch.zeros((n + 1, 3), device=dev)
    iterations = 0
    while True:
        # one vertex of every lane, each at its own bounce; dead lanes cast
        # with t_max = -1, which the traversal ends at once
        it = si.scene_intersect(scene, o, d, torch.where(alive, inf, -1.0), accel, t_lane)
        L = _add_emitted(scene, dist_at, it, o, d, L, beta, alive, specular_bounce,
                         prev_bsdf_pdf)
        alive = alive & it.valid
        # the vertex at max_depth only collects emission, as the fixed-depth
        # loop's last pass does
        at_limit = bounce >= md
        rows = (torch.clamp(bounce, max=md - 1) * dpb * n)[:, None] + dim_rows
        dims = table.view(-1)[rows + torch.clamp(pid, min=0)[:, None]]
        o, d, L, beta, alive, specular_bounce, prev_bsdf_pdf, eta_scale = _shade_and_extend(
            scene, cfg, accel, dist_at, dims, bounce, it,
            (o, d, L, beta, alive & ~at_limit, specular_bounce, prev_bsdf_pdf, eta_scale),
            light_dist, time=t_lane)
        bounce = torch.where(alive, bounce + 1, bounce)

        # finished paths write their radiance; their lanes take the next ids
        dead = ~alive
        out[torch.where(dead & (pid >= 0), pid, n)] = L
        dead_n = dead.to(torch.int64)
        new_id = nxt + torch.cumsum(dead_n, 0) - 1
        fill = dead & (new_id < n)
        src = torch.clamp(new_id, max=n - 1)
        o = torch.where(fill[:, None], ray_o[src], o)
        d = torch.where(fill[:, None], ray_d[src], d)
        if t_lane is not None:
            t_lane = torch.where(fill, time[src], t_lane)
        L = torch.where(fill[:, None], 0.0, L)
        beta = torch.where(fill[:, None], 1.0, beta)
        specular_bounce = specular_bounce | fill
        prev_bsdf_pdf = torch.where(fill, 1.0, prev_bsdf_pdf)
        eta_scale = torch.where(fill, 1.0, eta_scale)
        bounce = torch.where(fill, 0, bounce)
        pid = torch.where(fill, new_id, torch.where(dead, -1, pid))
        alive = alive | fill
        nxt = torch.clamp(nxt + dead_n.sum(), max=n)
        iterations += 1
        # while paths wait every lane is alive (each dead lane took one), so
        # the JAX loop's nxt < n or any(alive) is any(alive).  Once it is
        # false, every lane is dead with no path, and an iteration more
        # would write only the spare row
        if not _paths_remain(alive):
            break
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iterations
    return out[:n]
