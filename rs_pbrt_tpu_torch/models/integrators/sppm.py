"""Stochastic progressive photon mapping.

The port of the JAX package's ``models/integrators/sppm.py`` (reference
src/integrators/sppm.rs), its phases as plain functions on tensors:

1. ``camera_pass``: trace each pixel's camera ray to its first vertex with
   a non-specular lobe, the visible point (VP), adding direct light by NEE
   along the way and following specular bounces (sppm.rs:108-331); as in
   the JAX package, a camera ray that escapes adds no infinite light
   (pbrt's SPPM adds it);
2. ``build_grid``: the VPs sorted by cell of a uniform grid whose cells are
   at least the largest radius wide (sppm.rs:336-448 builds a hash grid of
   atomic lists; the JAX package sorts, and so does the port);
3. ``photon_pass``: photons emitted from the lights (``lights.sample_le``,
   the infinite and the quadric lights included)
   and traced through the scene, their hits at depths 1 and on collected
   as events (p, wi, beta);
4. ``deposit_events``: the events sorted by cell into a packed table,
   and every VP's scan of its 27 neighbour cells' buckets, up to max_ev
   rows each: S1 (``ops/sppm_kernel.deposit``, csrc/sppm.cu);
5. ``update_state``: the radius, photon count and flux update with
   gamma = 2/3 (sppm.rs:736-764); ``resolve`` gives the image.

``render_sppm`` runs the iterations.  Its random numbers are the hash of
``utils/rng.py``, keyed as the JAX package keys them, so an iteration
draws the JAX package's samples.  Buckets deeper than max_ev are an
unbiased reservoir: each iteration shuffles the order within a cell
(stable sorts by a random key, then by cell) and weighs each reachable
entry by depth / min(depth, max_ev); an iteration whose VP buckets
overflow doubles max_ev, up to MAX_VPS_CAP (``adapt_max_vps``).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import bsdf as bx
from ...ops import sampling as smp
from ...ops import scene_intersect as si
from ...ops import sppm_kernel as sk
from ...scene import arrays as sa
from ...utils import rng as rngmod
from ...utils import vecmath as vm
from .. import cameras as cam
from .. import lights as lt
from .. import samplers as smpl
from .direct import check_supported, uniform_sample_one_light
from .path import _light_select_dist, _shading_frame_du, _to_local, _to_world

GAMMA = 2.0 / 3.0  # sppm.rs radius update
MAX_VPS_PER_CELL = 32  # the bucket scan's depth at the first iteration
MAX_VPS_CAP = 64  # and at most
RES_CAP = 256  # the grid's cells per axis at most (res^3 ids exact in f32)
DIMS_PER_DEPTH = 7  # the camera pass's sampler dims a depth after the camera's 5
OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]


class SPPMState(NamedTuple):
    radius: torch.Tensor  # (P,)
    ld: torch.Tensor  # (P, 3) direct light summed over the iterations
    n: torch.Tensor  # (P,) the photon count statistic
    tau: torch.Tensor  # (P, 3) the flux


class VisiblePoints(NamedTuple):
    p: torch.Tensor  # (P, 3)
    wo: torch.Tensor  # (P, 3)
    ns: torch.Tensor  # (P, 3)
    beta: torch.Tensor  # (P, 3)
    mat: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool


class Grid(NamedTuple):
    order: torch.Tensor  # (P,) VP ids sorted by cell
    cell_of_entry: torch.Tensor  # (P,) the sorted cell ids
    w_scale: torch.Tensor  # (P,) the reservoir weight depth / min(depth, max_vps)
    grid_min: torch.Tensor  # (3,)
    inv_cell: torch.Tensor  # () cells per unit length
    res: int  # cells per axis
    overflow: int  # sorted VPs past the bounded bucket scan


def camera_pass(scene: sa.Scene, sampler_cfg, ctx, ray_o, ray_d, max_depth: int, light_dist,
                accel=None):
    """Trace to the first vertex with a non-specular lobe, adding direct
    light by NEE at every vertex and emission where a light is hit first or
    after a specular bounce; -> (VisiblePoints, ld (P, 3))."""
    n, dev = ray_o.shape[0], ray_o.device
    ld = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    stored = torch.zeros_like(alive)
    vp_p, vp_wo, vp_ns, vp_beta = (torch.zeros((n, 3), device=dev) for _ in range(4))
    vp_mat = torch.zeros(n, dtype=torch.int32, device=dev)
    specular = alive  # emission counts at the first hit and after specular bounces
    o, d = ray_o.contiguous(), ray_d.contiguous()
    t_max = torch.full((n,), float(vm.INFINITY), device=dev)
    for depth in range(max_depth):
        it = si.scene_intersect(scene, o, d, t_max, accel)
        if scene.n_lights > 0:
            hl = torch.where(it.valid & alive, it.light, -1)
            le = lt.area_light_emitted(scene, torch.clamp(hl, min=0), it.ns, it.wo)
            ld = ld + torch.where(((hl >= 0) & specular)[:, None], beta * le, 0.0)
        alive = alive & it.valid
        b = bx.make_bsdf_at(scene, it)
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        dim0 = 5 + depth * DIMS_PER_DEPTH
        ctx_d = smpl.with_dims(sampler_cfg, ctx, dim0, 6, (1, 3))
        if scene.n_lights > 0:
            ld_i = uniform_sample_one_light(scene, sampler_cfg, ctx_d, it, b, ss, ts, dim0,
                                            light_dist, accel)
            ld = ld + torch.where(alive[:, None], beta * ld_i, 0.0)
        # a non-specular lobe: store the VP and stop; else continue specularly
        store = alive & bx.has_nonspecular(b) & ~stored
        vp_p = torch.where(store[:, None], it.p, vp_p)
        vp_wo = torch.where(store[:, None], it.wo, vp_wo)
        vp_ns = torch.where(store[:, None], it.ns, vp_ns)
        vp_beta = torch.where(store[:, None], beta, vp_beta)
        vp_mat = torch.where(store, it.mat, vp_mat)
        stored = stored | store
        alive = alive & ~store
        wo_l = _to_local(it.wo, ss, ts, it.ns)
        bs = bx.bsdf_sample(b, wo_l, smpl.get_2d(sampler_cfg, ctx_d, dim0 + 3),
                            smpl.get_1d(sampler_cfg, ctx_d, dim0 + 5))
        cont = alive & bs.is_specular & (bs.pdf > 0.0)
        wi_w = _to_world(bs.wi, ss, ts, it.ns)
        beta = torch.where(cont[:, None], beta * bs.f * (
            vm.absdot(wi_w, it.ns) / torch.clamp(bs.pdf, min=1e-12))[:, None], beta)
        o = torch.where(cont[:, None], vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_w), o)
        d = torch.where(cont[:, None], wi_w, d)
        specular = alive = cont
    return VisiblePoints(vp_p, vp_wo, vp_ns, vp_beta, vp_mat, stored), ld


def _shuffled_cell_order(cell, *keys):
    """The permutation that sorts cell, ties in the random order of
    uniform_float(entry, *keys): a stable sort by the key, then a stable
    sort by cell (as the JAX argsorts, which are stable)."""
    e = torch.arange(cell.shape[0], dtype=torch.int64, device=cell.device)
    pre = torch.argsort(rngmod.uniform_float(e, *keys), stable=True)
    return pre[torch.argsort(cell[pre], stable=True)]


def _bucket_depth(sorted_cell):
    """(start, depth) of each sorted entry's bucket."""
    start = torch.searchsorted(sorted_cell, sorted_cell)
    end = torch.searchsorted(sorted_cell, sorted_cell, right=True)
    return start, (end - start).to(torch.float32)


def build_grid(vps: VisiblePoints, radius, max_vps: int = MAX_VPS_PER_CELL,
               shuffle: Optional[int] = None) -> Grid:
    """The VPs sorted by the cell of their point, with cells at least the
    largest radius wide (sppm.rs:336-360, so the 27 neighbour cells hold
    every VP in reach) and at most RES_CAP a side; with shuffle (the
    iteration), in a random order within each cell.  overflow counts the
    valid VPs past max_vps in their cell."""
    valid = vps.valid
    pad = torch.where(valid, radius, 0.0).max()
    lo = torch.where(valid[:, None], vps.p, 1e30).min(0).values - pad
    hi = torch.where(valid[:, None], vps.p, -1e30).max(0).values + pad
    extent = torch.clamp((hi - lo).max(), min=1e-6)
    max_r = torch.clamp(pad, min=1e-6)
    res = int(torch.clamp((extent / max_r).to(torch.int32), 1, RES_CAP))
    inv_cell = float(res) / extent
    cell3 = torch.clamp(((vps.p - lo) * inv_cell).to(torch.int32), 0, res - 1)
    cell = (cell3[:, 0] * res + cell3[:, 1]) * res + cell3[:, 2]
    cell = torch.where(valid, cell, res * res * res)
    if shuffle is not None:
        order = _shuffled_cell_order(cell, 0x5E5, shuffle, 0x9D)
    else:
        order = torch.argsort(cell, stable=True)
    sorted_cell = cell[order]
    start, depth = _bucket_depth(sorted_cell)
    rank = torch.arange(cell.shape[0], device=cell.device) - start
    w_scale = depth / torch.clamp(depth, max=float(max_vps))
    overflow = int(((rank >= max_vps) & (sorted_cell < res * res * res)).sum())
    return Grid(order.to(torch.int32), sorted_cell, w_scale, lo, inv_cell, res, overflow)


def photon_pass(scene: sa.Scene, n_photons: int, max_depth: int, iteration: int, light_dist,
                accel=None, seed: int = 0, idx0: int = 0):
    """Shoot photons idx0 .. idx0+n_photons-1 of an iteration and collect
    their hits at depths 1 .. max_depth-1 as events: (p, wi, beta, ok),
    each (E, 3) or (E,), depth-major, or None where max_depth < 2.  The
    photon's numbers are uniform_float(photon, iteration, salt, seed)."""
    dev = scene.device
    idx = torch.arange(idx0, idx0 + n_photons, dtype=torch.int64, device=dev)

    def u1(salt):
        return rngmod.uniform_float(idx, iteration, salt, seed)

    def u2(salt):
        return torch.stack([u1(salt), u1(salt + 1)], -1)

    li_idx, sel_pdf, _ = smp.sample_distribution_1d_discrete(light_dist, u1(0))
    ls = lt.sample_le(scene, li_idx, u2(1), u2(3))
    pdf = sel_pdf * ls.pdf_pos * ls.pdf_dir
    is_area = torch.round(scene.light_attr[li_idx.long(), sa.LA_TYPE]) == sa.LIGHT_AREA
    # delta lights have no cosine at the origin
    cos0 = vm.absdot(ls.n_light, ls.d)
    beta = torch.where(is_area[:, None], ls.le * (cos0 / pdf)[:, None], ls.le / pdf[:, None])
    o, d = ls.o + ls.d * 1e-3, ls.d
    alive = (beta > 0.0).any(-1)
    t_max = torch.full((n_photons,), float(vm.INFINITY), device=dev)
    events = []
    for depth in range(max_depth):
        it = si.scene_intersect(scene, o, d, t_max, accel)
        alive = alive & it.valid
        if depth > 0:
            events.append((it.p, -d, beta, alive))
        b = bx.make_bsdf_at(scene, it)
        ss, ts = _shading_frame_du(it.ns, it.dpdu)
        bs = bx.bsdf_sample(b, _to_local(it.wo, ss, ts, it.ns), u2(10 + depth * 4),
                            u1(12 + depth * 4))
        wi_w = _to_world(bs.wi, ss, ts, it.ns)
        ok = (bs.pdf > 0.0) & (bs.f > 0.0).any(-1)
        beta_new = beta * bs.f * (vm.absdot(wi_w, it.ns)
                                  / torch.clamp(bs.pdf, min=1e-12))[:, None]
        # Russian roulette on the photon's throughput
        q = torch.clamp(1.0 - beta_new.max(-1).values
                        / torch.clamp(beta.max(-1).values, min=1e-12), 0.0, 1.0)
        kill = u1(100 + depth) < q
        beta = torch.where((~kill)[:, None], beta_new / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           beta)
        alive = alive & ok & ~kill
        o = torch.where(alive[:, None], vm.offset_ray_origin(it.p, it.p_error, it.ng, wi_w), o)
        d = torch.where(alive[:, None], wi_w, d)
    if not events:
        return None
    return tuple(torch.cat(x) for x in zip(*events))


def deposit_inputs(vps: VisiblePoints, radius, grid: Grid, ev_p, ev_wi, ev_beta, ev_ok,
                   max_ev: int, iteration: int, seed: int):
    """The deposit's inputs as the JAX _deposit_events builds them
    (sppm.py:304-355): the events in cells of the VPs' grid, sorted by cell
    in a random order within each (a uniform subset of each bucket is
    scanned, every entry weighed by depth / min(depth, max_ev)), packed as
    rows [p, wi, beta w, w, cell]; each VP's shading frame and wo in it,
    and its 27 neighbour cells' first rows, ids and whether they lie in the
    grid.  -> (rows, start27, okc27, nbf27, frame (ss, ts, ns), wo_l, r2)."""
    res = grid.res
    c3 = ((ev_p - grid.grid_min) * grid.inv_cell).to(torch.int32)
    in_grid = ev_ok & ((c3 >= 0) & (c3 < res)).all(-1)
    cell = torch.where(in_grid, (c3[:, 0] * res + c3[:, 1]) * res + c3[:, 2], res * res * res)
    order = _shuffled_cell_order(cell, iteration, 0xE5E, seed)
    sc = cell[order]
    _, depth = _bucket_depth(sc)
    w_scale = depth / torch.clamp(depth, max=float(max_ev))
    rows = torch.cat([ev_p[order], ev_wi[order], ev_beta[order] * w_scale[:, None],
                      w_scale[:, None], sc.to(torch.float32)[:, None]], 1).contiguous()
    ns = vps.ns
    ss, ts = vm.coordinate_system(ns)
    wo_l = _to_local(vps.wo, ss, ts, ns)
    c3v = torch.clamp(((vps.p - grid.grid_min) * grid.inv_cell).to(torch.int32), 0, res - 1)
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=ns.device)
    nb3 = c3v[None, :, :] + offs[:, None, :]  # (27, P, 3)
    okc27 = ((nb3 >= 0) & (nb3 < res)).all(-1) & vps.valid[None, :]
    nb = (nb3[..., 0] * res + nb3[..., 1]) * res + nb3[..., 2]
    start27 = torch.searchsorted(sc, nb.reshape(-1)).reshape(nb.shape)
    return (rows, start27, okc27.contiguous(), nb.to(torch.float32).contiguous(),
            (ss.contiguous(), ts.contiguous(), ns.contiguous()), wo_l.contiguous(),
            (radius * radius).contiguous())


def deposit_events(scene: sa.Scene, vps: VisiblePoints, radius, grid: Grid, ev_p, ev_wi,
                   ev_beta, ev_ok, max_ev: int, iteration: int, seed: int):
    """Every VP's photon deposit (phi (P, 3), m (P,)) through S1."""
    rows, start27, okc27, nbf27, (ss, ts, ns), wo_l, r2 = deposit_inputs(
        vps, radius, grid, ev_p, ev_wi, ev_beta, ev_ok, max_ev, iteration, seed)
    b = bx.make_bsdf_from_mat(scene, vps.mat)
    return sk.deposit(rows, start27, okc27, nbf27, vps.p.contiguous(), ss, ts, ns, wo_l, r2, b,
                      max_ev)


def update_state(state: SPPMState, vps: VisiblePoints, ld_inc, phi, mcount) -> SPPMState:
    """The radius, count and flux update (sppm.rs:736-764, gamma = 2/3)."""
    has = mcount > 0
    n_new = state.n + GAMMA * mcount
    r_new = torch.where(has, state.radius * torch.sqrt(
        torch.clamp(n_new, min=1e-12) / torch.clamp(state.n + mcount, min=1e-12)), state.radius)
    tau_new = torch.where(has[:, None], (state.tau + vps.beta * phi) * (
        r_new * r_new / torch.clamp(state.radius ** 2, min=1e-20))[:, None], state.tau)
    return SPPMState(r_new, state.ld + ld_inc, torch.where(has, n_new, state.n), tau_new)


def adapt_max_vps(max_vps: int, overflow: int) -> int:
    """max_vps doubled, up to MAX_VPS_CAP, after an iteration whose VP
    buckets overflowed (the reference's unbounded lists never truncate)."""
    if overflow > 0 and max_vps < MAX_VPS_CAP:
        new = min(max_vps * 2, MAX_VPS_CAP)
        warnings.warn(f"SPPM grid bucket overflow ({overflow} entries unreachable); raising "
                      f"the bucket scan {max_vps} -> {new}", stacklevel=3)
        return new
    return max_vps


def resolve(state: SPPMState, n_iterations: int, photons_per_iter: int, resolution,
            crop_rect=None) -> torch.Tensor:
    """L = tau / (N pi r^2) + Ld / iterations (sppm.rs:802-807); pixels
    outside the crop stay black."""
    w, h = resolution
    px0, px1, py0, py1 = crop_rect if crop_rect is not None else (0, w, 0, h)
    np_total = n_iterations * photons_per_iter
    img = (state.tau / torch.clamp(np_total * float(np.pi) * state.radius[:, None] ** 2,
                                   min=1e-12) + state.ld / n_iterations)
    full = torch.zeros((h, w, 3), device=img.device)
    full[py0:py1, px0:px1] = img.reshape(py1 - py0, px1 - px0, 3)
    return full


def render_sppm(scene: sa.Scene, camera: cam.Camera, sampler_cfg, n_iterations: int = 16,
                photons_per_iter: int = 0, max_depth: int = 5, initial_radius: float = 0.0,
                accel=None, seed: int = 0, stats: Optional[dict] = None,
                crop_rect=None) -> torch.Tensor:
    """The progressive render (SPPMIntegrator::render, sppm.rs:66): (H, W, 3)
    linear RGB on the scene's device.  photons_per_iter 0: one a pixel;
    initial_radius 0: 2 world radii / max(w, h).  crop_rect (px0, px1, py0,
    py1): VPs for those pixels only.  stats, when given, gains
    grid_bucket_overflow (VPs past the bucket scan, summed over the
    iterations), grid_res_last and max_ev_last (the scan's depth at the
    last iteration)."""
    check_supported(scene, accel)
    dev = scene.device
    w, h = camera.resolution
    px0, px1, py0, py1 = crop_rect if crop_rect is not None else (0, w, 0, h)
    n_vp = (px1 - px0) * (py1 - py0)
    if photons_per_iter <= 0:
        photons_per_iter = n_vp
    if initial_radius <= 0.0:
        initial_radius = float(scene.world_radius) * 2.0 / max(w, h)
    light_dist = _light_select_dist(scene)
    xs = torch.arange(px0, px1, dtype=torch.int64, device=dev)
    ys = torch.arange(py0, py1, dtype=torch.int64, device=dev)
    pixels = torch.stack([xs.repeat(py1 - py0), ys.repeat_interleave(px1 - px0)], -1)
    state = SPPMState(torch.full((n_vp,), float(initial_radius), device=dev),
                      torch.zeros((n_vp, 3), device=dev), torch.zeros(n_vp, device=dev),
                      torch.zeros((n_vp, 3), device=dev))
    total_overflow = last_res = last_max = 0
    max_vps = MAX_VPS_PER_CELL
    for i in range(n_iterations):
        ctx = smpl.make_ctx(sampler_cfg, pixels, torch.full((n_vp,), i, device=dev))
        u_film, u_time, u_lens = smpl.get_camera_dims(sampler_cfg, ctx, pixels)
        rays = cam.generate_rays(camera, pixels.to(torch.float32) + u_film, u_lens, u_time)
        vps, ld_inc = camera_pass(scene, sampler_cfg, ctx, rays.o, rays.d, max_depth, light_dist,
                                  accel)
        grid = build_grid(vps, state.radius, max_vps, shuffle=i)
        events = photon_pass(scene, photons_per_iter, max_depth, i, light_dist, accel, seed)
        if events is None:
            phi, mcount = torch.zeros((n_vp, 3), device=dev), torch.zeros(n_vp, device=dev)
        else:
            phi, mcount = deposit_events(scene, vps, state.radius, grid, *events, max_vps, i,
                                         seed)
        state = update_state(state, vps, ld_inc, phi, mcount)
        total_overflow += grid.overflow
        last_res, last_max = grid.res, max_vps
        max_vps = adapt_max_vps(max_vps, grid.overflow)
    if stats is not None:
        stats.update(grid_bucket_overflow=total_overflow, grid_res_last=last_res,
                     max_ev_last=last_max)
    return resolve(state, n_iterations, photons_per_iter, (w, h), crop_rect)
