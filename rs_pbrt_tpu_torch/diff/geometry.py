"""Geometry (visibility) gradients by edge sampling.

The port of the JAX package's ``diff/geometry.py`` (Li et al. 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling").  The
interior term of a pixel gradient in the geometry (shading and measure
changes at fixed visibility) is autograd's, through the differentiable
closest hit (G1) once the vertices carry a gradient; the boundary term
(radiance jumps across silhouettes, which move with the geometry) is an
edge integral, sampled in raster space:

    d/dtheta (1/WH) iint L dx dy
      = (1/WH) [ iint dL/dtheta dx dy + sum_edges int (L- - L+) (v . n) dl ]

For each unique edge of the moving triangles, points along it are
projected to the raster, a pair of rays is traced +-delta pixels along
the projected edge's normal, and their radiance difference is weighted by
the raster velocity of the edge point.  A sample counts only where one of
its two rays lands on one of the edge's own triangles (the ownership
filter that stands in for a silhouette test).  ``shadow_boundary_grad``
does the same for cast shadows on the light's plane.  The edge samples'
renders are forward only: they run K1, K5 and K4 on the card as any render
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import cameras as cam
from ..models import samplers as smpl
from ..models.integrators import path as pathmod
from ..ops import bsdf as bx
from ..ops import scene_intersect as si
from ..scene import arrays as sa
from ..utils import vecmath as vm


def world_to_raster(camera: cam.Camera, p_world):
    """(N, 3) world points -> (N, 2) raster coordinates (perspective or
    orthographic), through the camera's inverses (computed once, in f64,
    when the camera is made; the JAX function inverts in f32)."""
    ph = torch.cat([p_world, torch.ones_like(p_world[..., :1])], -1)
    pc = ph @ camera.world_to_cam.T
    pr = pc @ camera.camera_to_raster.T
    return pr[..., :2] / torch.clamp(pr[..., 3:4], min=1e-12)


def unique_edges(idx_pairs, face_ids=None):
    """(E, 2) vertex-position pairs (a, b) -> the deduplicated host edge
    list, deduplicated by rounded coordinates so that a shared triangle
    edge counts once in the boundary integral.  With face_ids (one a
    pair), also the (E, 2) table of each edge's adjacent faces (-1 at a
    boundary edge)."""
    a, b = idx_pairs
    key = np.round(np.concatenate([np.minimum(a, b), np.maximum(a, b)], -1), 6)
    uniq, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    order = np.sort(first)
    if face_ids is None:
        return a[order], b[order]
    adj = np.full((len(uniq), 2), -1, np.int64)
    for i, f in zip(inv, np.asarray(face_ids)):
        if adj[i, 0] < 0:
            adj[i, 0] = f
        elif adj[i, 1] < 0 and adj[i, 0] != f:
            adj[i, 1] = f
    pos_of_uniq = np.searchsorted(order, first)
    adj_sorted = np.empty_like(adj)
    adj_sorted[pos_of_uniq] = adj
    return a[order], b[order], adj_sorted


def translate_tris(scene: sa.Scene, mask, offset) -> sa.Scene:
    """The scene with the triangles of mask (T,) bool moved by offset (3,),
    out of place, so a gradient in offset reaches every reader of the
    vertex columns of tri_attr (the JAX translate_tris, which moves its
    SoA vertex arrays too; the port's scene has only the table)."""
    ta = scene.tri_attr
    m = torch.as_tensor(mask, device=ta.device)[:, None].to(torch.float32)
    d = torch.as_tensor(offset, dtype=torch.float32, device=ta.device).reshape(1, 3)
    n = m.shape[0]
    cols = [ta[:n, :sa.TA_P0]]
    for c in (sa.TA_P0, sa.TA_P1, sa.TA_P2):
        cols.append(ta[:n, c:c + 3] + m * d)
    cols.append(ta[:n, sa.TA_P2 + 3:])
    moved = torch.cat(cols, 1)
    return dataclasses.replace(scene, tri_attr=torch.cat([moved, ta[n:]], 0))


def _primary_radiance(scene, camera, cfg, sampler_cfg, p_raster, accel, seed, pix_base=None):
    """Path radiance (N, 3) through raster points p_raster (N, 2), one
    sample each, all at sample number `seed`.  pix_base: the sampler pixel
    both rays of a +-delta pair share, so that they draw the same dims."""
    n = p_raster.shape[0]
    pix = torch.clamp(p_raster.to(torch.int32), min=0) if pix_base is None else pix_base
    snum = torch.full((n,), int(np.uint32(seed)), dtype=torch.int64, device=p_raster.device)
    ctx = smpl.make_ctx(sampler_cfg, pix, snum)
    rays = cam.generate_rays(camera, p_raster, torch.full((n, 2), 0.5, device=p_raster.device),
                             torch.zeros(n, device=p_raster.device))
    pcfg = pathmod.PathCfg(cfg.max_depth, cfg.rr_threshold)
    return pathmod.general_radiance(scene, pcfg, sampler_cfg, ctx, rays.o, rays.d, accel)


def _first_prim(scene, camera, xq, accel):
    """The primitive each camera ray through raster points xq first hits,
    -2 where none."""
    n = xq.shape[0]
    rq = cam.generate_rays(camera, xq, torch.full((n, 2), 0.5, device=xq.device),
                           torch.zeros(n, device=xq.device))
    it = si.scene_intersect(scene, rq.o, rq.d, torch.full((n,), 1e30, device=xq.device), accel)
    return torch.where(it.valid, it.prim, -2)


def _moving_edges(scene, moving_mask):
    mm = np.asarray(torch.as_tensor(moving_mask).cpu())
    tri_ids = np.where(mm)[0]
    tris = scene.tri_attr[:scene.n_tris, sa.TA_P0:sa.TA_P0 + 9].detach().cpu().numpy()[mm]
    p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    ea = np.concatenate([p0, p1, p2], 0)
    eb = np.concatenate([p1, p2, p0], 0)
    fids = np.concatenate([tri_ids] * 3)
    return unique_edges((ea, eb), face_ids=fids)


@torch.no_grad()
def edge_boundary_grad(scene: sa.Scene, camera: cam.Camera, cfg, sampler_cfg, moving_mask,
                       direction, loss_weight_image, accel=None, samples_per_edge: int = 64,
                       delta_px: float = 0.02, seed: int = 0):
    """The primary-silhouette boundary term of d loss / d theta for the
    masked triangles translated along direction, loss = sum over pixels of
    weight[px] * img[px] (loss_weight_image (H, W) or (H, W, 3)).  A
    scalar tensor: the sum over stratified edge samples of (L- - L+)
    (v . n) |dl| w(px)."""
    dev = scene.device
    ea, eb, adj = _moving_edges(scene, moving_mask)
    S = samples_per_edge
    rng = np.random.RandomState(seed)
    t = ((np.arange(S) + rng.rand(S)) / S).astype(np.float32)  # stratified
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pa, pb, tt = f32(ea)[:, None, :], f32(eb)[:, None, :], f32(t)[None, :, None]
    p_edge = (pa * (1 - tt) + pb * tt).reshape(-1, 3)  # (E*S, 3)
    dirv = f32(direction)
    x, v = torch.func.jvp(lambda p: world_to_raster(camera, p), (p_edge,),
                          (dirv.expand_as(p_edge).contiguous(),))
    xa, xb = world_to_raster(camera, f32(ea)), world_to_raster(camera, f32(eb))
    tang = xb - xa  # (E, 2) the raster edge
    tlen = torch.linalg.norm(tang, dim=-1)
    dl = tlen / S
    tang_n = tang / torch.clamp(tlen, min=1e-12)[:, None]
    nrm = torch.stack([-tang_n[:, 1], tang_n[:, 0]], -1)
    nrm_s = nrm.repeat_interleave(S, 0)
    dl_s = dl.repeat_interleave(S, 0)
    x_plus = x + delta_px * nrm_s
    x_minus = x - delta_px * nrm_s
    pix_base = torch.clamp(x.to(torch.int32), min=0)
    L_p = _primary_radiance(scene, camera, cfg, sampler_cfg, x_plus, accel, seed, pix_base)
    L_m = _primary_radiance(scene, camera, cfg, sampler_cfg, x_minus, accel, seed, pix_base)
    # the ownership filter: the jump belongs to this edge only where one of
    # the offset rays lands on one of its own triangles
    h_p = _first_prim(scene, camera, x_plus, accel)
    h_m = _first_prim(scene, camera, x_minus, accel)
    adj_s = torch.as_tensor(adj, dtype=torch.int32, device=dev).repeat_interleave(S, 0)
    in_adj = lambda h: (h == adj_s[:, 0]) | (h == adj_s[:, 1])
    own = in_adj(h_p) | in_adj(h_m)
    w_img = torch.as_tensor(loss_weight_image, dtype=torch.float32, device=dev)
    H, W = w_img.shape[:2]
    px = torch.clamp(x[:, 0].to(torch.int32), 0, W - 1).long()
    py = torch.clamp(x[:, 1].to(torch.int32), 0, H - 1).long()
    inside = (x[:, 0] >= 0) & (x[:, 0] < W) & (x[:, 1] >= 0) & (x[:, 1] < H)
    if w_img.dim() == 3:
        wc = torch.where(inside[:, None], w_img[py, px], 0.0)
        contrib = ((L_m - L_p) * wc).sum(-1)
    else:
        contrib = (L_m - L_p).sum(-1) * torch.where(inside, w_img[py, px], 0.0)
    vn = (v * nrm_s).sum(-1)
    return torch.where(own, contrib * vn * dl_s, 0.0).sum()


@torch.no_grad()
def shadow_boundary_grad(scene: sa.Scene, camera: cam.Camera, cfg, sampler_cfg, moving_mask,
                         direction, loss_weight_image, accel=None, samples_per_edge: int = 16,
                         light_idx: int = 0, delta_world: float = 5e-3, max_pixels: int = 4096):
    """The cast-shadow boundary term of d loss / d theta for the masked
    triangles translated along direction: direct lighting at the primary
    hits of the weighted pixels from the planar triangle-range area light
    light_idx, whose integrand jumps where a moving edge's projection from
    the shading point crosses the light's plane (Li et al. 2018's
    secondary edge sampling, the JAX shadow_boundary_grad).  A scalar
    tensor."""
    dev = scene.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    w_img = np.asarray(torch.as_tensor(loss_weight_image).cpu(), np.float32)
    w_scalar = w_img.sum(-1) if w_img.ndim == 3 else w_img
    py, px = np.nonzero(w_scalar)
    if len(px) == 0:
        return torch.zeros((), device=dev)
    if len(px) > max_pixels:
        sel = np.linspace(0, len(px) - 1, max_pixels).astype(np.int64)
        px, py = px[sel], py[sel]
    scale_pix = len(np.nonzero(w_scalar)[0]) / len(px)
    p_raster = f32(np.stack([px + 0.5, py + 0.5], -1))
    Np = len(px)
    rays = cam.generate_rays(camera, p_raster, torch.full((Np, 2), 0.5, device=dev),
                             torch.zeros(Np, device=dev))
    it = si.scene_intersect(scene, rays.o, rays.d, torch.full((Np,), 1e30, device=dev), accel)
    wpx = f32(w_img[py, px] if w_img.ndim == 3 else np.repeat(w_scalar[py, px, None], 3, -1))
    b = bx.make_bsdf_at(scene, it)
    ss, ts = pathmod._shading_frame_du(it.ns, it.dpdu)

    # the light's plane and emission (a planar triangle-range light)
    la = scene.light_attr[light_idx].detach().cpu().numpy()
    tris = scene.tri_attr[:, sa.TA_P0:sa.TA_P0 + 9].detach().cpu().numpy()
    t0 = int(la[sa.LA_TRI_START])
    lp0, lp1, lp2 = tris[t0, 0:3], tris[t0, 3:6], tris[t0, 6:9]
    n_l = np.cross(lp1 - lp0, lp2 - lp0)
    n_l = f32(n_l / max(np.linalg.norm(n_l), 1e-12))
    c_l = f32(lp0)
    le = f32(la[sa.LP_I:sa.LP_I + 3])
    two_sided = la[sa.LP_TWO_SIDED] > 0.5

    # edge samples, projected from each shading point onto the light plane
    ea, eb, adj = _moving_edges(scene, moving_mask)
    E, S = len(ea), samples_per_edge
    t = f32((np.arange(S) + 0.5) / S)
    m = f32(ea)[:, None] * (1 - t)[None, :, None] + f32(eb)[:, None] * t[None, :, None]
    lanes = Np * E * S
    rep = lambda a: a.repeat_interleave(E * S, 0)  # pixel-major tiling
    p = rep(it.p)
    m_l = m.reshape(E * S, 3).repeat(Np, 1)
    edge_dir = f32(eb - ea).repeat_interleave(S, 0).repeat(Np, 1)
    dirv = f32(direction)

    def proj(mq):
        denom = ((mq - p) * n_l).sum(-1)
        s = ((c_l - p) * n_l).sum(-1) / torch.where(denom == 0, 1e-20, denom)
        return p + s[..., None] * (mq - p), s

    (y, s_proj), (v_y, _) = torch.func.jvp(proj, (m_l,), (dirv.expand_as(m_l).contiguous(),))
    _, tau = torch.func.jvp(lambda mq: proj(mq)[0], (m_l,), (edge_dir,))
    proj_ok = (s_proj > 1.0 + 1e-4) & torch.isfinite(s_proj)  # the blocker between
    n_c = vm.normalize(vm.cross(n_l[None, :].expand_as(tau), tau))
    dl = torch.linalg.norm(tau, dim=-1) / S

    valid_px = rep(it.valid)
    b_l = type(b)(*(rep(a) if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == Np else a
                    for a in b))
    ss_l, ts_l = rep(ss), rep(ts)
    ns_l, ng_l, wo_l3 = rep(it.ns), rep(it.ng), rep(it.wo)
    perr_l = rep(it.p_error)
    wpx_l = rep(wpx)

    def integrand_and_blocker(y_off):
        to_y = y_off - p
        dist = torch.linalg.norm(to_y, dim=-1)
        wi = to_y / torch.clamp(dist, min=1e-12)[..., None]
        o_sh = vm.offset_ray_origin(p, perr_l, ng_l, wi)
        hit = si.scene_intersect(scene, o_sh, wi, torch.full((lanes,), 1e30, device=dev), accel)
        on_light = hit.valid & (hit.light == light_idx)
        blocker = torch.where(hit.valid & ~on_light, hit.prim, -2)
        wo_loc = pathmod._to_local(wo_l3, ss_l, ts_l, ns_l)
        wi_loc = pathmod._to_local(wi, ss_l, ts_l, ns_l)
        reflect = vm.dot(wi, ng_l) * vm.dot(wo_l3, ng_l) > 0.0
        f = bx.bsdf_f(b_l, wo_loc, wi_loc, reflect)
        cos_p = vm.dot(ns_l, wi).abs()
        cos_l = vm.dot(n_l[None, :].expand_as(wi), -wi)
        emits = torch.ones_like(cos_l, dtype=torch.bool) if two_sided else cos_l > 0.0
        g = cos_l.abs() * cos_p / torch.clamp(dist * dist, min=1e-12)
        i_val = torch.where((on_light & emits)[..., None], f * le[None, :] * g[..., None], 0.0)
        return i_val, blocker

    i_m, blk_m = integrand_and_blocker(y - delta_world * n_c)
    i_p, blk_p = integrand_and_blocker(y + delta_world * n_c)
    adj_l = torch.as_tensor(adj, dtype=torch.int32, device=dev).repeat_interleave(S, 0).repeat(
        Np, 1)
    in_adj = lambda h: (h == adj_l[:, 0]) | (h == adj_l[:, 1])
    own = in_adj(blk_m) | in_adj(blk_p)
    contrib = ((i_m - i_p) * wpx_l).sum(-1)
    vn = (v_y * n_c).sum(-1)
    keep = own & proj_ok & valid_px
    return torch.where(keep, contrib * vn * dl, 0.0).sum() * scale_pix


def grad_loss_wrt_translation(scene: sa.Scene, camera: cam.Camera, cfg, sampler_cfg,
                              moving_mask, direction, loss_weight_image, accel=None,
                              samples_per_edge: int = 64, seed: int = 0):
    """d/dtheta of loss = sum over pixels of w[px] * img[px] for the masked
    triangles translated by theta * direction: the interior term by
    autograd (through G1 and the differentiable record) plus the
    silhouettes' boundary term by edge sampling.  (interior, boundary,
    total) scalar tensors."""
    from ..models.integrators import render as rdr

    dev = scene.device
    w_img = torch.as_tensor(loss_weight_image, dtype=torch.float32, device=dev)
    w3 = w_img if w_img.dim() == 3 else w_img[..., None]
    dirv = torch.as_tensor(direction, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(moving_mask, device=dev)
    theta = torch.zeros((), device=dev, requires_grad=True)
    with torch.enable_grad():
        s2 = translate_tris(scene, mask, theta * dirv)
        img = rdr.render(s2, camera, cfg, sampler_cfg, accel=accel, regen=False)
        (interior,) = torch.autograd.grad((img * w3).sum(), [theta])
    boundary = edge_boundary_grad(scene, camera, cfg, sampler_cfg, moving_mask, direction, w_img,
                                  accel=accel, samples_per_edge=samples_per_edge, seed=seed)
    return interior, boundary, interior + boundary
