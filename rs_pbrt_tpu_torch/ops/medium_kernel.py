"""M1 and M2: delta and ratio tracking through grid media, the kernels'
wrappers and their plain versions.

The ports of the JAX package's ``_delta_track`` and ``_ratio_track_tr``
(models/integrators/volpath.py:57 and :86, with ``_density_at`` :48 and
ops/medium.py:73 ``grid_density``): per ray, TRACK_STEPS steps of a
bounded tracking loop through the ray's medium's density grid, each a draw
of the hash RNG (``utils/rng.py``), a log and a trilinear lookup.

- M1, ``delta_track``: the distance to a real collision on [0, t_max]
  (grid.rs:209-271): (sampled (N,) bool, t (N,) = min(t, t_max), weight
  (N, 3), the albedo where sampled, else 1).  Its draws are keyed (lane
  key, bounce, 2i, seed) and (lane key, bounce, 2i + 1, seed).
- M2, ``ratio_track``: the transmittance of the segment [0, dist]
  (grid.rs:155-208): tr (N,).  Its draws are keyed (lane key, salt,
  7000 + i, seed).

Inputs per ray: mid (N,) int32, the medium; in_med (N,) bool, the lanes
that track (the others keep t 0, weight 1, tr 1); o, d (N, 3) f32; t_max
or dist (N,) f32; lane_key (N,) int32, the key's 32 bits.  Tables: the
scene's med_grid (K, D, H, W), med_w2m (K, 4, 4), med_sigma_a and
med_sigma_s (K, 3) and med_max_density (K,), all f32.  ``delta_track`` and
``ratio_track`` launch the CUDA kernels (``csrc/medium.cu``) for CUDA
tensors and run the plain versions for CPU tensors.  The plain versions
compute the JAX functions' steps op by op, each lane reading its own
grid; the kernels compute the same ops in the same order.

Where autograd records through the rays (a camera gradient of a grid
medium), M1 is ``DeltaTrackFn`` and M2 ``RatioTrackFn``, each the same
launch on detached rays.  M1's distances do not depend on o or d (each
step's length is a draw over the medium's majorant) and its collision
tests are discrete, so its backward is one select and has no kernel: t's
gradient goes to t_max on the lanes where the final min(t, t_max) takes
t_max (t_max <= 0: a lane's t never passes a positive t_max; half at the
tie, as torch.minimum and jnp.minimum split it), and o and d get nothing,
as in JAX.  M2's backward is M3, ``ratio_track_vjp`` (``csrc/medium_grad.cu``;
its twin ``ratio_track_vjp_plain`` on CPU tensors): Tr's gradient in o and
d through each live step's density at o + t_i d.  The tables (grid, sigma)
carry no gradient.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import rng
from ..utils import transform as tr
from . import _build
from .autodiff import refuse_grad, tracks
from .medium import _tap, grid_density

TRACK_STEPS = 16  # the JAX volpath's bounded steps (volpath.py:41)
# kernel launches; the plain versions count none
launches = {"delta_track": 0, "ratio_track": 0, "ratio_track_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("medium")
    delta, ratio = lib.rs_delta_track, lib.rs_ratio_track
    # grid, K, D, H, W, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, t_max,
    # lane_key, n, bounce, seed, sampled, t, weight, stream
    delta.argtypes = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P]
    # grid, K, D, H, W, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist,
    # lane_key, n, salt, seed, tr, stream
    ratio.argtypes = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      ctypes.c_uint, ctypes.c_uint, _P, _P]
    delta.restype = ratio.restype = ctypes.c_int
    return delta, ratio


@lru_cache(maxsize=None)
def _grad_kernel():
    fn = _build.load("medium_grad").rs_ratio_track_grad
    # M2's arguments without tr, then g_tr, g_o, g_d, stream
    fn.argtypes = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                   ctypes.c_uint, ctypes.c_uint, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _medium_terms(sigma_a, sigma_s, max_density, mid):
    """Per lane: sigma_t (N, 3), 1 / max(mean(sigma_t) max_density, 1e-12)
    and max(max_density, 1e-12)."""
    sigma_t3 = sigma_a[mid] + sigma_s[mid]
    sigma_t = (sigma_t3[:, 0] + sigma_t3[:, 1] + sigma_t3[:, 2]) / 3.0
    max_d = max_density[mid]
    inv_max = 1.0 / torch.clamp(sigma_t * max_d, min=1e-12)
    return sigma_t3, inv_max, torch.clamp(max_d, min=1e-12)


def _count(work, key, mask):
    if work is not None:
        work[key] = work.get(key, 0) + int(mask.sum())


def _voxels(work, grid, w2m, mid, p, mask):
    """Adds to work["voxel_set"] the voxels the lanes of mask read at p (the
    8 taps of each lookup inside its grid)."""
    if work is None or not bool(mask.any()):
        return
    D, H, W = grid.shape[-3:]
    m = mid[mask]
    pm = tr.xform_point(w2m[m], p[mask])
    inside = ((pm >= 0) & (pm < 1)).all(-1)
    g = [torch.floor(pm[:, k] * n - 0.5) for k, n in enumerate((W, H, D))]
    ids = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = [torch.clamp(torch.nan_to_num(g[k] + o), 0, n - 1).long()
                     for k, (o, n) in enumerate(((dx, W), (dy, H), (dz, D)))]
                ids.append((((m * D + c[2]) * H + c[1]) * W + c[0])[inside])
    work.setdefault("voxel_set", []).append(torch.unique(torch.cat(ids)))


def delta_track_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, t_max,
                      lane_key, bounce: int, seed: int, work: dict = None):
    """M1's plain version (the JAX _delta_track): (sampled, t, weight).
    work, when given, gains the steps the lanes take (``steps``: a draw
    pair and a log each), the lookups (``lookups``: the steps not past
    t_max, a transform and 8 taps each) and ``voxel_set``, the voxels read."""
    mid = mid.long()
    sigma_t3, inv_max, max_d = _medium_terms(sigma_a, sigma_s, max_density, mid)
    prefix = rng.hash_combine(lane_key, bounce)
    t = torch.zeros_like(t_max)
    sampled = torch.zeros_like(in_med)
    done = ~in_med
    for i in range(TRACK_STEPS):
        u1 = rng.to_float(rng.hash_u32(rng.hash_combine(rng.hash_combine(prefix, 2 * i), seed)))
        u2 = rng.to_float(rng.hash_u32(rng.hash_combine(rng.hash_combine(prefix, 2 * i + 1),
                                                        seed)))
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_max
        past = t_new >= t_max
        p = o + t_new[:, None] * d
        dens = grid_density(grid, w2m, p, mid)
        real = u2 < dens / max_d
        hit_now = ~done & ~past & real
        _count(work, "steps", ~done)
        _count(work, "lookups", ~done & ~past)
        _voxels(work, grid, w2m, mid, p, ~done & ~past)
        sampled = sampled | hit_now
        t = torch.where(done | past, t, t_new)
        done = done | past | hit_now
    albedo = sigma_s[mid] / torch.clamp(sigma_t3, min=1e-12)
    weight = torch.where(sampled[:, None], albedo, 1.0)
    return sampled, torch.minimum(t, t_max), weight


def ratio_track_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist,
                      lane_key, salt: int, seed: int, work: dict = None):
    """M2's plain version (the JAX _ratio_track_tr): tr (N,).  work as in
    delta_track_plain."""
    mid = mid.long()
    _, inv_max, max_d = _medium_terms(sigma_a, sigma_s, max_density, mid)
    prefix = rng.hash_combine(lane_key, salt)
    t = torch.zeros_like(dist)
    tr_acc = torch.ones_like(dist)
    done = ~in_med
    for i in range(TRACK_STEPS):
        u1 = rng.to_float(rng.hash_u32(rng.hash_combine(rng.hash_combine(prefix, 7000 + i),
                                                        seed)))
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_max
        past = t_new >= dist
        p = o + t_new[:, None] * d
        dens = grid_density(grid, w2m, p, mid)
        _count(work, "steps", ~done)
        _count(work, "lookups", ~done & ~past)
        _voxels(work, grid, w2m, mid, p, ~done & ~past)
        tr_acc = torch.where(done | past, tr_acc,
                             tr_acc * torch.clamp(1.0 - dens / max_d, 0.0, 1.0))
        t = t_new
        done = done | past
    return torch.clamp(tr_acc, 0.0, 1.0)


def _check(what, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} lies on {t.device}, expected CUDA")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, not {t.dtype} {tuple(t.shape)}")


def _check_inputs(what, grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, seg,
                  lane_key):
    n, K = o.shape[0], grid.shape[0]
    if grid.dim() != 4 or n >= (1 << 31):
        raise ValueError(f"{what}: grid of shape {tuple(grid.shape)}, {n} rays")
    for name, t, dtype, shape in (
            ("grid", grid, torch.float32, grid.shape), ("w2m", w2m, torch.float32, (K, 4, 4)),
            ("sigma_a", sigma_a, torch.float32, (K, 3)),
            ("sigma_s", sigma_s, torch.float32, (K, 3)),
            ("max_density", max_density, torch.float32, (K,)),
            ("mid", mid, torch.int32, (n,)), ("in_med", in_med, torch.bool, (n,)),
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_max", seg, torch.float32, (n,)), ("lane_key", lane_key, torch.int32, (n,))):
        _check(what, name, t, dtype, shape)


def delta_track(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, t_max, lane_key,
                bounce: int, seed: int):
    """M1: (sampled, t, weight), see the module's docstring; the plain
    version on the CPU.  Through DeltaTrackFn where autograd records
    through o, d or t_max."""
    refuse_grad("delta_track (M1) in the medium's tables", grid, sigma_a, sigma_s)
    if tracks(o, d, t_max):
        go = lambda o_, d_, t_: _delta_track(grid, w2m, sigma_a, sigma_s, max_density, mid,
                                             in_med, o_, d_, t_, lane_key, bounce, seed)
        return DeltaTrackFn.apply(o, d, t_max, go)
    return _delta_track(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, t_max,
                        lane_key, bounce, seed)


def _delta_track(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, t_max, lane_key,
                 bounce: int, seed: int):
    """M1's launch (the plain version on the CPU)."""
    if o.device.type == "cpu":
        return delta_track_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d,
                                 t_max, lane_key, bounce, seed)
    _check_inputs("delta_track", grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d,
                  t_max, lane_key)
    n = o.shape[0]
    sampled = torch.empty(n, dtype=torch.bool, device=o.device)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    weight = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = _kernels()[0](
            grid.data_ptr(), *grid.shape, w2m.data_ptr(), sigma_a.data_ptr(), sigma_s.data_ptr(),
            max_density.data_ptr(), mid.data_ptr(), in_med.data_ptr(), o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), lane_key.data_ptr(), n, bounce & rng.M32,
            seed & rng.M32, sampled.data_ptr(), t.data_ptr(), weight.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "delta_track kernel launch")
    launches["delta_track"] += 1
    return sampled, t, weight


def ratio_track(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist, lane_key,
                salt: int, seed: int):
    """M2: tr (N,), see the module's docstring; the plain version on the
    CPU.  Through RatioTrackFn where autograd records through o or d."""
    refuse_grad("ratio_track (M2) in the medium's tables", grid, sigma_a, sigma_s)
    args = (grid, w2m, sigma_a, sigma_s, max_density, mid, in_med)
    if tracks(o, d):
        return RatioTrackFn.apply(o, d, dist, args, lane_key, salt, seed)
    return _ratio_track(*args, o, d, dist, lane_key, salt, seed)


def _ratio_track(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist, lane_key,
                 salt: int, seed: int):
    """M2's launch (the plain version on the CPU)."""
    if o.device.type == "cpu":
        return ratio_track_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d,
                                 dist, lane_key, salt, seed)
    _check_inputs("ratio_track", grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d,
                  dist, lane_key)
    n = o.shape[0]
    tr_ = torch.empty(n, dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = _kernels()[1](
            grid.data_ptr(), *grid.shape, w2m.data_ptr(), sigma_a.data_ptr(), sigma_s.data_ptr(),
            max_density.data_ptr(), mid.data_ptr(), in_med.data_ptr(), o.data_ptr(),
            d.data_ptr(), dist.data_ptr(), lane_key.data_ptr(), n, salt & rng.M32,
            seed & rng.M32, tr_.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "ratio_track kernel launch")
    launches["ratio_track"] += 1
    return tr_


def _density_vjp(grid, w2m, mid, p, g_dens):
    """The gradient in p (N, 3) of grid_density(grid, w2m, p, mid) from
    g_dens (N,) (csrc/medium_grad.cu density_vjp, term by term): each
    axis's weight difference over the 8 taps, summed dz, dy, dx, times the
    grid's size along it, back through w2m's rows and its homogeneous
    divide; 0 outside the unit cube."""
    D, H, W = grid.shape[-3:]
    flat = grid.reshape(-1)
    m = w2m[mid]
    base = mid * (D * H * W)
    row = lambda i: m[:, i, 0] * p[:, 0] + m[:, i, 1] * p[:, 1] + m[:, i, 2] * p[:, 2]
    w = row(3) + m[:, 3, 3]
    q = [(row(i) + m[:, i, 3]) / w for i in range(3)]
    inside = ((q[0] >= 0) & (q[0] < 1) & (q[1] >= 0) & (q[1] < 1) & (q[2] >= 0) & (q[2] < 1))
    g = [q[0] * W - 0.5, q[1] * H - 0.5, q[2] * D - 0.5]
    lo = [torch.floor(x) for x in g]
    f = [x - y for x, y in zip(g, lo)]
    g_f = [torch.zeros_like(w) for _ in range(3)]
    for dz in (0, 1):
        wz = f[2] if dz else 1.0 - f[2]
        for dy in (0, 1):
            wy = f[1] if dy else 1.0 - f[1]
            for dx in (0, 1):
                wx = f[0] if dx else 1.0 - f[0]
                idx = (base + (_tap(lo[2] + dz, D) * H + _tap(lo[1] + dy, H)) * W
                       + _tap(lo[0] + dx, W))
                v = flat[idx]
                g_f[0] = g_f[0] + (1.0 if dx else -1.0) * wy * wz * v
                g_f[1] = g_f[1] + (1.0 if dy else -1.0) * wx * wz * v
                g_f[2] = g_f[2] + (1.0 if dz else -1.0) * wx * wy * v
    g_q = [g_dens * g_f[0] * float(W), g_dens * g_f[1] * float(H), g_dens * g_f[2] * float(D)]
    g_w = torch.zeros_like(w)
    for i in range(3):
        g_w = g_w - g_q[i] * q[i] / w
    g_p = torch.stack([(g_q[0] * m[:, 0, k] + g_q[1] * m[:, 1, k] + g_q[2] * m[:, 2, k]) / w
                       + g_w * m[:, 3, k] for k in range(3)], -1)
    return torch.where(inside[:, None], g_p, 0.0)


def ratio_track_vjp_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist,
                          lane_key, salt: int, seed: int, g_tr):
    """M3's twin: csrc/medium_grad.cu's replay of M2's steps and its
    reverse sweep, term by term -> (g_o, g_d) (N, 3), the gradient of
    ratio_track_plain's tr with g_tr (N,) in o and d; dist gets none (its
    end test is discrete), and lanes outside a medium zeros."""
    mid = mid.long()
    _, inv_max, max_d = _medium_terms(sigma_a, sigma_s, max_density, mid)
    prefix = rng.hash_combine(lane_key, salt)
    t = torch.zeros_like(dist)
    tr_acc = torch.ones_like(dist)
    done = ~in_med | (g_tr == 0.0)
    steps = []  # per step: (live, t, factor, Tr before it, the clamp passes)
    for i in range(TRACK_STEPS):
        u1 = rng.to_float(rng.hash_u32(rng.hash_combine(rng.hash_combine(prefix, 7000 + i),
                                                        seed)))
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_max
        past = t_new >= dist
        live = ~done & ~past
        dens = grid_density(grid, w2m, o + t_new[:, None] * d, mid)
        x = 1.0 - dens / max_d
        f = torch.clamp(x, 0.0, 1.0)
        steps.append((live, t_new, f, tr_acc, (x >= 0.0) & (x <= 1.0)))
        tr_acc = torch.where(live, tr_acc * f, tr_acc)
        t = t_new
        done = done | past
    g_acc = torch.where((tr_acc >= 0.0) & (tr_acc <= 1.0), g_tr, 0.0)
    g_o, g_d = torch.zeros_like(o), torch.zeros_like(d)
    for live, t_s, f, before, passes in reversed(steps):
        g_f = g_acc * before
        g_acc = torch.where(live, g_acc * f, g_acc)
        on = torch.nonzero(live & passes & (g_f != 0.0)).flatten()
        if not on.numel():
            continue
        g_p = _density_vjp(grid, w2m, mid[on], o[on] + t_s[on, None] * d[on],
                           -g_f[on] / max_d[on])
        g_o[on] = g_o[on] + g_p
        g_d[on] = g_d[on] + t_s[on, None] * g_p
    return g_o, g_d


def ratio_track_vjp(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o, d, dist, lane_key,
                    salt: int, seed: int, g_tr):
    """M3 for CUDA tensors, ratio_track_vjp_plain for CPU ones: (g_o,
    g_d)."""
    if o.device.type == "cpu":
        return ratio_track_vjp_plain(grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o,
                                     d, dist, lane_key, salt, seed, g_tr)
    _check_inputs("ratio_track_vjp", grid, w2m, sigma_a, sigma_s, max_density, mid, in_med, o,
                  d, dist, lane_key)
    n = o.shape[0]
    _check("ratio_track_vjp", "g_tr", g_tr, torch.float32, (n,))
    g_o, g_d = torch.empty_like(o), torch.empty_like(d)
    with torch.cuda.device(o.device):
        err = _grad_kernel()(
            grid.data_ptr(), *grid.shape, w2m.data_ptr(), sigma_a.data_ptr(), sigma_s.data_ptr(),
            max_density.data_ptr(), mid.data_ptr(), in_med.data_ptr(), o.data_ptr(),
            d.data_ptr(), dist.data_ptr(), lane_key.data_ptr(), n, salt & rng.M32,
            seed & rng.M32, g_tr.data_ptr(), g_o.data_ptr(), g_d.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "ratio_track_vjp kernel launch")
    launches["ratio_track_grad"] += 1
    return g_o, g_d


class DeltaTrackFn(torch.autograd.Function):
    """M1 differentiable in t_max: forward go(o, d, t_max) (M1 on detached
    rays -> sampled, t, weight).  The backward is one select, so it has no
    kernel: t's gradient to t_max where min(t, t_max) takes t_max (half at
    a tie), nothing to o and d (see the module's docstring)."""

    @staticmethod
    def forward(ctx, o, d, t_max, go):
        sampled, t, weight = go(o.detach(), d.detach(), t_max.detach())
        ctx.save_for_backward(t_max.detach())
        ctx.mark_non_differentiable(sampled, weight)
        return sampled, t, weight

    @staticmethod
    def backward(ctx, _g_sampled, g_t, _g_weight):
        (t_max,) = ctx.saved_tensors
        g_t_max = None
        if ctx.needs_input_grad[2] and g_t is not None:
            # the loop's own t is 0 or a step below t_max: min takes t_max
            # only where t_max < 0, and ties with it at t_max == 0
            g_t_max = g_t * torch.where(t_max < 0.0, 1.0, torch.where(t_max == 0.0, 0.5, 0.0))
        return None, None, g_t_max, None


class RatioTrackFn(torch.autograd.Function):
    """M2 differentiable in o and d: forward M2 on detached rays, backward
    M3 (ratio_track_vjp)."""

    @staticmethod
    def forward(ctx, o, d, dist, tables, lane_key, salt, seed):
        o, d, dist = o.detach(), d.detach(), dist.detach()
        ctx.tables, ctx.salt, ctx.seed = tables, salt, seed
        ctx.save_for_backward(o, d, dist, lane_key)
        return _ratio_track(*tables, o, d, dist, lane_key, salt, seed)

    @staticmethod
    def backward(ctx, g_tr):
        o, d, dist, lane_key = ctx.saved_tensors
        g_o, g_d = ratio_track_vjp(*ctx.tables, o, d, dist, lane_key, ctx.salt, ctx.seed,
                                   g_tr.contiguous())
        return (g_o if ctx.needs_input_grad[0] else None,
                g_d if ctx.needs_input_grad[1] else None, None, None, None, None, None)
