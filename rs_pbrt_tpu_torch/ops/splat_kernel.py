"""R1: the filter splat, one launch a batch.

The port of the JAX package's ``add_samples`` (rs_pbrt_tpu/ops/film.py:117),
which the render driver takes for every filter but the half-pixel box.
``splat`` launches the CUDA kernel (``csrc/splat.cu``) for CUDA tensors and
runs ``splat_plain``, the same function in plain PyTorch (the JAX loop over
the F x F taps, op for op, each tap's two scatter-adds as
``index_put_(..., accumulate=True)``), for CPU tensors.  Both add into the
film's rgb and weight in place and return them.  The kernel adds with
atomics, in no fixed order, so its film is not bit-equal to the plain
version's; on the CPU the plain version adds in lane order, tap by tap, as
the JAX scatter does.

Where autograd records through L, the film update is ``SplatFn``: its
forward splats into a zero film with R1, its backward is ``splat_grad``
(R2, ``csrc/splat_grad.cu``, on CUDA tensors; ``splat_grad_plain`` on CPU
ones), the vector-Jacobian product in L: each lane gathers the upstream
gradient of its taps' pixels times their weights, the transpose of the
JAX scatter-add, deterministic and bit-equal to the plain version.  The
weights depend on p_film, which carries no gradient: a p_film that does
raises (ROADMAP A17c).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build
from . import film as fm

MAX_TAPS = 16  # csrc/splat.cuh kMaxTaps: a footprint of at most 16 (radius <= 7.5)
launches = 0  # kernel launches of `splat`; the plain path does not count
grad_launches = 0  # kernel launches of `splat_grad` (R2)


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("splat").rs_splat
    P, I = ctypes.c_void_p, ctypes.c_int
    # p_film, L, rgb, weight, n, w, h, taps, kind, consts, stream
    fn.argtypes = [P, P, P, P, I, I, I, I, I, P, P]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _grad_kernel():
    fn = _build.load("splat_grad").rs_splat_grad
    P, I = ctypes.c_void_p, ctypes.c_int
    # p_film, L, g_rgb, g_L, n, w, h, taps, kind, consts, stream
    fn.argtypes = [P, P, P, P, I, I, I, I, I, P, P]
    fn.restype = ctypes.c_int
    return fn


def filter_consts(cfg: fm.FilterCfg) -> np.ndarray:
    """The kernel's constants (csrc/splat.cuh's order), each rounded to f32
    from the Python double the JAX expression computes: the widths, the
    first tap's offsets (width - 0.5), the Gaussian's -alpha and its two
    exp(-alpha width^2), Mitchell's seven coefficients and 1/6, sinc's tau."""
    b, c = cfg.b, cfg.c
    return np.asarray([
        cfg.xwidth, cfg.ywidth, cfg.xwidth - 0.5, cfg.ywidth - 0.5, -cfg.alpha,
        np.exp(-cfg.alpha * cfg.xwidth ** 2), np.exp(-cfg.alpha * cfg.ywidth ** 2),
        -b - 6 * c, 6 * b + 30 * c, -12 * b - 48 * c, 8 * b + 24 * c,
        12 - 9 * b - 6 * c, -18 + 12 * b + 6 * c, 6 - 2 * b, 1.0 / 6.0, cfg.tau,
    ], np.float64).astype(np.float32)


def _check_args(rgb: torch.Tensor, weight: torch.Tensor, cfg: fm.FilterCfg,
                p_film: torch.Tensor, L: torch.Tensor):
    """Raises on what the kernel does not take, on any device."""
    n = p_film.shape[0] if p_film.dim() == 2 else -1
    if p_film.dtype != torch.float32 or p_film.shape != (n, 2) or not p_film.is_contiguous():
        raise ValueError("splat: p_film must be a contiguous (N, 2) float32 tensor")
    if L.dtype != torch.float32 or L.shape != (n, 3) or not L.is_contiguous():
        raise ValueError("splat: L must be a contiguous (N, 3) float32 tensor beside p_film")
    if weight.dim() != 2 or rgb.shape != weight.shape + (3,) or not (
            rgb.is_contiguous() and weight.is_contiguous()) or rgb.dtype != torch.float32 or \
            weight.dtype != torch.float32:
        raise ValueError("splat: the film's rgb (H, W, 3) and weight (H, W) must be contiguous "
                         "float32 tensors")
    if len({t.device for t in (rgb, weight, p_film, L)}) != 1:
        raise ValueError("splat: the film and the samples must lie on one device")
    if cfg.kind not in fm.DEFAULT_WIDTHS or not (cfg.xwidth > 0.0 and cfg.ywidth > 0.0):
        raise ValueError(f"splat: bad filter {cfg}")
    if fm.footprint(cfg) > MAX_TAPS:
        raise ValueError(f"splat: footprint {fm.footprint(cfg)} above {MAX_TAPS} taps "
                         f"(radius above 7.5)")
    if n >= 1 << 31:
        raise ValueError("splat: at most 2^31 - 1 samples per launch")


def taps(cfg: fm.FilterCfg, p_film: torch.Tensor, h: int, w: int):
    """The F x F taps of N lanes, dy major, as the JAX loop forms them:
    for each, the flat pixel index (N,) (clamped into the film) and the
    weight (N,), filter_eval at (px + 0.5 - p_film) from base =
    floor(p_film - 0.5 - (width - 0.5)), 0 outside the film."""
    base = torch.floor(p_film - 0.5 - p_film.new_tensor([cfg.xwidth - 0.5, cfg.ywidth - 0.5])).to(
        torch.int32)
    F = fm.footprint(cfg)
    for dy in range(F):
        for dx in range(F):
            px = base[:, 0] + dx
            py = base[:, 1] + dy
            wgt = fm.filter_eval(cfg, px.to(torch.float32) + 0.5 - p_film[:, 0],
                                 py.to(torch.float32) + 0.5 - p_film[:, 1])
            inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            idx = (torch.clamp(py, 0, h - 1).long() * w + torch.clamp(px, 0, w - 1).long())
            yield idx, torch.where(inb, wgt, 0.0)


def splat_plain(rgb: torch.Tensor, weight: torch.Tensor, cfg: fm.FilterCfg,
                p_film: torch.Tensor, L: torch.Tensor, work: dict = None):
    """The JAX add_samples in plain PyTorch, into rgb and weight in place:
    each lane's taps (``taps``) scatter-added; NaN or infinite L counts as
    black.  work, when given, gains "taps": the taps inside the film with
    a nonzero weight (the kernel's atomic adds / 4).  Returns (rgb,
    weight)."""
    h, w = weight.shape
    bad = ~torch.isfinite(L).all(-1)
    L = torch.where(bad[:, None], 0.0, L)
    rgb_flat, w_flat = rgb.view(-1, 3), weight.view(-1)
    n_taps = 0
    for idx, wgt in taps(cfg, p_film, h, w):
        rgb_flat.index_put_((idx,), wgt[:, None] * L, accumulate=True)
        w_flat.index_put_((idx,), wgt, accumulate=True)
        if work is not None:
            n_taps += int((wgt != 0.0).sum())
    if work is not None:
        work["taps"] = work.get("taps", 0) + n_taps
    return rgb, weight


def splat(rgb: torch.Tensor, weight: torch.Tensor, cfg: fm.FilterCfg, p_film: torch.Tensor,
          L: torch.Tensor):
    """Adds N samples (p_film (N, 2), L (N, 3)) to the film (rgb (H, W, 3),
    weight (H, W)) in place through filter cfg: the kernel for CUDA
    tensors, the plain version for CPU ones.  Returns (rgb, weight)."""
    _check_args(rgb, weight, cfg, p_film, L)
    if p_film.device.type == "cpu":
        return splat_plain(rgb, weight, cfg, p_film, L)
    global launches
    if p_film.device.type != "cuda":
        raise ValueError(f"splat: the samples lie on {p_film.device}")
    h, w = weight.shape
    consts = filter_consts(cfg)
    with torch.cuda.device(p_film.device):
        err = _kernel()(p_film.data_ptr(), L.data_ptr(), rgb.data_ptr(), weight.data_ptr(),
                        p_film.shape[0], w, h, fm.footprint(cfg), int(cfg.kind),
                        consts.ctypes.data, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "splat kernel launch")
    launches += 1
    return rgb, weight


def splat_grad_plain(cfg: fm.FilterCfg, p_film: torch.Tensor, L: torch.Tensor,
                     g_rgb: torch.Tensor) -> torch.Tensor:
    """R2's plain version: grad_L (N, 3) = each lane's taps' weights times
    g_rgb (H, W, 3) at their pixels, summed tap by tap in ``taps``' order;
    0 where L is NaN or infinite (counted as black)."""
    h, w = g_rgb.shape[:2]
    g_flat = g_rgb.reshape(-1, 3)
    acc = torch.zeros_like(L)
    for idx, wgt in taps(cfg, p_film, h, w):
        acc = acc + wgt[:, None] * g_flat[idx]
    return torch.where(torch.isfinite(L).all(-1)[:, None], acc, 0.0)


def splat_grad(cfg: fm.FilterCfg, p_film: torch.Tensor, L: torch.Tensor,
               g_rgb: torch.Tensor) -> torch.Tensor:
    """R2 for CUDA tensors, splat_grad_plain for CPU ones: the gradient in
    L (N, 3) of a splat of (p_film, L) through cfg, given the film rgb's
    upstream gradient g_rgb (H, W, 3)."""
    h, w = g_rgb.shape[:2]
    g_rgb = g_rgb.contiguous()
    _check_args(g_rgb, g_rgb[..., 0].contiguous(), cfg, p_film, L)
    if p_film.device.type == "cpu":
        return splat_grad_plain(cfg, p_film, L, g_rgb)
    global grad_launches
    g_L = torch.empty_like(L)
    consts = filter_consts(cfg)
    with torch.cuda.device(p_film.device):
        err = _grad_kernel()(p_film.data_ptr(), L.data_ptr(), g_rgb.data_ptr(), g_L.data_ptr(),
                             p_film.shape[0], w, h, fm.footprint(cfg), int(cfg.kind),
                             consts.ctypes.data, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "splat_grad kernel launch")
    grad_launches += 1
    return g_L


class SplatFn(torch.autograd.Function):
    """(rgb (H, W, 3), weight (H, W)) of N samples splatted into a zero film
    of size (h, w) through cfg, differentiable in L: forward R1 (splat),
    backward R2 (splat_grad)."""

    @staticmethod
    def forward(ctx, L, p_film, cfg, h, w):
        L = L.detach().contiguous()
        rgb = torch.zeros((h, w, 3), dtype=torch.float32, device=L.device)
        weight = torch.zeros((h, w), dtype=torch.float32, device=L.device)
        splat(rgb, weight, cfg, p_film, L)
        ctx.cfg = cfg
        ctx.save_for_backward(p_film, L)
        ctx.mark_non_differentiable(weight)
        return rgb, weight

    @staticmethod
    def backward(ctx, g_rgb, _g_weight):
        p_film, L = ctx.saved_tensors
        return splat_grad(ctx.cfg, p_film, L, g_rgb), None, None, None, None
