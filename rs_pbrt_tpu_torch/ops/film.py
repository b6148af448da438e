"""Film accumulation and the pixel filters.

The port of the JAX package's ``ops/film.py`` (reference src/core/film.rs,
src/filters/*.rs), filters evaluated analytically per tap.  The render
driver lays its lanes out as ordered copies of the pixel grid, so with a
box filter of radius <= 0.5 every sample lands in its own pixel and the
film update is a reshape and a sum (``add_samples_grid``); every other
filter splats each sample over its F x F footprint (``add_samples``: R1,
``ops/splat_kernel.py``, on the card).  BDPT's light-tracing strategies and
MLT add unfiltered splats to a layer of their own (``add_splats``), which
``to_rgb`` adds to the resolved image scaled by ``splat_scale``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..utils import vecmath as vm
from .autodiff import refuse_grad, tracks

# filter tags of the JAX package's ops/film.py
FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_SINC = 4

DEFAULT_WIDTHS = {FILTER_BOX: 0.5, FILTER_TRIANGLE: 2.0, FILTER_GAUSSIAN: 2.0,
                  FILTER_MITCHELL: 2.0, FILTER_SINC: 4.0}


class FilterCfg(NamedTuple):
    """The JAX package's FilterCfg, field for field: FilterCfg(*jax_cfg)
    carries a JAX filter across."""

    kind: int
    xwidth: float  # radius in pixels
    ywidth: float
    alpha: float = 2.0  # gaussian
    b: float = 1.0 / 3.0  # mitchell
    c: float = 1.0 / 3.0
    tau: float = 3.0  # sinc (lanczos windowed)


def make_filter(kind=FILTER_BOX, xwidth=None, ywidth=None, alpha=2.0, b=1.0 / 3.0, c=1.0 / 3.0,
                tau=3.0) -> FilterCfg:
    """A filter with the kind's default radius where none (or 0) is given:
    the box 0.5, the sinc 4, the others 2 (filters/*.rs create)."""
    w = DEFAULT_WIDTHS[kind]
    return FilterCfg(kind, xwidth or w, ywidth or w, alpha, b, c, tau)


def filter_eval(cfg: FilterCfg, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The filter at offset (x, y) from the sample (filters/*.rs evaluate)."""
    ax, ay = x.abs(), y.abs()
    inside = (ax <= cfg.xwidth) & (ay <= cfg.ywidth)
    if cfg.kind == FILTER_BOX:
        # half-open support: a sample exactly on a pixel corner (Sobol's
        # first sample is (0,0)) belongs to its own pixel only, as the
        # JAX package keeps it (its ops/film.py:57-64)
        inside = (x > -cfg.xwidth) & (x <= cfg.xwidth) & (y > -cfg.ywidth) & (y <= cfg.ywidth)
        w = torch.ones_like(x)
    elif cfg.kind == FILTER_TRIANGLE:
        w = torch.clamp(cfg.xwidth - ax, min=0.0) * torch.clamp(cfg.ywidth - ay, min=0.0)
    elif cfg.kind == FILTER_GAUSSIAN:
        ex = torch.exp(-cfg.alpha * x * x) - np.exp(-cfg.alpha * cfg.xwidth ** 2)
        ey = torch.exp(-cfg.alpha * y * y) - np.exp(-cfg.alpha * cfg.ywidth ** 2)
        w = torch.clamp(ex, min=0.0) * torch.clamp(ey, min=0.0)
    elif cfg.kind == FILTER_MITCHELL:
        w = (_mitchell_1d(cfg, vm.true_div(x, cfg.xwidth))
             * _mitchell_1d(cfg, vm.true_div(y, cfg.ywidth)))
    else:  # FILTER_SINC
        w = _sinc_1d(cfg, vm.true_div(x, cfg.xwidth)) * _sinc_1d(cfg, vm.true_div(y, cfg.ywidth))
    return torch.where(inside, w, 0.0)


def _mitchell_1d(cfg: FilterCfg, x: torch.Tensor) -> torch.Tensor:
    x = (2.0 * x).abs()
    b, c = cfg.b, cfg.c
    x2 = x * x
    x3 = x * x2
    big = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x
           + (8 * b + 24 * c)) * (1.0 / 6.0)
    small = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) * (1.0 / 6.0)
    return torch.where(x > 1.0, torch.where(x < 2.0, big, 0.0), small)


def _sinc_1d(cfg: FilterCfg, x: torch.Tensor) -> torch.Tensor:
    x = x.abs()

    def s(v):
        pv = v * float(vm.PI)
        return torch.where(v < 1e-5, 1.0, torch.sin(pv) / pv)

    lanczos = s(x) * s(vm.true_div(x, cfg.tau))
    return torch.where(x > cfg.tau, 0.0, lanczos)


def footprint(cfg: FilterCfg) -> int:
    """Pixel taps per axis that cover the filter's support."""
    return int(np.floor(2.0 * max(cfg.xwidth, cfg.ywidth) + 0.9999)) + 1


@dataclass
class Film:
    rgb: torch.Tensor  # (H, W, 3) weighted sums
    weight: torch.Tensor  # (H, W)
    splat: torch.Tensor = None  # (H, W, 3) unfiltered splats (Film::add_splat film.rs:388)
    # whether add_splats wrote the splat layer; to_rgb adds it only then, so
    # a film without splats resolves to the same bits as before the layer
    splatted: bool = False


def make_film(resolution, device="cuda") -> Film:
    w, h = resolution
    dev = resolve(device)
    return Film(torch.zeros((h, w, 3), device=dev), torch.zeros((h, w), device=dev),
                torch.zeros((h, w, 3), device=dev))


def grid_filter(cfg: FilterCfg) -> bool:
    """Whether add_samples_grid takes the filter: a box of radius <= 0.5."""
    return cfg.kind == FILTER_BOX and cfg.xwidth <= 0.5 and cfg.ywidth <= 0.5


def add_samples(film: Film, cfg: FilterCfg, p_film: torch.Tensor, L: torch.Tensor) -> Film:
    """Splats N samples into the film in place (FilmTile::add_sample
    film.rs:94-147): p_film (N, 2) raster points, L (N, 3).  A sample at p
    adds to pixel px with weight f(px + 0.5 - p); taps outside the film
    (not the crop window) are dropped; NaN or infinite L counts as black,
    its weight still added (integrator.rs:165-193).  R1 on the card
    (``splat_kernel.splat``).  Where autograd records through L, the batch
    is splatted into a zero film through ``splat_kernel.SplatFn`` (R1, and
    R2 for its backward) and added to the film out of place."""
    from . import splat_kernel

    refuse_grad("add_samples in p_film (the filter's weights)", p_film)
    if tracks(L):
        h, w = film.weight.shape
        rgb, weight = splat_kernel.SplatFn.apply(L, p_film, cfg, h, w)
        film.rgb, film.weight = film.rgb + rgb, film.weight + weight
        return film
    splat_kernel.splat(film.rgb, film.weight, cfg, p_film, L)
    return film


def add_samples_grid(film: Film, cfg: FilterCfg, L: torch.Tensor, nb: int,
                     rect=None) -> Film:
    """Adds L, (nb*h*w, 3) radiance of nb ordered copies of the pixel grid
    (x fastest), to the film in place.  rect: the crop window (y0, h, x0, w)
    the grid covers (film.rs:185,224-262), else the whole film.  NaN or
    infinite samples count as black (integrator.rs:165-193).  Only for a
    box of radius <= 0.5 (``grid_filter``); ``add_samples`` takes the rest."""
    if not grid_filter(cfg):
        raise ValueError("add_samples_grid takes the box filter of radius <= 0.5 only; "
                         "use add_samples")
    fh, fw = film.weight.shape
    y0, h, x0, w = rect if rect is not None else (0, fh, 0, fw)
    bad = ~torch.isfinite(L).all(-1)
    L = torch.where(bad[:, None], 0.0, L)
    film.rgb[y0:y0 + h, x0:x0 + w] += L.reshape(nb, h, w, 3).sum(0)
    film.weight[y0:y0 + h, x0:x0 + w] += float(nb)
    return film


def add_splats(film: Film, p_film: torch.Tensor, L: torch.Tensor) -> Film:
    """Adds N unfiltered splats to the film's splat layer in place
    (Film::add_splat film.rs:388; the JAX ops/film.py:165-173): L (N, 3) to
    the pixel holding raster point p_film (N, 2).  A point outside the film
    (the crop window does not bound it), or an L with a NaN or infinite
    channel, adds nothing."""
    h, w = film.weight.shape
    px = torch.clamp(p_film[:, 0].to(torch.int32), 0, w - 1).long()
    py = torch.clamp(p_film[:, 1].to(torch.int32), 0, h - 1).long()
    inb = (p_film[:, 0] >= 0) & (p_film[:, 0] < w) & (p_film[:, 1] >= 0) & (p_film[:, 1] < h)
    good = torch.isfinite(L).all(-1) & inb
    # index_add_ adds with atomics on the card; index_put_'s accumulate
    # sorts the indices first, ~2.3 s for BDPT's 21M splats at 256x256
    # (chip_smoke.py phase 28, NVIDIA H100 80GB HBM3)
    film.splat.view(h * w, 3).index_add_(0, py * w + px, torch.where(good[:, None], L, 0.0))
    film.splatted = True
    return film


def to_rgb(film: Film, splat_scale: float = 1.0) -> torch.Tensor:
    """Resolve to linear RGB (film.rs:438-528): the filtered samples'
    weighted mean, plus splat_scale times the splat layer where add_splats
    wrote it."""
    w = torch.clamp(film.weight[..., None], min=0.0)
    img = torch.where(w > 0.0, film.rgb / torch.clamp(w, min=1e-12), 0.0)
    return img + splat_scale * film.splat if film.splatted else img
