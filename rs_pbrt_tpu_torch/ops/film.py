"""Film accumulation.

The port of the box-filter parts of the JAX package's ``ops/film.py``
(reference src/core/film.rs, src/filters/box.rs).  The render driver lays
its lanes out as ordered copies of the pixel grid, so with a box filter of
radius <= 0.5 every sample lands in its own pixel and the film update is a
reshape and a sum (``add_samples_grid``).  The other filters, which need the
scatter splat, are not ported yet (ROADMAP slice 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve

# filter tags of the JAX package's ops/film.py
FILTER_BOX = 0
FILTER_GAUSSIAN = 2


class FilterCfg(NamedTuple):
    kind: int
    xwidth: float  # radius in pixels
    ywidth: float


def make_filter(kind=FILTER_BOX, xwidth=0.5, ywidth=0.5) -> FilterCfg:
    """The box filter's default radius is half a pixel (filters/box.rs)."""
    return FilterCfg(kind, xwidth, ywidth)


@dataclass
class Film:
    rgb: torch.Tensor  # (H, W, 3) weighted sums
    weight: torch.Tensor  # (H, W)


def make_film(resolution, device="cuda") -> Film:
    w, h = resolution
    dev = resolve(device)
    return Film(torch.zeros((h, w, 3), device=dev), torch.zeros((h, w), device=dev))


def add_samples_grid(film: Film, cfg: FilterCfg, L: torch.Tensor, nb: int,
                     rect=None) -> Film:
    """Adds L, (nb*h*w, 3) radiance of nb ordered copies of the pixel grid
    (x fastest), to the film in place.  rect: the crop window (y0, h, x0, w)
    the grid covers (film.rs:185,224-262), else the whole film.  NaN or
    infinite samples count as black (integrator.rs:165-193)."""
    if not (cfg.kind == FILTER_BOX and cfg.xwidth <= 0.5 and cfg.ywidth <= 0.5):
        raise NotImplementedError("only the box filter of radius <= 0.5 is ported (ROADMAP slice 4)")
    fh, fw = film.weight.shape
    y0, h, x0, w = rect if rect is not None else (0, fh, 0, fw)
    bad = ~torch.isfinite(L).all(-1)
    L = torch.where(bad[:, None], 0.0, L)
    film.rgb[y0:y0 + h, x0:x0 + w] += L.reshape(nb, h, w, 3).sum(0)
    film.weight[y0:y0 + h, x0:x0 + w] += float(nb)
    return film


def to_rgb(film: Film) -> torch.Tensor:
    """Resolve to linear RGB (film.rs:438-528)."""
    w = torch.clamp(film.weight[..., None], min=0.0)
    return torch.where(w > 0.0, film.rgb / torch.clamp(w, min=1e-12), 0.0)
